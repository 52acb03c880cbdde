"""K1: the windowed segment-aggregate kernel and its host wrapper.

The port of cnosdb_tpu/ops/pallas_kernels.py (the module keeps its name
so the copied host layers find it). The JAX package's Pallas kernel
exploited the STORAGE LAYOUT: scan batches are series-contiguous and
time-ordered, so the `group × n_buckets + bucket` segment ids of each
256-row tile span a narrow contiguous window. Here the same layout feeds
a hand-written CUDA kernel (csrc/segment_window.cu) with two levels: a
block reduces a run of up to TILES_PER_RUN tiles into per-warp windows in
shared memory, and a warp of the block that completes a segment folds
that segment's block partials in a fixed order, all in one launch — no
dense window, no float atomics.

`window_layout` is the host half: the per-tile window bases (what
`applicable` returned in the JAX package, None when a tile's span
disqualifies the layout), the block runs (first tile, lowest segment id,
first partial slot), and each partial slot's place in (segment, run)
order, which lays every segment's partials out contiguously in run order
for the fold. `window_partials` runs the kernel on a CUDA tensor and its
plain PyTorch version (`window_partials_plain`, the same two passes as
scatter reductions) on a CPU tensor.

Staging: one call packs everything the kernel reads that is not already
on the card (rows, layout, zeroed arrival counters) into one page-locked
buffer (`stage_plan` gives the byte offsets) and makes ONE host-to-device
copy; `segment_partials_pallas` then makes ONE device-to-host copy of the
packed count/sum/min/max and synchronizes once. The executor calls it
from up to eight threads at once on one stream, each query on a fresh
thread pool, so the pinned buffers live in staging slots that a call
takes for itself and gives back (a free list, not thread-local storage),
and a slot's staging buffer is refilled only after the copy that read it
has finished (an event). On a CPU scan device the same packing
runs into a numpy buffer and the plain version reads its inputs back out
of it.

Routing (kernels.aggregate_column_host): `enabled()` reads
CNOSDB_TPU_PALLAS — "1" forces the route on (the plain version on a CPU
scan device), "0" off, unset/auto enables it when the scan device is a
CUDA card. A tile span ≥ W_WIN or a first/last request declines to the
scatter kernels (X1), as in the JAX package, and every decline is
counted; a kernel that cannot build or launch raises.
"""
from __future__ import annotations

import ctypes
import functools
import os
import struct
import threading
from dataclasses import dataclass

import numpy as np
import torch

R_TILE = 256     # rows per tile (one warp of a CUDA block)
W_WIN = 2048     # widest segment span a tile, or a block run, may cover
TILES_PER_RUN = 64   # tiles a block run takes at most (one CUDA block)

_lock = threading.Lock()
_engagements = 0
launches = 0     # CUDA launches of K1 (the plain version is not counted)
launch_shapes: dict[tuple, int] = {}   # (rows, segments, dtype) → launches
_declines: dict[str, int] = {}


def enabled() -> bool:
    """Should aggregate_column_host route through this kernel?"""
    return disabled_reason() is None


def disabled_reason() -> str | None:
    """None when the route is on, else WHY it is not."""
    mode = os.environ.get("CNOSDB_TPU_PALLAS", "auto").lower()
    if mode in ("1", "on", "true"):
        return None
    if mode in ("0", "off", "false"):
        return f"disabled by env CNOSDB_TPU_PALLAS={mode}"
    from .placement import scan_device

    dev = scan_device()
    if dev.type != "cuda":
        return f"scan device is {dev.type!r}, not cuda (auto mode)"
    return None


def note_engaged() -> None:
    global _engagements
    with _lock:
        _engagements += 1
    from ..utils import stages

    stages.count("pallas_engagements")


def engagements() -> int:
    """How many aggregations ran through K1 this process (the plain
    version on a CPU scan device included)."""
    with _lock:
        return _engagements


def _decline(reason: str) -> None:
    with _lock:
        _declines[reason] = _declines.get(reason, 0) + 1


def declines() -> dict[str, int]:
    """Layout declines to the scatter kernels, by reason."""
    with _lock:
        return dict(_declines)


@dataclass
class WindowLayout:
    """Host-computed layout of one K1 call (all numpy): the tiles' bases
    and the block runs. Run r covers tiles [run_tile[r], run_tile[r + 1])
    and segments [run_base[r], run_base[r] + its span), its partial slots
    from slot_off[r]."""

    bases: np.ndarray | None  # [tiles] i32: the tile's lowest segment id
                              # (not staged: the kernel reads runs)
    run_tile: np.ndarray   # [runs + 1] i32: a run's first tile
    run_base: np.ndarray   # [runs] i32: a run's lowest segment id
    slot_off: np.ndarray   # [runs + 1] i64: first partial slot of a run
    fold_pos: np.ndarray   # [slots] i32: a slot's place in (segment,
                           # run) order
    seg_start: np.ndarray  # [num_segments + 1] i64: a segment's partials
                           # in that order; its length is the arrival
                           # target

    @property
    def n_slots(self) -> int:
        return int(self.slot_off[-1])

    @property
    def n_runs(self) -> int:
        return len(self.run_base)

    @functools.cached_property
    def span_max(self) -> int:
        """The widest run: the window a block keeps per warp."""
        return int(np.diff(self.slot_off).max())


def _tile_bounds(seg_ids: np.ndarray):
    starts = np.arange(0, len(seg_ids), R_TILE)
    return (np.minimum.reduceat(seg_ids, starts).astype(np.int64),
            np.maximum.reduceat(seg_ids, starts).astype(np.int64))


def _block_runs(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """First tile of each block run, and the tile count last: a run takes
    the next tile while it has fewer than TILES_PER_RUN tiles and its union
    span of segment ids stays within W_WIN."""
    tiles = len(lo)
    starts = np.arange(0, tiles, TILES_PER_RUN)
    if int((np.maximum.reduceat(hi, starts)
            - np.minimum.reduceat(lo, starts)).max()) < W_WIN:
        return np.append(starts, tiles).astype(np.int32)
    first = [0]
    r_lo, r_hi, count = int(lo[0]), int(hi[0]), 1
    for t in range(1, tiles):
        u_lo, u_hi = min(r_lo, int(lo[t])), max(r_hi, int(hi[t]))
        if count < TILES_PER_RUN and u_hi - u_lo < W_WIN:
            r_lo, r_hi, count = u_lo, u_hi, count + 1
        else:
            first.append(t)
            r_lo, r_hi, count = int(lo[t]), int(hi[t]), 1
    first.append(tiles)
    return np.asarray(first, dtype=np.int32)


def window_layout(seg_ids: np.ndarray, num_segments: int
                  ) -> WindowLayout | None:
    """→ the K1 layout, or None when a tile spans W_WIN or more segments
    (or there are no rows). Raises on segment ids outside
    [0, num_segments)."""
    if len(seg_ids) == 0:
        return None
    lo, hi = _tile_bounds(np.asarray(seg_ids))
    if int((hi - lo).max()) >= W_WIN:
        return None
    if int(lo.min()) < 0 or int(hi.max()) >= num_segments:
        raise ValueError(
            f"segment ids outside [0, {num_segments}): "
            f"{int(lo.min())}..{int(hi.max())}")
    run_tile = _block_runs(lo, hi)
    starts = run_tile[:-1]
    r_lo = np.minimum.reduceat(lo, starts)
    spans = np.maximum.reduceat(hi, starts) - r_lo + 1
    slot_off = np.zeros(len(spans) + 1, dtype=np.int64)
    np.cumsum(spans, out=slot_off[1:])
    total = int(slot_off[-1])
    gid = np.arange(total, dtype=np.int64) + np.repeat(r_lo - slot_off[:-1],
                                                       spans)
    # stable: a segment's partials keep run order, so the fold is fixed
    order = np.argsort(gid, kind="stable")
    fold_pos = np.empty(total, dtype=np.int32)
    fold_pos[order] = np.arange(total, dtype=np.int32)
    seg_start = np.zeros(num_segments + 1, dtype=np.int64)
    np.cumsum(np.bincount(gid, minlength=num_segments), out=seg_start[1:])
    return WindowLayout(lo.astype(np.int32), run_tile,
                        r_lo.astype(np.int32), slot_off, fold_pos, seg_start)


def _identity(dt: torch.dtype, mode: str):
    if dt.is_floating_point:
        return float("inf") if mode == "amin" else float("-inf")
    info = torch.iinfo(dt)
    return info.max if mode == "amin" else info.min


def _extreme(vals, idx, size: int, mode: str):
    """Scatter min ("amin") or max ("amax") of `vals` by `idx` into `size`
    slots, starting from the dtype identity; NaN propagates (scatter_reduce
    does so on CPU and CUDA)."""
    return torch.full((size,), _identity(vals.dtype, mode), dtype=vals.dtype,
                      device=vals.device).scatter_reduce_(0, idx, vals, mode)


def window_partials_plain(values, valid, seg_ids, layout: WindowLayout,
                          num_segments: int) -> dict:
    """Plain PyTorch version of K1 (same inputs, same two passes):
    pass 1 reduces each block run's valid rows into its partial slots,
    pass 2 folds every segment's slots in layout order."""
    dev, dt = values.device, values.dtype
    ok = valid.to(torch.bool)
    tiles_per_run = torch.from_numpy(
        np.diff(layout.run_tile).astype(np.int64)).to(dev)
    run_of_tile = torch.repeat_interleave(
        torch.arange(len(layout.run_base), device=dev), tiles_per_run,
        output_size=int(layout.run_tile[-1]))
    run = run_of_tile[torch.arange(values.shape[0], device=dev) // R_TILE]
    run_base = torch.from_numpy(layout.run_base).to(dev).to(torch.int64)
    slot_off = torch.from_numpy(layout.slot_off).to(dev)
    slot = slot_off[run] + seg_ids.to(torch.int64) - run_base[run]
    slots = layout.n_slots

    def masked(mode):
        return torch.where(ok, values, torch.full(
            (), _identity(dt, mode), dtype=dt, device=dev))

    p_cnt = torch.zeros(slots, dtype=torch.int32, device=dev).index_add_(
        0, slot, ok.to(torch.int32))
    p_sum = torch.zeros(slots, dtype=dt, device=dev).index_add_(
        0, slot, torch.where(ok, values, torch.zeros((), dtype=dt,
                                                     device=dev)))
    p_min = _extreme(masked("amin"), slot, slots, "amin")
    p_max = _extreme(masked("amax"), slot, slots, "amax")
    order = torch.empty(slots, dtype=torch.int64, device=dev)
    order[torch.from_numpy(layout.fold_pos).to(dev).to(torch.int64)] = \
        torch.arange(slots, device=dev)
    seg_of = torch.repeat_interleave(
        torch.arange(num_segments, device=dev),
        torch.from_numpy(np.diff(layout.seg_start)).to(dev))
    return {
        "count": torch.zeros(num_segments, dtype=torch.int32,
                             device=dev).index_add_(0, seg_of, p_cnt[order]),
        "sum": torch.zeros(num_segments, dtype=dt, device=dev).index_add_(
            0, seg_of, p_sum[order]),
        "min": _extreme(p_min[order], seg_of, num_segments, "amin"),
        "max": _extreme(p_max[order], seg_of, num_segments, "amax"),
    }


def _check_args(values, valid, seg_ids):
    n = values.shape[0]
    if values.dtype not in (torch.float64, torch.int64):
        raise TypeError(
            f"K1 takes float64 or int64 values, not {values.dtype}")
    if valid.dtype != torch.int8 or seg_ids.dtype != torch.int32:
        raise TypeError("K1 takes int8 valid and int32 segment ids")
    for t in (values, valid, seg_ids):
        if t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError("K1 takes contiguous [N] vectors of one length")
        if t.device != values.device:
            raise ValueError("K1 inputs must share one device")


@dataclass
class StagePlan:
    """Byte layout of one K1 call's device buffer: the staged inputs
    first (`in_bytes`, what the one host-to-device copy carries), then
    the block partials (device only), then the results [out_lo, out_hi)
    (what the one device-to-host copy carries). Each region is 16-byte
    aligned: name → (offset, element count, numpy dtype). `span_max` is
    the widest run, which sizes the kernel's shared-memory windows."""

    n_rows: int
    span_max: int
    regions: dict
    in_bytes: int
    out_lo: int
    out_hi: int

    @property
    def total(self) -> int:
        return self.out_hi

    @functools.cached_property
    def offsets(self):
        """The kernel's 17 pointer regions' byte offsets, in its argument
        order, as the int64 array the one-call C entry takes."""
        return (ctypes.c_int64 * len(_KERNEL_REGIONS))(
            *(self.regions.get(k, (0,))[0] for k in _KERNEL_REGIONS))


_ALIGN = 16
_OUTS = ("count", "sum", "min", "max")
_KERNEL_REGIONS = ("values", "valid", "seg_ids", "run_tile", "run_base",
                   "slot_off", "fold_pos", "seg_start", "arrivals", "p_cnt",
                   "p_sum", "p_min", "p_max", *_OUTS)
_LAYOUT_REGIONS = ("run_tile", "run_base", "slot_off", "fold_pos",
                   "seg_start")


def stage_plan(n: int, layout: WindowLayout, num_segments: int,
               dtype: np.dtype, rows: bool) -> StagePlan:
    """Where each array of one K1 call lives in its buffers; `rows`
    stages values, segment ids and valid flags too (else they are device
    tensors already)."""
    return _plan(n, layout.n_runs, layout.n_slots, layout.span_max,
                 num_segments, np.dtype(dtype), rows)


@functools.lru_cache(maxsize=256)
def _plan(n: int, runs: int, slots: int, span_max: int, ns: int,
          dt: np.dtype, rows: bool) -> StagePlan:
    i32, i64, i8 = np.dtype(np.int32), np.dtype(np.int64), np.dtype(np.int8)
    parts = ([("values", n, dt), ("seg_ids", n, i32), ("valid", n, i8)]
             if rows else [])
    parts += [("run_tile", runs + 1, i32), ("run_base", runs, i32),
              ("slot_off", runs + 1, i64), ("fold_pos", slots, i32),
              ("seg_start", ns + 1, i64), ("arrivals", ns, i32)]
    n_in = len(parts)
    parts += [("p_cnt", slots, i32), ("p_sum", slots, dt),
              ("p_min", slots, dt), ("p_max", slots, dt)]
    n_scratch = len(parts)
    parts += [("count", ns, i32), ("sum", ns, dt), ("min", ns, dt),
              ("max", ns, dt)]
    regions, off, marks = {}, 0, []
    for i, (name, count, d) in enumerate(parts):
        if i in (n_in, n_scratch):
            marks.append(off)
        regions[name] = (off, count, d)
        off += -(-count * d.itemsize // _ALIGN) * _ALIGN
    return StagePlan(n, span_max, regions, in_bytes=marks[0],
                     out_lo=marks[1], out_hi=off)


def region(buf, plan: StagePlan, name: str):
    """The `name` array inside a staging or device buffer (a numpy
    uint8 array or a torch uint8 tensor), as a view of its dtype."""
    off, count, d = plan.regions[name]
    raw = buf[off:off + count * d.itemsize]
    if isinstance(raw, np.ndarray):
        return raw.view(d)
    return raw.view(_TORCH_OF[d.char])


_TORCH_OF = {"i": torch.int32, "l": torch.int64, "q": torch.int64,
             "b": torch.int8, "d": torch.float64}


def pack(buf: np.ndarray, plan: StagePlan, layout: WindowLayout,
         rows: tuple | None = None) -> None:
    """Fill the input regions of a uint8 staging buffer: the rows
    (values, valid, seg_ids) where the plan stages them, the layout, and
    zeroed arrival counters."""
    if rows is not None:
        values, valid, seg_ids = rows
        np.copyto(region(buf, plan, "values"), values)
        np.copyto(region(buf, plan, "seg_ids"), seg_ids, casting="same_kind")
        np.copyto(region(buf, plan, "valid"), valid, casting="unsafe")
    for k in _LAYOUT_REGIONS:
        np.copyto(region(buf, plan, k), getattr(layout, k))
    region(buf, plan, "arrivals")[:] = 0


def staged_layout(buf, plan: StagePlan) -> WindowLayout:
    """The layout as it sits in a packed numpy buffer (views; the tile
    bases are not staged)."""
    return WindowLayout(None, *(region(buf, plan, k)
                                for k in _LAYOUT_REGIONS))


def window_partials(values, valid, seg_ids, layout: WindowLayout,
                    num_segments: int) -> dict:
    """K1: final [num_segments] count (i32) / sum / min / max of the valid
    rows. values [N] f64 or i64, valid [N] int8, seg_ids [N] i32. A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel,
    staging the layout with one host-to-device copy."""
    _check_args(values, valid, seg_ids)
    if int(layout.run_tile[-1]) != -(-values.shape[0] // R_TILE) \
            or len(layout.seg_start) != num_segments + 1:
        raise ValueError("layout does not match the rows or segments")
    if values.device.type == "cpu":
        return window_partials_plain(values, valid, seg_ids, layout,
                                     num_segments)
    if values.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda or cpu, not {values.device}")
    return _on_card_rows(values, valid, seg_ids, layout, num_segments)[1]


def _on_card_rows(values, valid, seg_ids, layout: WindowLayout,
                  num_segments: int) -> tuple:
    """K1 over rows already on the card: one C call stages the layout
    (one copy) and launches. → (device buffer, results as its views)."""
    plan = stage_plan(values.shape[0], layout, num_segments,
                      _NP_OF[values.dtype], rows=False)
    rows = (ctypes.c_void_p * 3)(values.data_ptr(), valid.data_ptr(),
                                 seg_ids.data_ptr())
    return _run_staged(values.device, plan, values.dtype == torch.float64,
                       lambda stage: pack(stage, plan, layout), rows,
                       fetch=False)


def prepare(values, valid, seg_ids, layout: WindowLayout,
            num_segments: int):
    """Run K1 once over rows already on the card → a function that
    launches the kernel alone again over the same staged buffers and
    returns the results (views of its device buffer). The kernel leaves
    its arrival counters at zero, so it may be called again."""
    _check_args(values, valid, seg_ids)
    buf, out = _on_card_rows(values, valid, seg_ids, layout, num_segments)
    plan = stage_plan(values.shape[0], layout, num_segments,
                      _NP_OF[values.dtype], rows=False)
    args = _bind(buf, plan, values.data_ptr(), valid.data_ptr(),
                 seg_ids.data_ptr())

    def launch() -> dict:
        _launch(values.device, values.dtype, args)
        return out

    return launch


_NP_OF = {torch.float64: np.float64, torch.int64: np.int64}


class _Slot:
    """One call's staging set: a page-locked input buffer, a page-locked
    result buffer, a device buffer and an event recorded behind the last
    copy that read the input buffer. A call owns its slot alone; slots
    outlive the executor's short-lived threads, so their pinned memory is
    allocated once, not once per thread."""

    __slots__ = ("stage", "stage_np", "results", "results_np", "scratch",
                 "done", "pending")

    def __init__(self):
        self.stage = self.results = self.scratch = None
        self.done = torch.cuda.Event()
        self.pending = False   # a copy out of `stage` may still run

    @staticmethod
    def _size(buf, nbytes: int) -> int:
        """0 when `buf` holds nbytes, else the byte size to grow it to."""
        if buf is not None and buf.numel() >= nbytes:
            return 0
        return 1 << max(16, (max(nbytes, 1) - 1).bit_length())

    def _grow_pinned(self, buf, nbytes: int):
        """`buf`, or a larger page-locked host buffer."""
        size = self._size(buf, nbytes)
        if not size:
            return buf
        return torch.empty(size, dtype=torch.uint8, pin_memory=True)

    def staging(self, nbytes: int):
        """The input buffer (numpy view), ≥ nbytes, once the last copy
        out of it has finished."""
        if self.pending:
            self.done.synchronize()  # lint: disable=host-sync (waits for the last copy out of this pinned buffer before refilling it; no data crosses)
            self.pending = False
        grown = self._grow_pinned(self.stage, nbytes)
        if grown is not self.stage:
            self.stage, self.stage_np = grown, grown.numpy()
        return self.stage_np

    def result_buffer(self, nbytes: int):
        grown = self._grow_pinned(self.results, nbytes)
        if grown is not self.results:
            self.results, self.results_np = grown, grown.numpy()
        return self.results_np

    def device_buffer(self, nbytes: int, dev) -> torch.Tensor:
        if self.scratch is not None and self.scratch.device != dev:
            self.scratch = None
        size = self._size(self.scratch, nbytes)
        if size:
            self.scratch = torch.empty(size, dtype=torch.uint8, device=dev)
        return self.scratch


_free_slots: list[_Slot] = []


def _take_slot() -> _Slot:
    with _lock:
        return _free_slots.pop() if _free_slots else _Slot()


def _give_slot(slot: _Slot) -> None:
    with _lock:
        _free_slots.append(slot)


def _run_staged(dev, plan: StagePlan, f64: bool, fill, rows, fetch: bool):
    """One K1 call through a staging slot: `fill` packs the slot's
    pinned input buffer, then one C call enqueues the host-to-device copy,
    the launch and, when `fetch`, the device-to-host copy of the results
    into the slot's pinned result buffer, and records the slot's event.
    `rows` are the rows' device addresses, or None when they are staged.
    → the results as numpy arrays after one wait (fetch), else (device
    buffer, results as its views) with no wait: the slot's next user
    waits before it refills the input buffer."""
    global launches
    from . import cuda_build

    lib = cuda_build.library("segment_window")
    fn = lib.segment_window_call_f64 if f64 else lib.segment_window_call_i64
    n_out = plan.out_hi - plan.out_lo
    slot = _take_slot()
    try:
        fill(slot.staging(plan.in_bytes))
        if fetch:
            host_np = slot.result_buffer(n_out)
            buf = slot.device_buffer(plan.total, dev)
        else:
            buf = torch.empty(plan.total, dtype=torch.uint8, device=dev)
        if not slot.done.cuda_event:
            slot.done.record()   # gives the event its handle
        rc = fn(slot.stage.data_ptr(), buf.data_ptr(), plan.in_bytes,
                slot.results.data_ptr() if fetch else None, plan.out_lo,
                n_out if fetch else 0, plan.offsets, rows, plan.n_rows,
                plan.regions["run_base"][1], plan.regions["count"][1],
                plan.span_max, slot.done.cuda_event,
                cuda_build.current_stream(dev))
        cuda_build.check(lib, rc, "segment_window (K1)")
        shape = (plan.n_rows, plan.regions["count"][1],
                 "torch.float64" if f64 else "torch.int64")
        with _lock:
            launches += 1
            launch_shapes[shape] = launch_shapes.get(shape, 0) + 1
        if not fetch:
            slot.pending = True
            return buf, {k: region(buf, plan, k) for k in _OUTS}
        slot.done.synchronize()  # lint: disable=host-sync (audited transfer point: K1's one wait for its packed results in pinned memory)
        out = {}
        for k in _OUTS:
            off, count, d = plan.regions[k]
            lo = off - plan.out_lo
            out[k] = host_np[lo:lo + count * d.itemsize].view(d).copy()
        return out
    finally:
        _give_slot(slot)


def _bind(buf: torch.Tensor, plan: StagePlan, values: int, valid: int,
          seg_ids: int) -> tuple:
    """The arguments of one K1 launch over a staged device buffer, but
    the stream: the rows' device addresses are given, the layout's,
    scratch's and results' are the buffer's regions."""
    base = buf.data_ptr()
    at = [base + plan.regions[k][0] for k in _KERNEL_REGIONS[3:]]
    vec = values % 16 == 0 and seg_ids % 16 == 0 and valid % 8 == 0
    return (values, valid, seg_ids, *at, plan.n_rows,
            plan.regions["run_base"][1], plan.regions["count"][1],
            plan.span_max, int(vec))


def _launch(dev, dtype: torch.dtype, args: tuple) -> None:
    """One K1 launch on the current stream (raises on a CUDA error)."""
    global launches
    from . import cuda_build

    lib = cuda_build.library("segment_window")
    fn = (lib.segment_window_f64 if dtype == torch.float64
          else lib.segment_window_i64)
    rc = fn(*args, cuda_build.current_stream(dev))
    cuda_build.check(lib, rc, "segment_window (K1)")
    shape = (args[17], args[19], str(dtype))
    with _lock:
        launches += 1
        launch_shapes[shape] = launch_shapes.get(shape, 0) + 1


_WANT_OF = {"count": "want_count", "sum": "want_sum",
            "min": "want_min", "max": "want_max"}


def segment_partials_pallas(values: np.ndarray, valid: np.ndarray,
                            seg_ids: np.ndarray, num_segments: int,
                            wants: dict | None = None) -> dict | None:
    """Host wrapper: lay the batch out, run K1 on the scan device, pull the
    [num_segments] results back. Returns None — counted by reason — when
    `wants` asks for first/last (rank selection stays on the scatter
    kernels) or a tile's segment span disqualifies the layout. Output
    follows the scatter kernels' conventions: empty segments carry count
    0, sum 0 and dtype-extrema min/max; `wants` (same keys as
    local_segment_partials) subsets the returned aggregates. On a card
    the call makes one host-to-device copy, one launch and one
    device-to-host copy, and synchronizes once."""
    if wants and (wants.get("want_first") or wants.get("want_last")):
        _decline("first_last")
        return None
    seg_ids = np.asarray(seg_ids)
    values = np.asarray(values)
    valid = np.asarray(valid)
    if not values.ndim == valid.ndim == seg_ids.ndim == 1 \
            or not len(values) == len(valid) == len(seg_ids):
        raise ValueError("K1 takes [N] values, valid and segment ids")
    from .placement import scan_device

    dev = scan_device()
    if len(seg_ids) and dev.type == "cuda":
        host = _run_card(dev, values, valid, seg_ids, num_segments)
    elif dev.type in ("cpu", "cuda"):
        host = _run_plain(values, valid, seg_ids, num_segments)
    else:
        raise ValueError(f"K1 runs on cuda or cpu, not {dev}")
    if host is None:
        _decline("wide_span" if len(seg_ids) else "empty")
        return None
    if wants is not None:
        host = {k: v for k, v in host.items() if wants.get(_WANT_OF[k])}
    return host


def _check_values(values: np.ndarray) -> None:
    if values.dtype not in (np.float64, np.int64):
        raise TypeError(f"K1 takes float64 or int64 values, not "
                        f"{values.dtype}")


def _run_plain(values, valid, seg_ids, num_segments: int) -> dict | None:
    """The CPU route: the layout, the same packing into a numpy buffer,
    the plain version over the inputs read back out of it, its results
    packed into the buffer's result regions and unpacked from there.
    None when the layout declines."""
    layout = window_layout(seg_ids, num_segments)
    if layout is None:
        return None
    _check_values(values)
    plan = stage_plan(len(values), layout, num_segments, values.dtype,
                      rows=True)
    buf = np.zeros(plan.total, dtype=np.uint8)
    pack(buf, plan, layout, (values, valid, seg_ids))
    t = torch.from_numpy(buf)
    out = window_partials_plain(
        *(region(t, plan, k) for k in ("values", "valid", "seg_ids")),
        staged_layout(buf, plan), num_segments)
    for k in _OUTS:
        region(t, plan, k).copy_(out[k])
    return {k: region(buf, plan, k).copy() for k in _OUTS}


def _run_card(dev, values, valid, seg_ids, num_segments: int
              ) -> dict | None:
    """The card route: the library's host half lays the batch out (the
    same layout as window_layout) and packs it into a staging slot, then
    one copy each way around one launch. None when the layout
    declines."""
    from . import cuda_build

    lib = cuda_build.library("segment_window")
    n = len(values)
    seg = seg_ids
    if seg.dtype != np.int32:
        if int(seg.min()) < 0 or int(seg.max()) >= num_segments:
            raise ValueError(f"segment ids outside [0, {num_segments})")
        seg = seg.astype(np.int32)
    seg = np.ascontiguousarray(seg)
    values = np.ascontiguousarray(values)
    valid = np.ascontiguousarray(valid if valid.itemsize == 1
                                 else valid.astype(np.int8))
    seg_ptr = seg.ctypes.data
    runs, buf, at, regions = _host_bounds(lib, seg_ptr, n, num_segments)
    if runs < 0:
        return None
    _check_values(values)
    slots, span_max = struct.unpack_from("<qq", buf, regions["stats"][0])
    plan = _plan(n, runs, slots, span_max, num_segments, values.dtype, True)
    rows = (values.ctypes.data, valid.ctypes.data, seg_ptr)
    runs_at = [at + regions[k][0]
               for k in ("run_tile", "run_base", "slot_off")]
    return _run_staged(
        dev, plan, values.dtype == np.float64,
        lambda stage: lib.segment_window_pack(
            stage.ctypes.data, plan.offsets, *rows, n, *runs_at, runs,
            num_segments),
        None, fetch=True)


@functools.lru_cache(maxsize=256)
def _host_regions(tiles: int) -> tuple:
    """Where the library's host half writes one call's layout: name →
    (offset, element count, numpy dtype) in one host buffer, and its
    size."""
    i32, i64 = np.dtype(np.int32), np.dtype(np.int64)
    regions, off = {}, 0
    for name, count, d in (("slot_off", tiles + 1, i64), ("stats", 2, i64),
                           ("bases", tiles, i32), ("run_tile", tiles + 1, i32),
                           ("run_base", tiles, i32)):
        regions[name] = (off, count, d)
        off += -(-count * d.itemsize // _ALIGN) * _ALIGN
    return regions, off


def _host_bounds(lib, seg_ptr: int, n: int, num_segments: int) -> tuple:
    """The library's host half over n contiguous int32 segment ids at
    seg_ptr → (run count, -1 when the layout declines; the host buffer;
    its address; its regions). The arrays share one buffer, so the call
    takes one numpy pointer lookup: each costs microseconds, which the
    main path's few-thousand-row calls feel. Raises on ids outside
    [0, num_segments)."""
    regions, size = _host_regions(-(-n // R_TILE))
    buf = np.empty(size, dtype=np.uint8)
    at = buf.ctypes.data
    runs = lib.segment_window_bounds(
        seg_ptr, n, num_segments, W_WIN, TILES_PER_RUN,
        *(at + regions[k][0] for k in ("bases", "run_tile", "run_base",
                                       "slot_off", "stats")))
    if runs < -1:
        raise ValueError(f"segment ids outside [0, {num_segments})")
    return runs, buf, at, regions
