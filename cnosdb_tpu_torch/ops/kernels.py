"""Core device kernels: masked segment aggregation, as torch ops.

The port of cnosdb_tpu/ops/kernels.py. Every (row → segment) mapping —
segment = group_id × n_buckets + time_bucket — feeds masked segment
reductions for count/sum/min/max and rank-argmin/argmax selections for
first/last (X1). The empty-segment conventions are the JAX package's:
count 0, sum 0, dtype extrema for min/max, and the int32 scatter
identities for the first/last rank keys.

`aggregate_column_host` is the host-prep device path: when the layout
qualifies it routes to K1, the hand-written windowed segment kernel
(ops/pallas_kernels.py); otherwise to X1 on the scan device. The numpy
helpers (`numpy_segment_partials`, `run_boundaries`,
`run_segment_partials`) are copies of the JAX package's, which sit in a
module that imports jax.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

I32_MAX = np.int32(2**31 - 1)
I32_MIN = np.int32(-(2**31) + 1)


def pad_rows(n: int, minimum: int = 1024) -> int:
    """Next power-of-two size class."""
    m = minimum
    while m < n:
        m <<= 1
    return m


def pad_segments(n: int, minimum: int = 64) -> int:
    m = minimum
    while m < n:
        m <<= 1
    return m


def type_extrema(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf"), float("-inf")
    info = torch.iinfo(dtype)
    return info.max, info.min


def segment_sum(values, seg, num_segments: int):
    """Σ values per segment (`seg` int64 in [0, num_segments)). On a CUDA
    device index_add_ adds floats with atomics, in whatever order the
    threads land, so the last bits of a float sum change from run to run:
    there floats take ordered_segment_sum, whose order is fixed."""
    if values.is_cuda and values.dtype.is_floating_point:
        return ordered_segment_sum(values, seg, num_segments)
    return torch.zeros(num_segments, dtype=values.dtype,
                       device=values.device).index_add_(0, seg, values)


# rows a thread folds in order: a segment of up to this many rows of one
# call is folded from 0 in row order, as index_add_ on the CPU adds it
ORDERED_CHUNK = 1 << 16


def ordered_segment_sum(values, seg, num_segments: int):
    """Σ values per segment in an order fixed by the inputs. The rows are
    sorted by segment (stable); segment_reduce over a [rows, 1] column
    folds each run of rows in one thread, in order (over a 1-D tensor it
    reduces in a tree instead). A segment's rows are cut into runs of
    ORDERED_CHUNK, folded in parallel, then the runs' sums are folded in
    order: up to ORDERED_CHUNK rows a segment, that is the fold from 0 in
    row order of index_add_ on the CPU, bit for bit."""
    dev = values.device
    order = torch.argsort(seg, stable=True)
    lengths = torch.bincount(seg, minlength=num_segments)
    runs = torch.clamp((lengths + ORDERED_CHUNK - 1) // ORDERED_CHUNK,
                       min=1)
    n_runs = int(runs.sum())  # lint: disable=host-sync (the run count sizes repeat_interleave's output: one sync per ordered f64 sum, a known cost)
    run_seg = torch.repeat_interleave(
        torch.arange(num_segments, device=dev), runs, output_size=n_runs)
    first_run = torch.cumsum(runs, 0) - runs
    k = torch.arange(n_runs, device=dev) - first_run[run_seg]
    run_len = torch.clamp(lengths[run_seg] - k * ORDERED_CHUNK, 0,
                          ORDERED_CHUNK)
    partial = torch.segment_reduce(values[order].unsqueeze(1), "sum",
                                   lengths=run_len, axis=0, unsafe=True)
    return torch.segment_reduce(partial, "sum", lengths=runs, axis=0,
                                unsafe=True).squeeze(1)


def local_segment_partials(values, valid, seg_ids, rank, *, num_segments: int,
                           want_count=True, want_sum=True, want_min=True,
                           want_max=True, want_first=False, want_last=False):
    """Masked segment reductions for one column (X1).

    values [N], valid [N] bool, seg_ids [N] int (padded/filtered rows
    carry seg 0 with valid=False), rank [N] i32 globally-unique time
    order. → dict of [num_segments] tensors (plus first_rank/last_rank
    carrying the selection keys)."""
    out = {}
    dev = values.device
    seg = seg_ids.to(torch.int64)
    ns = num_segments
    vmax, vmin = type_extrema(values.dtype)
    zero = torch.zeros((), dtype=values.dtype, device=dev)
    if want_count:
        out["count"] = torch.zeros(ns, dtype=torch.int32, device=dev) \
            .index_add_(0, seg, valid.to(torch.int32))
    if want_sum:
        out["sum"] = segment_sum(torch.where(valid, values, zero), seg, ns)
    if want_min:
        hi = torch.full((), vmax, dtype=values.dtype, device=dev)
        # scatter_reduce's amin/amax propagate NaN (CPU and CUDA), as
        # jnp.min / np.minimum do
        out["min"] = torch.full((ns,), vmax, dtype=values.dtype,
                                device=dev).scatter_reduce_(
            0, seg, torch.where(valid, values, hi), "amin")
    if want_max:
        lo = torch.full((), vmin, dtype=values.dtype, device=dev)
        out["max"] = torch.full((ns,), vmin, dtype=values.dtype,
                                device=dev).scatter_reduce_(
            0, seg, torch.where(valid, values, lo), "amax")
    if want_first or want_last:
        rank = rank.to(torch.int32)
    i32 = torch.iinfo(torch.int32)
    if want_first:
        key = torch.where(valid, rank, torch.full_like(rank, int(I32_MAX)))
        rmin = torch.full((ns,), i32.max, dtype=torch.int32, device=dev) \
            .scatter_reduce_(0, seg, key, "amin")
        sel = valid & (rank == rmin[seg])
        out["first"] = torch.zeros(ns, dtype=values.dtype, device=dev) \
            .index_add_(0, seg, torch.where(sel, values, zero))
        out["first_rank"] = rmin
    if want_last:
        key = torch.where(valid, rank, torch.full_like(rank, int(I32_MIN)))
        rmax = torch.full((ns,), i32.min, dtype=torch.int32, device=dev) \
            .scatter_reduce_(0, seg, key, "amax")
        sel = valid & (rank == rmax[seg])
        out["last"] = torch.zeros(ns, dtype=values.dtype, device=dev) \
            .index_add_(0, seg, torch.where(sel, values, zero))
        out["last_rank"] = rmax
    return out


def numpy_segment_partials(values: np.ndarray, valid: np.ndarray,
                           seg_ids: np.ndarray, rank: np.ndarray,
                           num_segments: int, wants: dict,
                           assume_all_valid: bool = False) -> dict:
    """Pure-numpy segment reductions — the CPU-placement twin of the XLA
    kernel. On one core, bincount/ufunc.at beat XLA's scatter lowering by
    ~2×, and no padding copies are needed; the device path remains the
    jitted kernel (placement decides, ops/placement.py)."""
    if not assume_all_valid and not valid.all():
        rows = np.nonzero(valid)[0]
        values = values[rows]
        seg_ids = seg_ids[rows]
        rank = rank[rows]
    out: dict[str, np.ndarray] = {}
    ns = num_segments
    if wants.get("want_count"):
        out["count"] = np.bincount(seg_ids, minlength=ns).astype(np.int64)
    integral = values.dtype.kind in "iu"
    if wants.get("want_sum"):
        if integral:
            # bincount sums in f64 and would round past 2^53; add.at is
            # slower but exact in the column's own integer arithmetic
            acc = np.zeros(ns, dtype=values.dtype)
            np.add.at(acc, seg_ids, values)
            out["sum"] = acc
        else:
            out["sum"] = np.bincount(seg_ids, weights=values, minlength=ns)
    if wants.get("want_min"):
        init = (np.iinfo(values.dtype).max if integral
                else np.asarray(np.inf, values.dtype))
        acc = np.full(ns, init, dtype=values.dtype)
        np.minimum.at(acc, seg_ids, values)
        out["min"] = acc
    if wants.get("want_max"):
        init = (np.iinfo(values.dtype).min if integral
                else np.asarray(-np.inf, values.dtype))
        acc = np.full(ns, init, dtype=values.dtype)
        np.maximum.at(acc, seg_ids, values)
        out["max"] = acc
    if wants.get("want_first") or wants.get("want_last"):
        sel_rank = {}
        if wants.get("want_first"):
            acc = np.full(ns, I32_MAX, dtype=rank.dtype)
            np.minimum.at(acc, seg_ids, rank)
            sel_rank["first"] = acc
        if wants.get("want_last"):
            acc = np.full(ns, I32_MIN, dtype=rank.dtype)
            np.maximum.at(acc, seg_ids, rank)
            sel_rank["last"] = acc
        for name, acc in sel_rank.items():
            pick = rank == acc[seg_ids]
            vals_out = np.zeros(ns, dtype=values.dtype)
            vals_out[seg_ids[pick]] = values[pick]
            out[name] = vals_out
            out[f"{name}_rank"] = acc
    return out


def run_boundaries(seg_ids: np.ndarray,
                   sid_ordinal: np.ndarray | None = None) -> np.ndarray:
    """Start indices of equal-segment runs (splitting additionally at
    series boundaries when sid_ordinal is given — first/last need time
    order WITHIN every run, which only holds per series).

    Correct for arbitrary seg arrays — a segment recurring in many runs
    just contributes several partials; the caller combines them. Fast
    when segments are contiguous, which the storage layout guarantees:
    scan batches are series-contiguous and time-ordered per series, so
    group×bucket segment ids form runs."""
    n = len(seg_ids)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    ch = np.diff(seg_ids) != 0
    if sid_ordinal is not None:
        ch = ch | (np.diff(sid_ordinal) != 0)
    return np.concatenate(([0], np.flatnonzero(ch) + 1)).astype(np.int64)


_I64_MAX = np.int64(np.iinfo(np.int64).max)
_I64_MIN = np.int64(np.iinfo(np.int64).min)


def run_segment_partials(values: np.ndarray, seg_ids: np.ndarray,
                         starts: np.ndarray, num_segments: int, wants: dict,
                         ts: np.ndarray | None = None,
                         run_counts: np.ndarray | None = None) -> dict:
    """Segment reductions over contiguous equal-segment runs.

    The storage-layout-aware twin of numpy_segment_partials: sequential
    ufunc.reduceat over runs replaces scatter bincount/ufunc.at (5-8×
    faster on one core at bench scale), then tiny per-run combines fold
    runs into segments. ALL rows are assumed valid — callers compress
    invalid rows out first (compression preserves run structure).

    first/last require `ts` (row timestamps, time-ordered within each
    run) and return companion 'first_ts'/'last_ts' arrays — actual
    timestamps, which coordinators can merge across vnodes directly.
    Tie-breaking matches the rank kernels: earliest row position wins
    `first`, latest wins `last`."""
    out: dict[str, np.ndarray] = {}
    ns = num_segments
    n = len(values)
    if n == 0:
        starts = starts[:0]
    run_seg = seg_ids[starts] if n else np.zeros(0, dtype=np.int64)
    if run_counts is None:
        run_counts = np.diff(np.append(starts, n))
    if wants.get("want_count"):
        out["count"] = np.bincount(
            run_seg, weights=run_counts, minlength=ns).astype(np.int64)
    integral = values.dtype.kind in "iu"
    if wants.get("want_sum"):
        part = np.add.reduceat(values, starts) if n else values[:0]
        if integral:
            # bincount sums in f64 and would round past 2^53; add.at over
            # the (few) runs is exact in the column's own arithmetic
            acc = np.zeros(ns, dtype=values.dtype)
            np.add.at(acc, run_seg, part)
            out["sum"] = acc
        else:
            out["sum"] = np.bincount(run_seg, weights=part, minlength=ns)
    if wants.get("want_min"):
        init = (np.iinfo(values.dtype).max if integral
                else np.asarray(np.inf, values.dtype))
        part = np.minimum.reduceat(values, starts) if n else values[:0]
        acc = np.full(ns, init, dtype=values.dtype)
        np.minimum.at(acc, run_seg, part)
        out["min"] = acc
    if wants.get("want_max"):
        init = (np.iinfo(values.dtype).min if integral
                else np.asarray(-np.inf, values.dtype))
        part = np.maximum.reduceat(values, starts) if n else values[:0]
        acc = np.full(ns, init, dtype=values.dtype)
        np.maximum.at(acc, run_seg, part)
        out["max"] = acc
    if wants.get("want_first"):
        ft = ts[starts] if n else np.zeros(0, dtype=np.int64)
        acc_t = np.full(ns, _I64_MAX, dtype=np.int64)
        np.minimum.at(acc_t, run_seg, ft)
        pick = np.flatnonzero(ft == acc_t[run_seg])
        fvals = np.zeros(ns, dtype=values.dtype)
        # reversed assignment: among ties the EARLIEST run wins (stable
        # time-sort semantics of the rank kernel)
        fvals[run_seg[pick][::-1]] = values[starts][pick][::-1]
        out["first"] = fvals
        out["first_ts"] = acc_t
    if wants.get("want_last"):
        ends = (np.append(starts[1:], n) - 1) if n \
            else np.zeros(0, dtype=np.int64)
        lt = ts[ends] if n else np.zeros(0, dtype=np.int64)
        acc_t = np.full(ns, _I64_MIN, dtype=np.int64)
        np.maximum.at(acc_t, run_seg, lt)
        pick = np.flatnonzero(lt == acc_t[run_seg])
        lvals = np.zeros(ns, dtype=values.dtype)
        lvals[run_seg[pick]] = values[ends][pick]   # latest tied run wins
        out["last"] = lvals
        out["last_ts"] = acc_t
    return out


def to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array → tensor on `dev` (a copy on the card; on the CPU it
    shares the array's memory, so callers never write into it)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:   # torch.from_numpy wants a writable buffer
        a = a.copy()
    return torch.from_numpy(a).to(dev)


def to_host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()  # lint: disable=host-sync (THE audited transfer point of the host-prep path and X4: every result pull goes through here, one per result tensor)


def aggregate_column_host(values: np.ndarray, valid: np.ndarray,
                          seg_ids: np.ndarray, rank: np.ndarray,
                          num_segments: int, wants: dict) -> dict:
    """Host wrapper of the host-prep device path: runs the column's
    segment reductions on the scan device and pulls the results back as
    numpy (sliced to num_segments).

    When the windowed segment kernel is enabled (pallas_kernels.enabled:
    a CUDA scan device, or CNOSDB_TPU_PALLAS=1) and the batch's segment
    layout qualifies, K1 replaces the scatter reductions; first/last
    (rank selection) and disqualified layouts fall back to X1 below —
    the JAX package's routing."""
    n = len(values)
    ns_pad = pad_segments(max(num_segments, 1))
    from . import pallas_kernels as pk

    if pk.enabled() and n:
        # None = a layout decline (first/last wanted, or a tile's
        # segment span too wide), already counted by the wrapper
        out = pk.segment_partials_pallas(
            values, valid, seg_ids, num_segments, wants=wants)
        if out is not None:
            pk.note_engaged()
            if "count" in out:
                out["count"] = out["count"].astype(np.int64)
            return out
    from .placement import scan_device

    dev = scan_device()
    out = local_segment_partials(
        to_device(values, dev), to_device(valid, dev),
        to_device(seg_ids, dev), to_device(rank, dev),
        num_segments=ns_pad, **wants)
    host = {k: to_host(v)[:num_segments] for k, v in out.items()}
    if "count" in host:
        host["count"] = host["count"].astype(np.int64)
    return host


# ---------------------------------------------------------------------------
# sort-based DISTINCT and top-K on the device (X4)
# ---------------------------------------------------------------------------
# Runs of each X4 op on the scan device (the op is the port: there is no
# separate plain version, so a CPU scan device counts too), by op name,
# and by the shape each run saw: segment_distinct_count (rows, segments,
# values), sorted_pair_codes (rows, values), topk_threshold (rows, k,
# dtype), dict_mask_gather (rows, uniques).
_x4_lock = threading.Lock()
x4_launches: dict[str, int] = {}
x4_launch_shapes: dict[str, dict[tuple, int]] = {}


def _x4_note(name: str, shape: tuple) -> None:
    with _x4_lock:
        x4_launches[name] = x4_launches.get(name, 0) + 1
        shapes = x4_launch_shapes.setdefault(name, {})
        shapes[shape] = shapes.get(shape, 0) + 1


def reset_x4_counts() -> None:
    with _x4_lock:
        x4_launches.clear()
        x4_launch_shapes.clear()


def segment_distinct_count(gid: np.ndarray, vcodes: np.ndarray,
                           num_segments: int, n_values: int) -> np.ndarray:
    """count(DISTINCT) from (group·nv + value) pair codes on the scan
    device: sort, mark each first occurrence, segment-sum the indicators
    by group. → i64 counts [num_segments]."""
    n = len(gid)
    if n == 0:
        return np.zeros(num_segments, dtype=np.int64)
    from .placement import scan_device

    nv = np.int64(max(int(n_values), 1))
    pairs = gid.astype(np.int64) * nv + vcodes.astype(np.int64)
    out = distinct_counts(to_device(pairs, scan_device()), int(nv),
                          num_segments)
    _x4_note("segment_distinct_count", (n, int(num_segments), int(nv)))
    return to_host(out)


def distinct_counts(pairs: torch.Tensor, nv: int,
                    num_segments: int) -> torch.Tensor:
    """segment_distinct_count's device half, on pair codes already on the
    device: sort, mark each first occurrence, segment-sum the indicators
    by group (pair // nv)."""
    sp = torch.sort(pairs).values
    first = torch.ones_like(sp, dtype=torch.int64)
    first[1:] = (sp[1:] != sp[:-1]).to(torch.int64)
    return torch.zeros(num_segments, dtype=torch.int64, device=sp.device) \
        .index_add_(0, torch.div(sp, nv, rounding_mode="floor"), first)


def sorted_pair_codes(gid: np.ndarray, vcodes: np.ndarray,
                      n_values: int) -> np.ndarray:
    """One chunk's DISTINCT partial: device-sorted unique (group, value)
    pair codes (the on-wire partial shape of the JAX package)."""
    n = len(gid)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    from .placement import scan_device

    nv = np.int64(max(int(n_values), 1))
    pairs = gid.astype(np.int64) * nv + vcodes.astype(np.int64)
    sp = to_host(torch.sort(to_device(pairs, scan_device())).values)
    _x4_note("sorted_pair_codes", (n, int(nv)))
    keep = np.concatenate(([True], sp[1:] != sp[:-1]))
    return sp[keep]


def dict_mask_gather(mask: np.ndarray, codes):
    """Per-unique predicate mask → row mask on the device: one integer
    gather through dictionary codes that already live on the device
    (codes past either end clip to it, as jnp.take's clip mode does)."""
    m = to_device(mask, codes.device)
    out = m[codes.to(torch.int64).clamp(0, len(mask) - 1)]
    _x4_note("dict_mask_gather", (len(codes), len(mask)))
    return out


_SIGN = torch.iinfo(torch.int64).min


def topk_threshold(vals: np.ndarray, k: int):
    """k-th largest value of `vals` (descending top-K threshold) via
    torch.topk on the scan device; only this scalar crosses back.
    Caller guarantees 0 < k < len(vals) and no NaNs.

    torch.topk takes no unsigned type wider than 8 bits: narrower
    unsigned types widen to int64, and uint64 travels as its bits with
    the sign bit flipped (an order-preserving map onto int64), flipped
    back on the way out."""
    from .placement import scan_device

    k = int(k)
    flip = vals.dtype == np.uint64
    host = vals.view(np.int64) if flip else \
        vals.astype(np.int64) if vals.dtype.kind == "u" else vals
    top = kth_largest(to_device(host, scan_device()), k, flip_sign=flip)
    _x4_note("topk_threshold", (len(vals), k, str(vals.dtype)))
    out = np.asarray(to_host(top))
    return out.view(np.uint64) if flip else out.astype(vals.dtype)


def kth_largest(t: torch.Tensor, k: int,
                flip_sign: bool = False) -> torch.Tensor:
    """topk_threshold's device half: the k-th largest element of `t` as a
    0-d tensor. `flip_sign` orders int64 bits as uint64 (the sign bit
    flipped on the way in and back on the way out)."""
    if flip_sign:
        t = t ^ _SIGN
    top = torch.topk(t, k).values[k - 1]
    return top ^ _SIGN if flip_sign else top
