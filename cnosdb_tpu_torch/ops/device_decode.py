"""Device-side decode plane: the TSM codecs as batched kernels on the card.

The port of cnosdb_tpu/ops/device_decode.py. Host work stops at the
byte-container stage (zstd et al — storage/codecs.split_for_device), the
still-narrow post-container payloads ship to the device, and the
per-value codec transforms run there as batched programs:

  delta / delta_ts   widen -> unzigzag -> cumsum   (i64, u64 bit-rides)
  delta const-stride first + stride * iota
  gorilla f64        byte-plane assembly + prefix-XOR scan (K2, one
                     hand-written CUDA kernel, csrc/xor_scan.cu)
  bitpack bool       bit-expansion from packed u8
  string dict pages  narrow code widening (codes on the device; the
                     Python dictionary itself stays host-side)

Everything but K2 is plain torch ops (X3). Pages are padded into [B, L]
buffers keyed by (kind, width, pow2 length bucket), as in the JAX
package. Outputs are bit-identical to storage/codecs.decode because every
transform is integer/bitwise. PyTorch's unsigned integer support is thin,
so u64 words ride as int64 bit patterns and narrow unsigned inputs are
zero-extended by masking.

Gating mirrors pallas_kernels: CNOSDB_DEVICE_DECODE=1 forces the lane on
(the plain versions on a CPU scan device — how tests engage it), =0 off,
auto enables it when the scan device is a CUDA card. Every page the lane
examines but does not decode books a (lane, reason) outcome. Unlike the
JAX package, a kernel that cannot build or launch raises instead of
re-routing its pages to the host as `kernel_error`.
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..models.codec import Encoding
from ..models.schema import ValueType
from ..utils import stages

_MIN_LANE = 128
# narrow unsigned payloads upload as the signed type of the same width
# (torch has few unsigned ops) and widen on the device by masking
_WIDTH_SIGNED = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}
_WIDTH_MASK = {1: 0xFF, 2: 0xFFFF, 4: 0xFFFFFFFF, 8: None}


def enabled() -> bool:
    """Should scans route decodes through this plane?"""
    return disabled_reason() is None


def disabled_reason() -> str | None:
    """None when the lane is usable, else WHY not."""
    mode = os.environ.get("CNOSDB_DEVICE_DECODE", "auto").lower()
    if mode in ("1", "on", "true"):
        return None
    if mode in ("0", "off", "false"):
        return f"disabled by env CNOSDB_DEVICE_DECODE={mode}"
    from .placement import scan_device

    dev = scan_device()
    if dev.type != "cuda":
        return f"scan device is {dev.type!r}, not cuda (auto mode)"
    return None


# ---------------------------------------------------------------------------
# engagement + outcome accounting
# ---------------------------------------------------------------------------
_LOCK = threading.Lock()
_engagements = 0
_xor_engagements = 0
xor_launches = 0     # CUDA launches of K2, both entry points (the plain
                     # versions are not counted)
xor_launch_shapes: dict[tuple, int] = {}   # (rows, row length) → launches
_outcomes: dict[tuple[str, str], int] = {}


def note_engaged(n: int = 1) -> None:
    global _engagements
    with _LOCK:
        _engagements += n
    stages.count("device_decode_engagements", n)


def engagements() -> int:
    """Pages decoded by the device lane this process."""
    with _LOCK:
        return _engagements


def xor_engagements() -> int:
    """Gorilla page groups decoded through K2 this process (the plain
    version on a CPU scan device included)."""
    with _LOCK:
        return _xor_engagements


def count_outcome(lane: str, reason: str, n: int = 1) -> None:
    """Book n pages as handled by `lane` ("device" or "host") for
    `reason` — the raw series behind cnosdb_device_decode_total."""
    with _LOCK:
        _outcomes[(lane, reason)] = _outcomes.get((lane, reason), 0) + n


def outcomes_snapshot() -> dict[tuple[str, str], int]:
    with _LOCK:
        return dict(sorted(_outcomes.items()))


def _pow2(n: int, minimum: int) -> int:
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()


# ---------------------------------------------------------------------------
# K2: prefix-XOR scan along rows, and the whole Gorilla decode around it
# ---------------------------------------------------------------------------
def xor_scan_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: inclusive prefix-XOR along each row
    of a [B, L] int64 (u64 bit patterns) matrix, log-step."""
    width = x.shape[1]
    s = 1
    while s < width:
        shifted = torch.zeros_like(x)
        shifted[:, s:] = x[:, :-s]
        x = x ^ shifted
        s <<= 1
    return x


def gorilla_decode_plain(planes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2's Gorilla decode: [B, 8, L] u8 byte
    planes -> [B, L] int64 f64 bit patterns (assemble, then scan)."""
    return xor_scan_plain(_gorilla_words(planes))


def xor_scan(x: torch.Tensor) -> torch.Tensor:
    """K2: inclusive prefix-XOR along each row of a contiguous [B, L]
    int64 matrix. A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel."""
    if x.dtype != torch.int64 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("K2 takes a contiguous [B, L] int64 matrix")
    if x.device.type == "cpu":
        return xor_scan_plain(x)
    return _k2_launch("xor_scan_u64", x, tuple(x.shape))


def gorilla_decode(planes: torch.Tensor) -> torch.Tensor:
    """K2 as the whole Gorilla f64 decode: [B, 8, L] u8 byte planes
    (plane k = byte k of each u64, little endian) -> [B, L] int64 holding
    the f64 bits, in one kernel. A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel."""
    if planes.dtype != torch.uint8 or planes.dim() != 3 \
            or planes.shape[1] != 8 or not planes.is_contiguous():
        raise ValueError("K2 decode takes contiguous [B, 8, L] uint8 planes")
    if planes.device.type == "cpu":
        return gorilla_decode_plain(planes)
    b, _, width = planes.shape
    return _k2_launch("gorilla_decode_u8", planes, (b, width))


def k2_state(shape: tuple, device) -> torch.Tensor:
    """The ticket/status scratch one K2 launch over [B, L] needs (the
    entry point zeroes it on its stream before the kernel runs)."""
    from . import cuda_build

    lib = cuda_build.library("xor_scan")
    return torch.empty(lib.xor_scan_state_words(*shape), dtype=torch.int64,
                       device=device)


def _k2_launch(entry: str, x: torch.Tensor, shape: tuple, out=None,
               state=None) -> torch.Tensor:
    """Launch one K2 entry point over `x` into a [B, L] int64 output.
    Without `out` and `state` (k2_state) both are fresh, so the scratch
    is per call; a caller that passes both keeps them for its own
    launches."""
    global xor_launches
    if x.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda or cpu, not {x.device}")
    from . import cuda_build

    lib = cuda_build.library("xor_scan")
    if out is None or state is None:
        # one allocation: the output, then the scratch behind it
        words = shape[0] * shape[1]
        buf = torch.empty(words + lib.xor_scan_state_words(*shape),
                          dtype=torch.int64, device=x.device)
        out, state = buf[:words].view(shape), buf[words:]
    rc = getattr(lib, entry)(x.data_ptr(), out.data_ptr(), state.data_ptr(),
                             shape[0], shape[1],
                             cuda_build.current_stream(x.device))
    cuda_build.check(lib, rc, f"{entry} (K2)")
    with _LOCK:
        xor_launches += 1
        xor_launch_shapes[shape] = xor_launch_shapes.get(shape, 0) + 1
    return out


# ---------------------------------------------------------------------------
# X3: the other decode programs, plain torch
# ---------------------------------------------------------------------------
def _widen(t: torch.Tensor, width: int) -> torch.Tensor:
    """Narrow unsigned payload (uploaded as the same-width signed or u8
    type) → int64 with zero extension."""
    w = t.to(torch.int64)
    mask = _WIDTH_MASK[width]
    return w if mask is None else w & mask


def _delta_kernel(zz: torch.Tensor, firsts: torch.Tensor) -> torch.Tensor:
    """[B, L] zigzag deltas (int64 bit patterns) + [B] firsts -> [B, L]
    i64 values: out[b, i] = first_b + sum(deltas[:i]), wrapping in two's
    complement as numpy's cumsum does."""
    half = (zz >> 1) & 0x7FFFFFFFFFFFFFFF   # logical shift of the u64
    d = half ^ (-(zz & 1))
    csum = torch.cumsum(d, dim=1)
    out = torch.empty_like(csum)
    out[:, 0] = 0
    out[:, 1:] = csum[:, :-1]
    return firsts[:, None] + out


def _delta_const_kernel(firsts, strides, length: int) -> torch.Tensor:
    """Constant-stride timestamp fast path: first + stride * iota."""
    idx = torch.arange(length, dtype=torch.int64, device=firsts.device)
    return firsts[:, None] + strides[:, None] * idx[None, :]


def _gorilla_words(planes: torch.Tensor) -> torch.Tensor:
    """[B, 8, L] u8 byte planes (plane k = byte k of each u64, little
    endian) -> [B, L] int64 XOR-delta words."""
    p = planes.to(torch.int64)
    w = p[:, 0]
    for k in range(1, 8):
        w = w | (p[:, k] << (8 * k))
    return w


def _bitpack_kernel(packed: torch.Tensor) -> torch.Tensor:
    """[B, Lb] packed u8 -> [B, Lb*8] 0/1 u8 (MSB-first, np.packbits)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, :, None] >> shifts[None, None, :]) & 1
    return bits.reshape(packed.shape[0], -1)


# ---------------------------------------------------------------------------
# the scan-facing lane
# ---------------------------------------------------------------------------
class _Job:
    __slots__ = ("plan", "token", "colname", "vt", "out_off", "n_rows",
                 "nm", "out_vals", "out_valid", "sink", "dev")


class DeviceDecodeLane:
    """One scan's device-decode batch builder (the JAX package's contract:
    `submit()` during page planning, one `run()` that executes the batched
    programs and writes host outputs back, then `attach_device_columns()`
    hands fully device-decoded, null-free, contiguously-covering columns
    to the EagerUploader without a host round trip)."""

    _NUMERIC_ENC = {
        int(ValueType.FLOAT): {int(Encoding.GORILLA)},
        int(ValueType.INTEGER): {int(Encoding.DELTA),
                                 int(Encoding.DELTA_TS)},
        int(ValueType.UNSIGNED): {int(Encoding.DELTA),
                                  int(Encoding.DELTA_TS)},
        int(ValueType.BOOLEAN): {int(Encoding.BITPACK),
                                 int(Encoding.NULL)},
    }

    def __init__(self):
        self._jobs: list[_Job] = []

    def accepts(self, value_type: int, encoding: int) -> bool:
        """Cheap pre-check: does (value_type, encoding) have a device
        program at all?"""
        ok = self._NUMERIC_ENC.get(int(value_type))
        return ok is not None and int(encoding) in ok

    def declined(self, reason: str, n: int = 1) -> None:
        """Book n pages the scan examined but routed to a host lane."""
        count_outcome("host", reason, n)

    def pending(self) -> int:
        return len(self._jobs)

    def submit(self, plan: dict, token, colname, vt, out_off: int,
               n_rows: int, nm, out_vals, out_valid, sink=None) -> None:
        """Queue one page. Numeric/time pages write into
        out_vals/out_valid at out_off (nm = null mask, as
        read_field_page returns); string pages deliver dense i32 codes
        to `sink` instead."""
        j = _Job()
        j.plan, j.token, j.colname, j.vt = plan, token, colname, vt
        j.out_off, j.n_rows, j.nm = out_off, n_rows, nm
        j.out_vals, j.out_valid, j.sink = out_vals, out_valid, sink
        j.dev = None
        self._jobs.append(j)

    # ------------------------------------------------------------- execute
    def run(self) -> list:
        """Execute every submitted page as batched programs. → the tokens
        of pages that failed, always empty here: a device fault raises
        (the caller's Python lane is not a hiding place for the card)."""
        groups: dict = {}
        for j in self._jobs:
            groups.setdefault(self._group_key(j), []).append(j)
        for key, jobs in groups.items():
            out = self._run_group(key, jobs)
            host = out.cpu().numpy()  # lint: disable=host-sync (audited transfer point: the decode lane's one pull per row group)
            for bi, j in enumerate(jobs):
                n = j.plan["n"]
                j.dev = out[bi, :n]
                self._writeback(j, host[bi, :n])
            count_outcome("device", "ok", len(jobs))
            note_engaged(len(jobs))
        return []

    def _group_key(self, j: _Job):
        p = j.plan
        kind = p["kind"]
        if kind == "bitpack":
            return (kind, 1, _pow2((p["n"] + 7) // 8, _MIN_LANE // 8))
        width = p.get("width", 8)
        return (kind, width, _pow2(p["n"], _MIN_LANE))

    def _run_group(self, key, jobs) -> torch.Tensor:
        """One (kind, width, length-bucket) batch -> [B, L] device rows."""
        global _xor_engagements
        kind, width, lane_len = key
        b_pad = _pow2(len(jobs), 1)
        if kind == "delta_const":
            firsts = np.zeros(b_pad, np.int64)
            strides = np.zeros(b_pad, np.int64)
            for bi, j in enumerate(jobs):
                firsts[bi] = j.plan["first"]
                strides[bi] = j.plan["stride"]
            return _delta_const_kernel(self._put(firsts),
                                       self._put(strides), lane_len)
        if kind == "delta":
            zz = np.zeros((b_pad, lane_len), dtype=_WIDTH_SIGNED[width])
            firsts = np.zeros(b_pad, np.int64)
            for bi, j in enumerate(jobs):
                raw = np.frombuffer(j.plan["raw"], dtype=zz.dtype)
                zz[bi, :len(raw)] = raw
                firsts[bi] = j.plan["first"]
            return _delta_kernel(_widen(self._put(zz), width),
                                 self._put(firsts))
        if kind == "gorilla":
            planes = np.zeros((b_pad, 8, lane_len), dtype=np.uint8)
            for bi, j in enumerate(jobs):
                n = j.plan["n"]
                planes[bi, :, :n] = np.frombuffer(
                    j.plan["raw"], dtype=np.uint8).reshape(8, n)
            out = gorilla_decode(self._put(planes)).view(torch.float64)
            with _LOCK:
                _xor_engagements += 1
            return out
        if kind == "bitpack":
            packed = np.zeros((b_pad, lane_len), dtype=np.uint8)
            for bi, j in enumerate(jobs):
                raw = np.frombuffer(j.plan["raw"], dtype=np.uint8)
                nb = (j.plan["n"] + 7) // 8
                packed[bi, :nb] = raw[:nb]
            return _bitpack_kernel(self._put(packed))
        # dict codes: narrow -> i32 (the DictArray code dtype)
        codes = np.zeros((b_pad, lane_len), dtype=_WIDTH_SIGNED[width])
        for bi, j in enumerate(jobs):
            raw = np.frombuffer(j.plan["raw"], dtype=codes.dtype)
            codes[bi, :len(raw)] = raw
        return _widen(self._put(codes), width).to(torch.int32)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        from .device_cache import _put

        return _put(a)

    def _writeback(self, j: _Job, dense: np.ndarray) -> None:
        """Host-side landing: expand the dense output through the page's
        null mask into the scan's output arrays (same contract as the
        Python page lane)."""
        if j.sink is not None:
            j.sink(dense)
            return
        if j.vt == ValueType.UNSIGNED:
            dense = dense.view(np.uint64)
        elif j.vt == ValueType.BOOLEAN:
            dense = dense.astype(np.bool_)
        off, n = j.out_off, j.n_rows
        if j.nm is None:
            j.out_vals[off:off + n] = dense
            if j.out_valid is not None:
                j.out_valid[off:off + n] = True
        else:
            j.out_vals[off:off + n][~j.nm] = dense
            j.out_valid[off:off + n] = ~j.nm

    # ------------------------------------------------------ device columns
    def attach_device_columns(self, uploader, total: int) -> None:
        """Hand columns whose EVERY page decoded on the device, null-free
        and covering [0, total) contiguously, to the EagerUploader as
        device tensors (no host round trip). Anything else already landed
        in the host arrays and uploads lazily/eagerly as before."""
        bycol: dict[str, list[_Job]] = {}
        for j in self._jobs:
            if j.colname is None or j.sink is not None:
                continue
            bycol.setdefault(j.colname, []).append(j)
        for name, jobs in bycol.items():
            jobs.sort(key=lambda j: j.out_off)
            if any(j.dev is None or j.nm is not None for j in jobs):
                count_outcome("device", "column_not_resident")
                continue
            off = 0
            for j in jobs:
                if j.out_off != off:
                    off = -1
                    break
                off += j.n_rows
            if off != total:
                count_outcome("device", "column_not_resident")
                continue
            uploader.put_device(name, jobs[0].vt, [j.dev for j in jobs])
