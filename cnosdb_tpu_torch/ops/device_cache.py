"""Device-resident scan batches on the card.

The port of cnosdb_tpu/ops/device_cache.py. A ScanBatch ships to the card
ONCE (timestamps, series ordinals, field columns + validity, lazily the
time-order rank), and every later query against the same batch runs on
the card, moving only the group vector in and [num_segments] partials
out. `device_batch(scan_batch)` is the function that turns a scan's host
arrays (numpy) into this device state.

Differences from the TPU layout, none of which changes a result:

- Timestamps live as one int64 column of nanoseconds since the batch
  epoch. The TPU kept an i32 (seconds, ns-remainder) pair because 64-bit
  integer arithmetic is emulated there; the card does int64 natively, and
  the fused program's bucket index is the same floor division either way.
- Rows are not padded to a power-of-two size class (that served the jit
  cache; PyTorch runs eagerly), so `n_pad == n_rows`.
- Uploads stage through pinned host memory and copy asynchronously on
  the current stream, so the transfer of column N overlaps the decode of
  column N+1 (EagerUploader).

Invalidation is the JAX package's: the device arrays hang off the
immutable ScanBatch and die with it.
"""
from __future__ import annotations

import weakref as _weakref

import numpy as np
import torch

from ..models.schema import ValueType
from ..utils import stages

# live device uploads, weakly held — the broker's device_uploads pool
# reads estimated resident bytes from here; no reclaim callback (device
# buffers die with their scan batch, evicting mid-query would corrupt
# the kernels referencing them)
_LIVE_BATCHES: "_weakref.WeakSet" = _weakref.WeakSet()


def device_bytes_used() -> int:
    return sum(getattr(b, "est_bytes", 0) for b in list(_LIVE_BATCHES))


def _register_device_pool() -> None:
    from ..server import memory as _memory

    _memory.register_pool("device_uploads", usage_fn=device_bytes_used)


_register_device_pool()


# An UNSIGNED column on the device is its order-preserving int64, u ^ 2^63:
# torch has next to no uint64 arithmetic or comparison, and int64's order
# on the biased values is uint64's on the raw ones. The fused filter reads
# it back as uint64 (ops/device_filter.FilterValue); the aggregates
# un-bias their results (tpu_exec._assemble).
U64_BIAS = -(1 << 63)


def biased_u64(vals):
    """UNSIGNED values in the device's form: uint64 values (a numpy array)
    or u64 bit patterns in an int64 tensor → int64, u ^ 2^63."""
    if isinstance(vals, torch.Tensor):
        return vals ^ U64_BIAS
    return (np.asarray(vals, dtype=np.uint64)
            ^ np.uint64(1 << 63)).view(np.int64)


def _dev_vals(vt: ValueType, vals: np.ndarray) -> np.ndarray:
    """A field column as the device keeps it: BOOLEAN as int64 0/1 and
    UNSIGNED biased (biased_u64)."""
    if vt == ValueType.BOOLEAN:
        return vals.astype(np.int64)
    if vt == ValueType.UNSIGNED:
        return biased_u64(vals)
    return vals


class DeviceBatch:
    """Device-resident columns of one ScanBatch."""

    __slots__ = ("n_rows", "n_pad", "n_series", "epoch_ns", "ts_rel",
                 "sid_ordinal", "rank", "fields", "ts_min", "ts_max",
                 "field_all_valid", "_rank_np", "est_bytes", "__weakref__")

    def __init__(self, batch):
        with stages.stage("upload_ms"):
            self._init_meta(batch)
            pre = getattr(batch, "_preuploaded", None)
            pre_cols = pre[1] if pre is not None and pre[0] == self.n_pad \
                else {}
            for name, (vt, vals, valid) in batch.fields.items():
                if vt in (ValueType.STRING, ValueType.GEOMETRY):
                    continue  # strings aggregate host-side
                p = pre_cols.get(name)
                if p is not None and p[0] == vt:
                    # column staged by the scan's eager-upload pipeline
                    _vt, dev_vals, dev_valid, all_valid = p
                    self.field_all_valid[name] = all_valid
                    self.fields[name] = (vt, dev_vals, dev_valid)
                    continue
                all_valid = bool(valid.all())
                self.field_all_valid[name] = all_valid
                self.fields[name] = (
                    vt, _put(_dev_vals(vt, vals)),
                    None if all_valid else _put(valid))
            self.est_bytes = self._estimate_bytes()
            _LIVE_BATCHES.add(self)

    def _init_meta(self, batch):
        """Everything except the field columns: row counts, timestamps
        relative to the epoch, series ordinals, lazy rank."""
        n = batch.n_rows
        self.n_rows = n
        self.n_pad = n
        self.n_series = batch.n_series
        self.ts_min = int(batch.ts.min()) if n else 0
        self.ts_max = int(batch.ts.max()) if n else 0
        self.epoch_ns = self.ts_min
        self.ts_rel = _put(np.asarray(batch.ts, dtype=np.int64)
                           - np.int64(self.epoch_ns))
        self.sid_ordinal = _put(np.asarray(batch.sid_ordinal,
                                           dtype=np.int32))
        # globally unique time-order rank (first/last selection key),
        # shipped lazily — only first/last programs reference it
        order = np.argsort(batch.ts, kind="stable")
        rank = np.empty(n, dtype=np.int32)
        rank[order] = np.arange(n, dtype=np.int32)
        self._rank_np = rank
        self.rank = None
        self.fields: dict[str, tuple[ValueType, object, object]] = {}
        self.field_all_valid: dict[str, bool] = {}

    def _estimate_bytes(self) -> int:
        """Resident device-buffer bytes (feeds the broker's
        device_uploads pool; estimate only)."""
        total = 0
        for a in (self.ts_rel, self.sid_ordinal, self.rank):
            total += _nbytes(a)
        for _vt, dev_vals, dev_valid in self.fields.values():
            total += _nbytes(dev_vals) + _nbytes(dev_valid)
        return total

    def rank_dev(self):
        if self.rank is None:
            self.rank = _put(self._rank_np)
            self.est_bytes += _nbytes(self.rank)
        return self.rank


def _nbytes(t) -> int:
    if t is None:
        return 0
    return int(t.numel() * t.element_size())


class EagerUploader:
    """Receives finished scan columns from storage/scan's decode pipeline
    and stages them on the device at once (the pinned copies are
    asynchronous, so the transfer of column N overlaps the decode of
    column N+1). The staged columns attach to the ScanBatch as
    `_preuploaded`, which DeviceBatch.__init__ consumes instead of
    re-staging. A failed upload raises: it is a fault of the card."""

    def __init__(self, n_rows: int):
        self.n_pad = n_rows
        self._cols: dict = {}

    def put(self, name: str, vt: ValueType, vals: np.ndarray,
            valid: np.ndarray):
        with stages.stage("upload_ms"):
            all_valid = bool(valid.all())
            self._cols[name] = (vt, _put(_dev_vals(vt, vals)),
                                None if all_valid else _put(valid),
                                all_valid)

    def put_device(self, name: str, vt: ValueType, parts: list):
        """Stage a column already ON the device (ops/device_decode's
        lane): `parts` are per-page device rows in output order, null-free
        by contract (attach_device_columns filters). The decoded values
        never cross back to the host."""
        with stages.stage("upload_ms"):
            cat = parts[0] if len(parts) == 1 else torch.cat(parts)
            if vt == ValueType.BOOLEAN:
                cat = cat.to(torch.int64)
            elif vt == ValueType.UNSIGNED:
                # the lane carries u64 bit patterns as int64
                cat = biased_u64(cat)
            n = int(cat.shape[0])
            if n < self.n_pad:
                cat = torch.cat([cat, torch.zeros(
                    self.n_pad - n, dtype=cat.dtype, device=cat.device)])
            self._cols[name] = (vt, cat, None, True)

    def attach(self, batch):
        if self._cols:
            batch._preuploaded = (self.n_pad, self._cols)


def merged_device_batch(merged, cached, delta,
                        append_gather: np.ndarray) -> "DeviceBatch | None":
    """Build the device twin of a delta-merged batch by gathering the
    unchanged rows from the cached twin ON the device — the cached field
    columns never cross the host↔device link again; only the (small)
    delta rows upload. Only valid for the pure-append merge shape
    (`append_gather` from merge_scan_batches). → the attached
    DeviceBatch, or None when the cached twin is missing."""
    old = getattr(cached, "_device_batch", None)
    if old is None:
        return None
    with stages.stage("upload_ms"):
        n_c, n_d = cached.n_rows, delta.n_rows
        db = DeviceBatch.__new__(DeviceBatch)
        db._init_meta(merged)
        # gather index into [cached rows | delta rows]
        g_dev = _put(np.asarray(append_gather, dtype=np.int64))
        pre = getattr(delta, "_preuploaded", None)
        pre_cols = pre[1] if pre is not None else {}
        for name, (vt, vals, valid) in merged.fields.items():
            if vt in (ValueType.STRING, ValueType.GEOMETRY):
                continue
            of = old.fields.get(name) if name in cached.fields else None
            if of is None or of[0] != vt or old.n_pad < n_c:
                # new/retyped column: plain upload of the merged array
                all_valid = bool(valid.all())
                db.field_all_valid[name] = all_valid
                db.fields[name] = (
                    vt, _put(_dev_vals(vt, vals)),
                    None if all_valid else _put(valid))
                continue
            _vt, old_vals, old_valid = of
            df = delta.fields.get(name)
            p = pre_cols.get(name)
            if p is not None and p[0] == vt and pre[0] >= n_d:
                d_vals_dev = p[1][:n_d]
                d_valid_dev = p[2][:n_d] if p[2] is not None else None
            else:
                if df is not None:
                    d_vals = _dev_vals(vt, df[1])
                    d_valid = df[2]
                else:   # field absent from the delta: all-invalid zeros
                    d_vals = _dev_vals(vt, np.zeros(n_d,
                                                    dtype=vt.numpy_dtype()))
                    d_valid = np.zeros(n_d, dtype=bool)
                d_vals_dev = _put(d_vals)
                d_valid_dev = None if bool(d_valid.all()) \
                    else _put(d_valid)
            vals_dev = torch.cat([old_vals[:n_c], d_vals_dev])[g_dev]
            all_valid = bool(valid.all())
            db.field_all_valid[name] = all_valid
            if all_valid:
                valid_dev = None
            else:
                dev = vals_dev.device
                ov = old_valid[:n_c] if old_valid is not None \
                    else torch.ones(n_c, dtype=torch.bool, device=dev)
                dv = d_valid_dev if d_valid_dev is not None \
                    else torch.ones(n_d, dtype=torch.bool, device=dev)
                valid_dev = torch.cat([ov, dv])[g_dev]
            db.fields[name] = (vt, vals_dev, valid_dev)
        db.est_bytes = db._estimate_bytes()
        _LIVE_BATCHES.add(db)
        merged._device_batch = db
        return db


def _put(a: np.ndarray) -> torch.Tensor:
    """Host array → the scan device: staged through pinned memory and
    copied asynchronously on the current stream for a card."""
    from .kernels import to_device
    from .placement import scan_device

    a = np.ascontiguousarray(a)
    stages.count("upload_bytes", int(a.nbytes))
    dev = scan_device()
    if dev.type == "cpu":
        return to_device(a, dev)
    if not a.flags.writeable:   # torch.from_numpy wants a writable buffer
        a = a.copy()
    return torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)


class ShardedTensor:
    """One host array split over the execution mesh: `shards[i]` holds
    rows [i·r, (i+1)·r) on `mesh.devices[i]` (r = rows / mesh size)."""

    __slots__ = ("shards", "mesh")

    def __init__(self, shards: list, mesh):
        self.shards = shards
        self.mesh = mesh


def put_sharded(a: np.ndarray, mesh, spec) -> ShardedTensor:
    """Upload one host array laid out for the execution mesh: rows split
    over the shard axis per `spec` (a parallel.mesh.PartitionSpec; only
    P("shard") is supported). Chunk i goes to mesh.devices[i] in one
    non-blocking copy from pinned memory (a CPU shard shares the host
    array's memory). The mesh exec lane (ops/mesh_exec.py) stages every
    operand through here so sharded uploads book the same `upload_bytes`
    the single-device path does."""
    from ..parallel.mesh import SHARD_AXIS, mesh_size

    if tuple(spec) != (SHARD_AXIS,):
        raise ValueError(f"put_sharded splits rows over {SHARD_AXIS!r} "
                         f"only, not {spec!r}")
    d = mesh_size(mesh)
    if len(a) % d:
        raise ValueError(f"{len(a)} rows do not split over {d} shards")
    a = np.ascontiguousarray(a)
    stages.count("upload_bytes", int(a.nbytes))
    if not a.flags.writeable:   # torch.from_numpy wants a writable buffer
        a = a.copy()
    host = torch.from_numpy(a)
    if any(dev.type != "cpu" for dev in mesh.devices):
        pinned = host.pin_memory()
    r = len(a) // d
    shards = []
    for i, dev in enumerate(mesh.devices):
        if dev.type == "cpu":
            shards.append(host[i * r:(i + 1) * r])
        else:
            shards.append(pinned[i * r:(i + 1) * r].to(dev,
                                                       non_blocking=True))
    return ShardedTensor(shards, mesh)


def device_batch(batch) -> DeviceBatch:
    """Get-or-build the device twin of a ScanBatch (attached to it)."""
    db = getattr(batch, "_device_batch", None)
    if db is None:
        db = DeviceBatch(batch)
        batch._device_batch = db
    return db
