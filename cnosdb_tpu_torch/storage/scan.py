"""Scan assembly: merge memcaches + TSM files into device-ready batches.

Role-parity with the reference's read pipeline (tskv/src/reader/
iterator.rs:94-121 reader tree: SeriesReader → DataMerger → DataFilter →
Chunk/MemcacheReader), re-shaped for TPU: instead of a per-series stream
tree pulling one RecordBatch at a time, the scan materializes ONE large
columnar batch per vnode — timestamps, a series-ordinal segment array and
field columns with validity masks, already concatenated across series —
which is exactly the padded/masked layout `ops.tpu_exec` stages over PCIe.

Dedup priority on duplicate timestamps (low→high): L4..L1 files, L0 delta
files by ascending file id, immutable memcaches (oldest first), active
memcache. Within a priority, later rows win per FIELD (same rule as
memcache.materialize / compaction merge).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..models.predicate import TimeRange, TimeRanges
from ..models.schema import TskvTableSchema, ValueType
from ..utils import deadline as deadline_mod
from ..models.strcol import DictArray, as_dict_part as _as_dict_part, \
    unify_dictionaries
from .memcache import MemCache, _group_starts
from .vnode import VnodeStorage
from ..server import memory as memgov
from ..utils import lockwatch
from ..utils import stages
from . import compressed_domain


def _charge_decoded(batch):
    """Per-query accounting for one assembled vnode batch (decode-pool
    bytes): an oversized query dies here with MemoryExceeded before the
    next vnode materializes."""
    nb = batch.ts.nbytes + batch.sid_ordinal.nbytes
    for _vt, vals, valid in batch.fields.values():
        nb += int(getattr(vals, "nbytes", 0) or 0)
        nb += int(getattr(valid, "nbytes", 0) or 0)
    memgov.charge_query(nb, "decode")
    return batch


@dataclass
class ScanBatch:
    """One vnode's scan result, columnar, concatenated across series."""

    table: str
    series_ids: np.ndarray          # u64 [S]
    series_keys: list               # SeriesKey per ordinal (tags for GROUP BY)
    ts: np.ndarray                  # i64 [N]
    sid_ordinal: np.ndarray         # i32 [N] — segment id per row
    fields: dict[str, tuple[ValueType, np.ndarray, np.ndarray]] = field(default_factory=dict)
    # name → (vt, values [N], valid [N])

    @property
    def n_rows(self) -> int:
        return len(self.ts)

    @property
    def n_series(self) -> int:
        return len(self.series_ids)


def _time_mask(ts: np.ndarray, trs: TimeRanges) -> np.ndarray | None:
    if trs.is_all:
        return None
    m = np.zeros(len(ts), dtype=bool)
    for r in trs.ranges:
        m |= (ts >= r.min_ts) & (ts <= r.max_ts)
    return m


def _mem_snapshot(vnode) -> tuple[list, int]:
    """The memcaches a scan reads, oldest first, and the highest WAL seq
    it may see in them: the vnode's applied watermark, taken under its
    lock, where no apply is half done. Raft applies entries into these
    caches while a scan reads them (a restarted replica catching up):
    every chunk at or below the ceiling was whole when it was taken, and
    every chunk appended since carries a higher seq. A DeltaVnodeView
    took its ceiling when it was built. The wait for the lock is the
    stage `lock_wait_ms`."""
    if getattr(vnode, "lock", None) is None:
        return [*vnode.immutables, vnode.active], vnode.applied_seq
    with vnode.locked("lock_wait_ms", "scan"):
        return [*vnode.immutables, vnode.active], vnode.applied_seq


def _series_parts(vnode: VnodeStorage, table: str, sid: int,
                  field_names: list[str], trs: TimeRanges, mem):
    """Collect (ts, {field: (vt, vals, valid)}) parts in priority order;
    the memory caches' from the scan's _mem_snapshot `mem`."""
    caches, ceiling = mem
    parts = []
    targets = _field_targets(vnode, table, field_names)
    version = vnode.summary.version
    # files: L4..L1 then L0, ascending file_id within level ⇒ ascending priority
    for level in (4, 3, 2, 1, 0):
        fms = sorted(version.levels[level].values(), key=lambda f: f.file_id)
        for fm in fms:
            if not trs.is_all and not trs.overlaps(TimeRange(fm.min_ts, fm.max_ts)):
                continue
            r = version.reader(fm)
            cm = r.chunk(table, sid)
            if cm is None:
                continue
            ts = r.read_series_timestamps(table, sid)
            keep = version.tombstone(fm).mask_for(table, sid, ts)
            tmask = _time_mask(ts, trs)
            if keep is None and tmask is None:
                sel = None
            else:
                sel = np.ones(len(ts), dtype=bool)
                if keep is not None:
                    sel &= keep
                if tmask is not None:
                    sel &= tmask
                if not sel.any():
                    continue
            fields = {}
            maps = _chunk_maps(cm)
            for name in field_names:
                cid, cands = targets[name]
                col = _resolve_chunk_col(maps, cid, cands)
                if col is None:
                    continue
                vt = ValueType(col.pages[0].value_type)
                vals, valid = r.read_series_column(table, sid, col.name)
                if sel is not None:
                    vals, valid = vals[sel], valid[sel]
                fields[name] = (vt, vals, valid)
            parts.append(((ts[sel] if sel is not None else ts), fields))
    # memcaches: immutables old→new, then active
    for cache in caches:
        sd = cache.series.get((table, sid))
        if sd is not None:
            sd = sd.prefix(ceiling)
        if sd is None:
            continue
        ts, mfields, _ = sd.materialize()
        tmask = _time_mask(ts, trs)
        if tmask is not None:
            if not tmask.any():
                continue
            ts = ts[tmask]
        fields = {}
        for name in field_names:
            src = next((c for c in targets[name][1]
                        if c in mfields), None)
            if src is None:
                continue
            vt, vals, valid = mfields[src]
            if tmask is not None:
                vals, valid = vals[tmask], valid[tmask]
            fields[name] = (vt, vals, valid)
        parts.append((ts, fields))
    return parts


def merge_parts(parts, field_names: list[str]):
    """Merge priority-ordered parts → (ts, {field: (vt, vals, valid)})."""
    if not parts:
        return np.empty(0, dtype=np.int64), {}
    if len(parts) == 1:
        ts, fields = parts[0]
        return ts, fields
    # fast path: compacted output chunks are time-partitioned — when the
    # parts are individually strictly increasing and pairwise DISJOINT
    # after ordering by first timestamp, the merge is a concatenation
    # (no argsort, no dedup — the dominant cold-scan shape)
    nonempty = [p for p in parts if len(p[0])]
    if len(nonempty) > 1:
        ordered = sorted(nonempty, key=lambda p: int(p[0][0]))
        ok = all(bool((p[0][1:] > p[0][:-1]).all()) for p in ordered)
        if ok:
            for a, b in zip(ordered, ordered[1:]):
                if int(a[0][-1]) >= int(b[0][0]):
                    ok = False
                    break
        if ok:
            ts = np.concatenate([p[0] for p in ordered])
            out = {}
            for name in field_names:
                vt = next((f[name][0] for _, f in ordered if name in f),
                          None)
                if vt is None:
                    continue
                np_dtype = vt.numpy_dtype()
                if np_dtype is object:
                    break   # dictionary columns: generic path unifies
                vals_parts, valid_parts = [], []
                for ts_p, f in ordered:
                    if name in f:
                        vals_parts.append(f[name][1])
                        valid_parts.append(f[name][2])
                    else:
                        vals_parts.append(
                            np.zeros(len(ts_p), dtype=np_dtype))
                        valid_parts.append(
                            np.zeros(len(ts_p), dtype=bool))
                out[name] = (vt, np.concatenate(vals_parts),
                             np.concatenate(valid_parts))
            else:
                return ts, out
    ts_all = np.concatenate([p[0] for p in parts])
    total = len(ts_all)
    order = np.argsort(ts_all, kind="stable")
    ts_sorted = ts_all[order]
    group_starts = _group_starts(ts_sorted)
    uts = ts_sorted[group_starts]
    idx = np.arange(total, dtype=np.int64)
    out = {}
    for name in field_names:
        vt = None
        for _, fields in parts:
            if name in fields:
                vt = fields[name][0]
                break
        if vt is None:
            continue
        np_dtype = vt.numpy_dtype()
        is_str = np_dtype is object
        union = None
        if is_str:
            # strings merge as int32 codes under one union dictionary —
            # the dedup pick below is pure integer indexing either way
            das = {id(f): _as_dict_part(f[name][1])
                   for _, f in parts if name in f}
            union = unify_dictionaries(list(das.values()))
            vals_all = np.zeros(total, dtype=np.int32)
        else:
            vals_all = np.zeros(total, dtype=np_dtype)
        valid_all = np.zeros(total, dtype=bool)
        off = 0
        for ts_p, fields in parts:
            n = len(ts_p)
            if name in fields:
                _, vals, valid = fields[name]
                vals_all[off:off + n] = (das[id(fields)].remap_to(union)
                                         if is_str else vals)
                valid_all[off:off + n] = valid
            off += n
        vals_s = vals_all[order]
        valid_s = valid_all[order]
        score = np.where(valid_s, idx, -1)
        last_valid = np.maximum.reduceat(score, group_starts)
        valid_out = last_valid >= 0
        vals_out = vals_s[np.clip(last_valid, 0, None)]
        if is_str:
            vals_out = DictArray(vals_out, union)
        out[name] = (vt, vals_out, valid_out)
    return uts, out


# ---------------------------------------------------------------------------
# delta rescan: decode only what a ScanToken doesn't cover
# ---------------------------------------------------------------------------


class _DeltaVersion:
    """Version facade whose levels hold ONLY `new_fids`; readers,
    tombstones and paths delegate to the live Version (same caches)."""

    def __init__(self, version, new_fids: frozenset):
        self._version = version
        self.levels = [
            {fid: fm for fid, fm in lvl.items() if fid in new_fids}
            for lvl in version.levels]

    def reader(self, fm):
        return self._version.reader(fm)

    def tombstone(self, fm):
        return self._version.tombstone(fm)

    def file_path(self, fm):
        return self._version.file_path(fm)

    def all_files(self):
        out = []
        for lvl in self.levels:
            out.extend(lvl.values())
        return out


class _DeltaSummary:
    def __init__(self, version):
        self.version = version


class DeltaVnodeView:
    """Vnode facade exposing only data NEWER than a ScanToken: the TSM
    files in `new_fids` plus memcache rows with WAL seq > `after_seq`.
    scan_vnode runs against it unchanged — the result is the delta batch
    that merge_scan_batches folds into the cached snapshot. Index and
    schemas are the live ones (valid because the coordinator only takes
    this path when destructive_version matched)."""

    def __init__(self, vnode: VnodeStorage, new_fids: frozenset,
                 after_seq: int):
        self.vnode_id = vnode.vnode_id
        self.summary = _DeltaSummary(
            _DeltaVersion(vnode.summary.version, new_fids))
        self.index = vnode.index
        self.schemas = vnode.schemas
        # the ceiling before the suffix views: a chunk appended while
        # they are built lies above it (see _mem_snapshot)
        with vnode.locked("lock_wait_ms", "scan"):
            self.applied_seq = vnode.applied_seq
        act = vnode.active.suffix_view(after_seq)
        self.active = act if act is not None \
            else MemCache(vnode.vnode_id)
        self.immutables = [sv for c in list(vnode.immutables)
                           if (sv := c.suffix_view(after_seq)) is not None]


def merge_scan_batches(cached: ScanBatch, delta: ScanBatch):
    """Fold a delta decode into a cached snapshot.

    → (merged, append_gather) or None when the batches disagree on a
    field's type (schema drift the caller resolves with a full rescan).
    `append_gather` is an int64 row-gather into concat(cached, delta)
    producing the merged batch, present iff no (series, ts) pair occurs
    in both inputs — the pure-append case the device twin can replay
    with one gather per column (ops/device_cache.merged_device_batch).

    Dedup semantics match a full rescan: every delta source (a freshly
    flushed L0 file, newer memcache chunks) outranks every cached source,
    and rows the delta re-decodes after a flush carry identical values,
    so per-field latest-valid-wins over [cached, delta] is exactly the
    scan's merge rule. Output is canonical: series ids ascending (the
    index returns sorted sid arrays), ts ascending and unique per series.
    """
    n_c, n_d = cached.n_rows, delta.n_rows
    for name, (vt, _v, _m) in delta.fields.items():
        cf = cached.fields.get(name)
        if cf is not None and cf[0] != vt:
            return None
    all_sids = np.union1d(cached.series_ids, delta.series_ids)
    sid_all = np.concatenate([cached.series_ids[cached.sid_ordinal],
                              delta.series_ids[delta.sid_ordinal]])
    ts_all = np.concatenate([cached.ts, delta.ts])
    n = n_c + n_d
    # stable (ts, sid) lexsort: within a duplicate (sid, ts) group the
    # cached rows precede the delta rows, so "last valid wins" = delta
    order = np.lexsort((ts_all, sid_all))
    sid_s = sid_all[order]
    ts_s = ts_all[order]
    newgrp = np.empty(n, dtype=bool)
    newgrp[0] = True
    newgrp[1:] = (sid_s[1:] != sid_s[:-1]) | (ts_s[1:] != ts_s[:-1])
    group_starts = np.nonzero(newgrp)[0]
    pure_append = len(group_starts) == n
    uts = ts_s[group_starts]
    usid = sid_s[group_starts]
    sid_ordinal = np.searchsorted(all_sids, usid).astype(np.int32)
    idx = np.arange(n, dtype=np.int64)
    out_fields: dict = {}
    names = list(cached.fields)
    names += [nm for nm in delta.fields if nm not in cached.fields]
    for name in names:
        vt = (cached.fields.get(name) or delta.fields[name])[0]
        np_dtype = vt.numpy_dtype()
        is_str = np_dtype is object
        if is_str:
            das = [_as_dict_part(b.fields[name][1])
                   if name in b.fields else None
                   for b in (cached, delta)]
            union = unify_dictionaries([d for d in das if d is not None])
            vals_all = np.zeros(n, dtype=np.int32)
        else:
            vals_all = np.zeros(n, dtype=np_dtype)
        valid_all = np.zeros(n, dtype=bool)
        off = 0
        for bi, b in enumerate((cached, delta)):
            m = b.n_rows
            if name in b.fields:
                _vt, vals, valid = b.fields[name]
                vals_all[off:off + m] = (das[bi].remap_to(union)
                                         if is_str else vals)
                valid_all[off:off + m] = valid
            off += m
        vals_s = vals_all[order]
        valid_s = valid_all[order]
        score = np.where(valid_s, idx, -1)
        last_valid = np.maximum.reduceat(score, group_starts)
        valid_out = last_valid >= 0
        vals_out = vals_s[np.clip(last_valid, 0, None)]
        if is_str:
            vals_out = DictArray(vals_out, union)
        out_fields[name] = (vt, vals_out, valid_out)
    keymap = {int(s): k for s, k in zip(cached.series_ids,
                                        cached.series_keys)}
    keymap.update((int(s), k) for s, k in zip(delta.series_ids,
                                              delta.series_keys))
    merged = ScanBatch(cached.table, all_sids.astype(np.uint64),
                       [keymap[int(s)] for s in all_sids],
                       uts, sid_ordinal, out_fields)
    return merged, (order[group_starts] if pure_append else None)


def _field_targets(vnode: VnodeStorage, table: str,
                   field_names: list[str]) -> dict:
    """name → (column_id | None, [name, *prior_names]).

    TSM chunk columns are resolved by column id when both sides carry
    one: ids are never reused (models/schema.py), so data written under
    a renamed-away name can never conflate with a newer column that
    later took the name. The name-lineage candidates are the fallback
    for id-less chunks (flushed without a schema) and for name-keyed
    memcache rows."""
    schema = vnode.schemas.get(table)
    out = {}
    for n in field_names:
        cands = [n]
        cid = None
        if schema is not None:
            c = schema.column(n) if schema.contains_column(n) else None
            if c is not None:
                cid = c.id
                if getattr(c, "prior_names", None):
                    cands += list(c.prior_names)
        out[n] = (cid, cands)
    return out


def _chunk_maps(cm) -> tuple[dict, dict]:
    """Build one (by_id, by_name) lookup per chunk — resolve all query
    columns against it rather than re-scanning cm.columns per field."""
    by_id: dict = {}
    by_name: dict = {}
    for c in cm.columns:
        if c.column_id:
            by_id.setdefault(c.column_id, c)
        by_name.setdefault(c.name, c)
    return by_id, by_name


def _resolve_chunk_col(maps, cid, cands):
    """→ ColumnMeta for one query column inside one chunk, id-first.

    Name fallback only considers chunk columns WITHOUT an id when the
    query column's id is known — a chunk column carrying a different id
    is provably another (renamed/dropped) column, even if its name
    matches."""
    by_id, by_name = maps
    if cid is not None:
        c = by_id.get(cid)
        if c is not None:
            return c
    for nm in cands:
        c = by_name.get(nm)
        if c is not None and (cid is None or not c.column_id):
            return c
    return None


def scan_vnode(vnode: VnodeStorage, table: str,
               series_ids: np.ndarray | None = None,
               time_ranges: TimeRanges | None = None,
               field_names: list[str] | None = None,
               page_filter=None, page_constraints: dict | None = None,
               n_threads: int = 1, upload_hook=None,
               decode_hook=None, compressed_spec=None) -> ScanBatch:
    """Materialize a vnode scan into one ScanBatch.

    `page_filter` (an sql.expr tree, optional) enables predicate page
    pruning: pages whose statistics prove no row can satisfy a
    conjunct are never decoded. The resulting batch is only valid for
    queries applying that same filter — the coordinator keys its scan
    cache accordingly, and passes the constraints it already extracted
    as `page_constraints` so the tree is walked once per query, not per
    vnode. `n_threads` sizes the native decoder's pool (the coordinator
    divides the host's cores across concurrent vnode scans).
    `upload_hook`, when given, is `hook(total_rows) -> uploader`: as each
    field column finishes decoding cleanly it is handed to
    `uploader.put(...)` so device transfer overlaps the decode of the
    remaining columns (the double-buffer half of the pipeline; storage
    stays jax-free — the hook comes from ops/device_cache).
    `decode_hook`, when given, is `hook() -> DeviceDecodeLane | None`
    (ops/device_decode): pages whose codec has a device kernel stop host
    work at the byte container and decode as batched kernels on the
    accelerator — the third lane beside native pagedec and per-page
    Python.
    `compressed_spec` (storage/compressed_domain.CompressedSpec), when
    given, engages the compressed-domain lane AHEAD of the decode lanes:
    merge-free pages provably skippable/answerable from their encoded
    representation leave the plan entirely (contributions ride
    `batch.compressed_partials`), and mixed string/bool predicate pages
    decode but gather only surviving rows (late materialization). The
    batch is only valid for queries with that exact spec — the
    coordinator keys its cache accordingly.
    """
    trs = time_ranges if time_ranges is not None else TimeRanges.all()
    # before the file set is read: rows a flush moves into a file after
    # this are then read twice (and deduplicated), never missed
    mem = _mem_snapshot(vnode)
    if series_ids is None:
        file_sids = set()
        for fm in vnode.summary.version.all_files():
            r = vnode.summary.version.reader(fm)
            file_sids.update(int(s) for s in r.series_ids(table))
        series_ids = np.array(
            sorted(file_sids | _mem_series_ids(mem, table)),
            dtype=np.uint64)
    if field_names is None:
        field_names = _discover_fields(vnode, table)

    import os

    if not os.environ.get("CNOSDB_NO_NATIVE_SCAN"):
        if page_constraints is None and page_filter is not None:
            page_constraints = _page_constraints(page_filter, field_names)
        batch = _scan_vnode_native(vnode, table, series_ids, trs,
                                   field_names, page_constraints or {},
                                   n_threads, upload_hook, decode_hook,
                                   compressed_spec, mem=mem)
        if batch is not None:
            return _charge_decoded(batch)

    ts_parts, ord_parts = [], []
    fparts: dict[str, list[tuple[int, np.ndarray, np.ndarray]]] = {n: [] for n in field_names}
    ftypes: dict[str, ValueType] = {}
    keys = []
    kept_sids = []
    total = 0
    for ordinal, sid in enumerate(series_ids):
        # cooperative checkpoint: a killed/expired request stops between
        # series instead of materializing the rest of the vnode
        deadline_mod.check_current()
        sid = int(sid)
        parts = _series_parts(vnode, table, sid, field_names, trs, mem)
        ts, fields = merge_parts(parts, field_names)
        if len(ts) == 0:
            continue
        ts_parts.append(ts)
        ord_parts.append(np.full(len(ts), len(kept_sids), dtype=np.int32))
        for name in field_names:
            if name in fields:
                vt, vals, valid = fields[name]
                ftypes.setdefault(name, vt)
                fparts[name].append((total, vals, valid))
        kept_sids.append(sid)
        keys.append(vnode.index.get_series_key(sid))
        total += len(ts)

    if total == 0:
        return ScanBatch(table, np.empty(0, dtype=np.uint64), [],
                         np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int32), {})
    ts_all = np.concatenate(ts_parts)
    ord_all = np.concatenate(ord_parts)
    out_fields = {}
    for name, parts in fparts.items():
        if not parts:
            continue
        vt = ftypes[name]
        np_dtype = vt.numpy_dtype()
        if np_dtype is object:
            das = [_as_dict_part(vals) for _, vals, _ in parts]
            union = unify_dictionaries(das)
            vals_all = np.zeros(total, dtype=np.int32)
            valid_all = np.zeros(total, dtype=bool)
            for (off, vals, valid), d in zip(parts, das):
                vals_all[off:off + len(d)] = d.remap_to(union)
                valid_all[off:off + len(valid)] = valid
            out_fields[name] = (vt, DictArray(vals_all, union), valid_all)
            continue
        vals_all = np.zeros(total, dtype=np_dtype)
        valid_all = np.zeros(total, dtype=bool)
        for off, vals, valid in parts:
            vals_all[off:off + len(vals)] = vals
            valid_all[off:off + len(valid)] = valid
        out_fields[name] = (vt, vals_all, valid_all)
    return _charge_decoded(
        ScanBatch(table, np.array(kept_sids, dtype=np.uint64), keys,
                  ts_all, ord_all, out_fields))


# ---------------------------------------------------------------------------
# native batch scan: the cold-path fast lane
# ---------------------------------------------------------------------------
# Most scans hit fully-compacted vnodes: per series, a handful of chunks
# whose time ranges are provably disjoint FROM METADATA ALONE (no decode
# needed to know the merge is a concatenation). For those, the whole
# vnode's page set is planned up front — output row offsets computed from
# chunk metadata — and decoded by native/pagedec.cpp in one GIL-free
# multithreaded call per (file, column), writing straight into the final
# concatenated arrays. Series that need real merging (memcache overlap,
# tombstones, overlapping L0 chunks) fall back to the per-series Python
# path and splice into their reserved span. This replaces the role of the
# reference's reader tree (tskv/src/reader/iterator.rs:94-121) for the
# dominant compacted-read shape, with page-statistics predicate pruning
# (reference column_group/statistics.rs) applied before any byte decodes.

_NATIVE_NUMERIC = {
    int(ValueType.FLOAT): 1,      # pagedec kind: gorilla f64
    int(ValueType.INTEGER): 2,    # delta i64
    int(ValueType.UNSIGNED): 2,   # delta (u64 bit pattern rides i64)
    int(ValueType.BOOLEAN): 3,    # bitpack u8
}
_NATIVE_ENC = {1: {6}, 2: {2, 11}, 3: {10}}   # kind → decodable encodings

# Why pages miss the native pagedec fast lane, by reason — the
# observability half of the decode plane (surfaced on /metrics as
# cnosdb_decode_fallback_total{reason=...}). A hot reason is actionable:
#   string        value type has no native lane (dictionary decode)
#   value_type    numeric type pagedec doesn't cover
#   encoding      codec outside the native decoder's set
#   schema_change page typed differently than the column (cast path)
#   native_reject native decoder refused the page at runtime
#   native_unavailable  no native library and the device lane declined
#   cold_tier     page lives in the object store; the native mmap lane
#                 cannot touch it (decodes via Python over the block cache)
#   memcache_overlap  the series also has unflushed rows: its file pages
#                 merge with them on the per-series Python path
#   device_decode.*     device lane examined the page but declined
#                       (reason suffix from codecs.split_for_device)
import threading as _threading

_FALLBACK_LOCK = lockwatch.Lock("scan.fallback")
_FALLBACK: dict[str, int] = {}


def _count_fallback(reason: str, n: int = 1) -> None:
    with _FALLBACK_LOCK:
        _FALLBACK[reason] = _FALLBACK.get(reason, 0) + n


def decode_fallback_snapshot() -> dict[str, int]:
    with _FALLBACK_LOCK:
        return dict(sorted(_FALLBACK.items()))


def _count_cold_pruned(n: int) -> None:
    """Pages of a COLD file skipped by local zone-map/constraint pruning:
    each one is a page whose bytes were never downloaded."""
    from . import tiering

    stages.count("cold.pages_pruned", n)
    tiering._count_cold("prune", "pages_pruned", n)


def _mem_series_ids(mem, table: str) -> set:
    """Series ids with unflushed rows for `table` (active + immutables)
    that the scan's _mem_snapshot `mem` may see."""
    caches, ceiling = mem
    sids = set()
    for c in caches:
        # list(): raft may add a series while this reads
        sids |= {sid for (t, sid), sd in list(c.series.items())
                 if t == table and sd.seq_chunks
                 and sd.seq_chunks[0] <= ceiling}
    return sids


def _page_constraints(page_filter, field_names) -> dict:
    """Extract per-column interval conjuncts usable for page pruning.

    Walks AND nodes only; each supported conjunct (col CMP literal,
    BETWEEN, IN) contributes. Unsupported subtrees are simply ignored —
    pruning by any one conjunct is sound because a row dropped by it
    fails the whole conjunction (NULL rows fail comparisons too, and
    page stats exclude only NaNs, which satisfy no comparison).
    → {col: [("op", value) | ("between", (lo, hi)) | ("in", values)]}
    """
    import os

    from ..sql.expr import Between, BinOp, Column, InList, Like, Literal

    fields = set(field_names)
    out: dict[str, list] = {}
    ngram_on = os.environ.get("CNOSDB_NGRAM_SKIP", "1").lower() \
        not in ("0", "off", "false")

    def numeric(v):
        return isinstance(v, (int, float, np.integer, np.floating)) \
            and not isinstance(v, bool)

    def add_ngram(col, tris):
        # a subset of required trigrams only admits MORE pages — sound
        if ngram_on and tris:
            out.setdefault(col, []).append(("ngram", tris))

    def walk(e):
        if isinstance(e, BinOp):
            if e.op == "and":
                walk(e.left)
                walk(e.right)
                return
            if e.op in ("=", "!=", "<", "<=", ">", ">="):
                col = lit = op = None
                if isinstance(e.left, Column) and isinstance(e.right, Literal):
                    col, lit, op = e.left.name, e.right.value, e.op
                elif isinstance(e.right, Column) and isinstance(e.left, Literal):
                    flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
                            "=": "=", "!=": "!="}
                    col, lit, op = e.right.name, e.left.value, flip[e.op]
                if col in fields and numeric(lit):
                    out.setdefault(col, []).append((op, lit))
                elif col in fields and op == "=" and isinstance(lit, str):
                    from ..ops import strkernels

                    add_ngram(col, strkernels.value_trigrams(lit))
            return
        if isinstance(e, Like) and not e.negated \
                and isinstance(e.expr, Column) and isinstance(e.pattern, str) \
                and e.expr.name in fields:
            from ..ops import strkernels

            add_ngram(e.expr.name, strkernels.required_trigrams(e.pattern))
            return
        if isinstance(e, Between) and not e.negated \
                and isinstance(e.expr, Column) \
                and isinstance(e.low, Literal) and isinstance(e.high, Literal) \
                and e.expr.name in fields \
                and numeric(e.low.value) and numeric(e.high.value):
            out.setdefault(e.expr.name, []).append(
                ("between", (e.low.value, e.high.value)))
            return
        if isinstance(e, InList) and not e.negated \
                and isinstance(e.expr, Column) and e.expr.name in fields \
                and e.values and all(numeric(v) for v in e.values):
            out.setdefault(e.expr.name, []).append(("in", list(e.values)))
            return

    try:
        walk(page_filter)
    except Exception:
        return {}
    return out


def _page_admits(cols: dict, i: int, constraints: dict) -> bool:
    """Can page i of this chunk contain a row satisfying every constrained
    conjunct? Column absent from the chunk → all-NULL → no match."""
    for cname, cons in constraints.items():
        col = cols.get(cname)
        if col is None:
            return False
        pm = col.pages[i]
        ngram_cons = [c for c in cons if c[0] == "ngram"]
        if ngram_cons:
            # checked before the stats gate: string pages carry no
            # min/max (the `continue` below) but do carry signatures
            sig = getattr(pm, "ngram", None)
            if sig is not None:
                from ..ops import strkernels

                for _op, tris in ngram_cons:
                    if not strkernels.signature_admits(sig, tris):
                        stages.count("ngram_pages_skipped", 1)
                        strkernels.note_path("ngram_skip", "page")
                        return False
            cons = [c for c in cons if c[0] != "ngram"]
        lo, hi = pm.stat_min, pm.stat_max
        if lo is None or hi is None:
            continue   # no stats (e.g. all-null page): cannot prune
        if pm.value_type == int(ValueType.FLOAT) \
                and getattr(pm, "stats_version", 0) < 1:
            # legacy finite-only float stats: an ±inf row may lie outside
            # the recorded interval, so pruning on it could drop rows
            continue
        for op, val in cons:
            if op == ">":
                ok = hi > val
            elif op == ">=":
                ok = hi >= val
            elif op == "<":
                ok = lo < val
            elif op == "<=":
                ok = lo <= val
            elif op == "=":
                ok = lo <= val <= hi
            elif op == "!=":
                # cannot prune: page stats exclude NaN, and NaN rows DO
                # satisfy != (sql 3VL evaluates it as ~(a == b)); a
                # constant page [v..v] may still hide a matching NaN row
                ok = True
            elif op == "between":
                ok = hi >= val[0] and lo <= val[1]
            else:   # "in"
                ok = any(lo <= v <= hi for v in val)
            if not ok:
                return False
    return True


def _submit_device_page(dev_lane, r, pm, colname, out_off, vt,
                        numeric_cols, string_parts, string_valid,
                        ts_all) -> bool:
    """Try to queue one page on the device-decode lane. True = queued;
    False = the caller routes the page to a host lane, with the decline
    reason already booked on both counters (decode_fallback_snapshot's
    device_decode.* reasons and cnosdb_device_decode_total)."""
    from . import codecs as _codecs

    try:
        if colname is None:
            block, nm = r._read_page(pm), None
        else:
            block, nm = r.read_field_page_split(pm)
        plan, reason = _codecs.split_for_device(
            block, vt if colname is not None else ValueType.INTEGER)
    except Exception:
        plan, reason = None, "read_error"
    if plan is None:
        _count_fallback("device_decode." + reason)
        dev_lane.declined(reason)
        return False
    n = pm.n_rows
    token = (r, pm, colname, out_off, vt)
    if colname is None:
        dev_lane.submit(plan, token, None, ValueType.INTEGER, out_off, n,
                        None, ts_all, None)
        return True
    if vt in (ValueType.STRING, ValueType.GEOMETRY):
        parts, sv = string_parts[colname], string_valid[colname]
        values = plan["values"]

        def _sink(dense, _off=out_off, _n=n, _nm=nm, _values=values):
            if _nm is None:
                codes = dense.astype(np.int32, copy=False)
                valid_p = np.ones(_n, dtype=bool)
            else:
                codes = np.zeros(_n, dtype=np.int32)
                codes[~_nm] = dense
                valid_p = ~_nm
            parts.append((_off, DictArray(codes, _values)))
            sv[_off:_off + _n] = valid_p

        dev_lane.submit(plan, token, colname, vt, out_off, n, nm,
                        None, None, sink=_sink)
        return True
    out_vals, out_valid = numeric_cols[colname]
    dev_lane.submit(plan, token, colname, vt, out_off, n, nm,
                    out_vals, out_valid)
    return True


def _scan_vnode_native(vnode: VnodeStorage, table: str,
                       series_ids, trs: TimeRanges,
                       field_names: list[str], constraints: dict,
                       n_threads: int,
                       upload_hook=None,
                       decode_hook=None,
                       compressed_spec=None, *, mem) -> ScanBatch | None:
    from . import native

    dev_lane = decode_hook() if decode_hook is not None else None
    native_ok = native.pagedec_available()
    if not native_ok and dev_lane is None and compressed_spec is None:
        # no fast decode lane and no compressed-domain work: the simple
        # per-series fallback below is equivalent and cheaper to plan.
        # With a spec the page-level plan is still worth building — the
        # lane skips/answers pages before any decode, and survivors fall
        # through to the per-page Python jobs
        return None
    version = vnode.summary.version
    files = []
    for level in (4, 3, 2, 1, 0):
        fms = sorted(version.levels[level].values(), key=lambda f: f.file_id)
        for fm in fms:
            if not trs.is_all and not trs.overlaps(
                    TimeRange(fm.min_ts, fm.max_ts)):
                continue
            files.append((fm, version.reader(fm)))
    mem_sids = _mem_series_ids(mem, table)
    targets = _field_targets(vnode, table, field_names)

    # ---------------------------------------------------------------- plan
    # per series: ("n", sid, [(reader, chunk, cols, [page idx])], n_rows,
    #             needs_trim, pruned) or ("f", sid, ts, fields)
    plan = []
    total = 0
    any_trim = False
    any_pruned = False
    for sid in series_ids:
        sid = int(sid)
        entry = _plan_series(vnode, table, sid, files, mem_sids, trs,
                             constraints, field_names, targets, mem)
        if entry is None:
            continue
        if entry[0] == "p":   # series pruned away entirely by constraints
            any_pruned = True
            continue
        plan.append(entry)
        if entry[0] == "n":
            total += entry[3]
            any_trim = any_trim or entry[4]
            any_pruned = any_pruned or entry[5]
        else:
            total += len(entry[2])

    # --------------------------------------------- compressed-domain lane
    # lane zero: before any bytes move, pages provably skippable or
    # answerable from their encoded representation leave the plan; their
    # aggregate contributions ride the batch as pre-aggregated partials
    lane = None
    if compressed_spec is not None:
        lane = compressed_domain.ScanLane(compressed_spec, trs,
                                          vnode.index)
        with stages.stage("compressed_ms"):
            plan = lane.filter_plan(plan)
        if lane.engaged:
            any_pruned = True
            total = sum(e[3] if e[0] == "n" else len(e[2]) for e in plan)

    if total == 0:
        b = ScanBatch(table, np.empty(0, dtype=np.uint64), [],
                      np.empty(0, dtype=np.int64),
                      np.empty(0, dtype=np.int32), {})
        b._pages_pruned = any_pruned
        if lane is not None:
            lane_wants: dict[int, tuple] = {}
            lane.extend_cold_wants(lane_wants)
            for r, pms in lane_wants.values():
                r.fetch_pages(pms)
            with stages.stage("compressed_ms"):
                lane.run_jobs()
            lane.attach(b)
        return b

    # ------------------------------------------------- cold-tier prefetch
    # every page that survived pruning on a cold reader is fetched up
    # front in one coalesced ranged-GET pass, so the decode lanes below
    # hit the block cache instead of issuing a GET per page
    cold_wants: dict[int, tuple] = {}
    for entry in plan:
        if entry[0] != "n":
            continue
        for r, cm, cols, idx in entry[2]:
            if not getattr(r, "is_cold", False):
                continue
            lst = cold_wants.setdefault(id(r), (r, []))[1]
            for i in idx:
                lst.append(cm.time_pages[i])
                for name in field_names:
                    col = cols.get(name)
                    if col is not None:
                        lst.append(col.pages[i])
    if lane is not None:
        # closed-form jobs read only the pages they need (often just the
        # time page) — those ranges join the same coalesced GET pass, so
        # answered pages' VALUE bytes are never downloaded
        lane.extend_cold_wants(cold_wants)
    for r, pms in cold_wants.values():
        r.fetch_pages(pms)
    if lane is not None and lane.jobs:
        with stages.stage("compressed_ms"):
            lane.run_jobs()

    # ------------------------------------------------------- column typing
    ftypes: dict[str, ValueType] = {}
    for entry in plan:
        if entry[0] == "n":
            for _r, _cm, cols, _idx in entry[2]:
                for name, col in cols.items():
                    if name in field_names and name not in ftypes \
                            and col.pages:
                        ftypes[name] = ValueType(col.pages[0].value_type)
        else:
            for name, (vt, _v, _m) in entry[3].items():
                ftypes.setdefault(name, vt)

    # ----------------------------------------------------------- allocate
    ts_all = np.empty(total, dtype=np.int64)
    numeric_cols: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    string_parts: dict[str, list] = {}
    string_valid: dict[str, np.ndarray] = {}
    for name, vt in ftypes.items():
        if vt in (ValueType.STRING, ValueType.GEOMETRY):
            string_parts[name] = []
            string_valid[name] = np.zeros(total, dtype=bool)
            continue
        dt = vt.numpy_dtype()
        numeric_cols[name] = (np.zeros(total, dtype=dt),
                              np.zeros(total, dtype=bool))

    # ------------------------------------------- descriptors per (file, col)
    # groups[id(reader)] = {"base": u8 view, "cols": {key: (desc, jobs)}}
    # key None = time column
    groups: dict[int, dict] = {}
    py_jobs: list = []   # (reader, pm, colname|None, out_off, vt)

    def _group(r):
        g = groups.get(id(r))
        if g is None:
            g = groups[id(r)] = {"base": r.buffer_array(), "cols": {},
                                 "reader": r}
        return g

    def _add_page(r, pm, colname, out_off, kind):
        g = _group(r)
        lst = g["cols"].setdefault(colname, ([], []))
        lst[0].append((pm.offset, pm.size, out_off, pm.n_rows, kind,
                       pm.n_values))
        lst[1].append((pm, out_off))

    kept_sids: list[int] = []
    keys = []
    counts: list[int] = []
    fallback_writes = []   # (entry, base_off)
    bytes_materialized = 0   # page bytes routed into ANY decode lane
    off = 0
    for entry in plan:
        if entry[0] == "f":
            _tag, sid, ts, fields = entry
            n = len(ts)
            fallback_writes.append((entry, off))
            kept_sids.append(sid)
            keys.append(vnode.index.get_series_key(sid))
            counts.append(n)
            off += n
            continue
        _tag, sid, chunks, n_rows, _trim, _pruned = entry
        kept_sids.append(sid)
        keys.append(vnode.index.get_series_key(sid))
        counts.append(n_rows)
        for r, cm, cols, idx in chunks:
            for i in idx:
                tp = cm.time_pages[i]
                if not (dev_lane is not None
                        and dev_lane.accepts(int(ValueType.INTEGER),
                                             tp.encoding)
                        and _submit_device_page(
                            dev_lane, r, tp, None, off, ValueType.INTEGER,
                            numeric_cols, string_parts, string_valid,
                            ts_all)):
                    if native_ok and not getattr(r, "is_cold", False):
                        _add_page(r, tp, None, off, 0)
                    else:
                        py_jobs.append((r, tp, None, off, None))
                for name in field_names:
                    col = cols.get(name)
                    if col is None:
                        continue   # absent column: stays zero/invalid
                    pm = col.pages[i]
                    vt = ftypes.get(name)
                    if dev_lane is not None and pm.value_type == int(vt) \
                            and (vt in (ValueType.STRING,
                                        ValueType.GEOMETRY)
                                 or dev_lane.accepts(pm.value_type,
                                                     pm.encoding)) \
                            and _submit_device_page(
                                dev_lane, r, pm, name, off, vt,
                                numeric_cols, string_parts, string_valid,
                                ts_all):
                        continue
                    if vt in (ValueType.STRING, ValueType.GEOMETRY):
                        _count_fallback("string")
                        py_jobs.append((r, pm, name, off, vt))
                        continue
                    if not native_ok:
                        # device lane declined and there is no native
                        # decoder in this build: per-page Python path
                        _count_fallback("native_unavailable")
                        py_jobs.append((r, pm, name, off, vt))
                        continue
                    if getattr(r, "is_cold", False):
                        # the native writer reads pages out of a local
                        # mmap (buffer_array) — cold pages have no local
                        # bytes, so they decode via the Python lane over
                        # the block cache
                        _count_fallback("cold_tier")
                        py_jobs.append((r, pm, name, off, vt))
                        continue
                    kind = _NATIVE_NUMERIC.get(pm.value_type)
                    if kind is None or pm.encoding not in _NATIVE_ENC[kind] \
                            or pm.value_type != int(vt):
                        # the last case: schema evolution changed the
                        # column's type between chunks — the output array
                        # is typed by ftypes, so a differently-typed page
                        # must go through the casting Python path, never
                        # the width-blind native writer
                        _count_fallback(
                            "value_type" if kind is None else
                            "encoding" if pm.encoding not in _NATIVE_ENC[kind]
                            else "schema_change")
                        py_jobs.append((r, pm, name, off, vt))
                        continue
                    _add_page(r, pm, name, off, kind)
                bytes_materialized += tp.size + sum(
                    cols[name].pages[i].size for name in field_names
                    if name in cols)
                if lane is not None:
                    lane.apply_page_masks(cm, i, off, total)
                off += tp.n_rows

    # ------------------------------------------------------ device decode
    # the third lane runs BEFORE the native tasks: device writebacks land
    # in the shared output arrays first, so a column split between lanes
    # is already complete when _finish's eager upload sees it, and kernel
    # failures join py_jobs before dirty_cols is computed
    if dev_lane is not None and dev_lane.pending():
        with stages.stage("device_decode_ms"):
            py_jobs.extend(dev_lane.run())

    # ------------------------------------------------------- native decode
    # one task per (file, column): pages of one column across files write
    # DISJOINT row ranges of the same output array, so tasks run
    # concurrently on the shared decode pool. Eager upload: once every
    # task of a column has finished cleanly, its final array is handed to
    # the uploader while the remaining columns still decode (decode N+1
    # overlaps device_put of N — device_put enqueues are async).
    tasks = []
    col_remaining: dict[str, int] = {}
    for g in groups.values():
        for colname, (desc_list, jobs) in g["cols"].items():
            desc = np.array(desc_list, dtype=np.int64).reshape(-1, 6)
            if colname is None:
                out_vals, out_valid = ts_all, None
            else:
                out_vals, out_valid = numeric_cols[colname]
                col_remaining[colname] = col_remaining.get(colname, 0) + 1
            tasks.append((g, colname, desc, out_vals, out_valid, jobs))

    uploader = None
    if upload_hook is not None and not fallback_writes \
            and not (any_trim and not trs.is_all) \
            and (lane is None or not lane.has_masks):
        # fallback series splice into every column after decode, a time
        # trim re-slices the arrays, and compressed-domain survivor masks
        # gather a subset — all would invalidate an eagerly shipped copy,
        # so only clean scans pipeline uploads
        uploader = upload_hook(total)
    dirty_cols = {j[2] for j in py_jobs}
    if uploader is not None and dev_lane is not None:
        # columns whose every page decoded on-device attach as device
        # arrays — decoded values never re-cross the PCIe pipe
        dev_lane.attach_device_columns(uploader, total)

    def _run(task):
        g, _colname, desc, out_vals, out_valid, _jobs = task
        return native.decode_pages(g["base"], desc, out_vals, out_valid,
                                   n_threads=per_task_threads)

    def _finish(task, status) -> bool:
        """Fold one task's result back in (main thread); False = abort."""
        g, colname, _desc, _ov, _om, jobs = task
        if status is None:
            return False   # library vanished mid-flight: legacy path
        for bi in np.nonzero(status)[0]:
            pm, out_off = jobs[bi]
            _count_fallback("native_reject")
            py_jobs.append((g["reader"], pm, colname, out_off,
                            ftypes.get(colname)))
            dirty_cols.add(colname)
        if colname is None:
            return True
        col_remaining[colname] -= 1
        if uploader is not None and col_remaining[colname] == 0 \
                and colname not in dirty_cols:
            vals, valid = numeric_cols[colname]
            uploader.put(colname, ftypes[colname], vals, valid)
        return True

    if len(tasks) > 1:
        from concurrent.futures import as_completed

        from ..utils.executor import submit as _submit

        per_task_threads = 1 if len(tasks) >= n_threads \
            else max(1, n_threads // len(tasks))
        futs = {_submit("decode", _run, t): t for t in tasks}
        aborted = False
        for f in as_completed(futs):
            if not _finish(futs[f], f.result()):
                aborted = True
        if aborted:
            return None
    else:
        per_task_threads = n_threads
        for t in tasks:
            if not _finish(t, _run(t)):
                return None

    # ------------------------------------------------ python page fallbacks
    for r, pm, colname, out_off, vt in py_jobs:
        deadline_mod.check_current()
        n = pm.n_rows
        if colname is None:
            ts_all[out_off:out_off + n] = r.read_time_page(pm)
            continue
        dense, nm = r.read_field_page(pm)
        if vt in (ValueType.STRING, ValueType.GEOMETRY):
            da = _as_dict_part(dense)
            if nm is None:
                codes = da.codes.astype(np.int32)
                valid_p = np.ones(n, dtype=bool)
            else:
                codes = np.zeros(n, dtype=np.int32)
                codes[~nm] = da.codes
                valid_p = ~nm
            string_parts[colname].append(
                (out_off, DictArray(codes, da.values)))
            string_valid[colname][out_off:out_off + n] = valid_p
            continue
        vals, valid = numeric_cols[colname]
        if nm is None:
            vals[out_off:out_off + n] = dense
            valid[out_off:out_off + n] = True
        else:
            vals[out_off:out_off + n][~nm] = dense
            valid[out_off:out_off + n] = ~nm

    # ------------------------------------------------ fallback series write
    for entry, base_off in fallback_writes:
        _tag, sid, ts, fields = entry
        n = len(ts)
        ts_all[base_off:base_off + n] = ts
        for name, (vt, vals_p, valid_p) in fields.items():
            if name not in ftypes:
                continue
            if vt in (ValueType.STRING, ValueType.GEOMETRY):
                da = _as_dict_part(vals_p)
                string_parts[name].append(
                    (base_off, DictArray(da.codes.astype(np.int32),
                                         da.values)))
                string_valid[name][base_off:base_off + n] = valid_p
            else:
                vals, valid = numeric_cols[name]
                vals[base_off:base_off + n] = vals_p
                valid[base_off:base_off + n] = valid_p

    sid_ordinal = np.repeat(
        np.arange(len(kept_sids), dtype=np.int32),
        np.asarray(counts, dtype=np.int64))

    # --------------------------------------------------- assemble + trim
    out_fields: dict = {}
    for name, (vals, valid) in numeric_cols.items():
        out_fields[name] = (ftypes[name], vals, valid)
    for name, parts in string_parts.items():
        das = [p[1] for p in parts]
        union = unify_dictionaries(das) if das else np.array([""],
                                                            dtype=object)
        codes_all = np.zeros(total, dtype=np.int32)
        for (p_off, da), d in zip(parts, das):
            codes_all[p_off:p_off + len(da.codes)] = d.remap_to(union)
        out_fields[name] = (ftypes[name], DictArray(codes_all, union),
                            string_valid[name])

    row_mask = lane.row_mask if lane is not None else None
    if (any_trim and not trs.is_all) or row_mask is not None:
        keep = _time_mask(ts_all, trs) if (any_trim and not trs.is_all) \
            else None
        if row_mask is not None:
            # late materialization: only rows surviving every
            # compressed-domain predicate mask are gathered
            keep = row_mask if keep is None else (keep & row_mask)
        if keep is not None and not keep.all():
            ts_all = ts_all[keep]
            sid_ordinal = sid_ordinal[keep]
            out_fields = {
                name: (vt,
                       (DictArray(v.codes[keep], v.values)
                        if isinstance(v, DictArray) else v[keep]),
                       m[keep])
                for name, (vt, v, m) in out_fields.items()}
            # drop series trimmed to zero rows and renumber ordinals
            pres = np.bincount(sid_ordinal, minlength=len(kept_sids))
            if (pres == 0).any():
                keep_s = np.nonzero(pres > 0)[0]
                remap = np.full(len(kept_sids), -1, dtype=np.int32)
                remap[keep_s] = np.arange(len(keep_s), dtype=np.int32)
                sid_ordinal = remap[sid_ordinal]
                kept_sids = [kept_sids[i] for i in keep_s]
                keys = [keys[i] for i in keep_s]

    b = ScanBatch(table, np.array(kept_sids, dtype=np.uint64), keys,
                  ts_all, sid_ordinal, out_fields)
    b._pages_pruned = any_pruned
    if lane is not None:
        bytes_materialized += lane.bytes_materialized
        lane.attach(b)
    if bytes_materialized:
        stages.count("compressed.bytes_materialized", bytes_materialized)
    if uploader is not None:
        uploader.attach(b)
    return b


def _plan_series(vnode, table, sid, files, mem_sids, trs, constraints,
                 field_names, targets, mem):
    """→ ("n", sid, [(reader, chunk, cols, admitted idx)], n_rows, trim,
    pruned) | ("f", sid, ts, fields) | ("p",) (rows existed but every
    page was constraint-pruned) | None (no rows). `cols` maps QUERY
    column names to each chunk's ColumnMeta (id-resolved — see
    _resolve_chunk_col), so constraint pruning and page decode stay
    correct across RENAME COLUMN."""
    fallback = sid in mem_sids
    if fallback:
        overlap = sum(len(cm.time_pages) for _fm, r in files
                      if (cm := r.chunk(table, sid)) is not None)
        if overlap:
            _count_fallback("memcache_overlap", overlap)
    chunks = []
    if not fallback:
        version = vnode.summary.version
        for fm, r in files:
            cm = r.chunk(table, sid)
            if cm is None:
                continue
            tb = version.tombstone(fm)
            if not tb.is_empty and any(
                    e.matches_series(table, sid) for e in tb.entries):
                fallback = True
                break
            chunks.append((r, cm))
    if not fallback and len(chunks) > 1:
        chunks.sort(key=lambda rc: rc[1].min_ts)
        for (_ra, a), (_rb, b) in zip(chunks, chunks[1:]):
            if a.max_ts >= b.min_ts:
                fallback = True
                break
    if not fallback:
        for _r, cm in chunks:
            P = len(cm.time_pages)
            if any(len(c.pages) != P
                   or any(cp.n_rows != tp.n_rows for cp, tp
                          in zip(c.pages, cm.time_pages))
                   for c in cm.columns):
                fallback = True   # misaligned pages (defensive)
                break
    if fallback:
        parts = _series_parts(vnode, table, sid, field_names, trs, mem)
        ts, fields = merge_parts(parts, field_names)
        if len(ts) == 0:
            return None
        return ("f", sid, ts, fields)
    admitted = []
    n_rows = 0
    trim = False
    pruned = False
    time_admitted = 0
    for r, cm in chunks:
        cols = {}
        maps = _chunk_maps(cm)
        for qname in field_names:
            cid, cands = targets[qname]
            c = _resolve_chunk_col(maps, cid, cands)
            if c is not None:
                cols[qname] = c
        idx = []
        cold = getattr(r, "is_cold", False)
        cold_pruned = 0
        for i, tp in enumerate(cm.time_pages):
            if not trs.is_all and not trs.overlaps(
                    TimeRange(tp.min_ts, tp.max_ts)):
                if cold:
                    cold_pruned += 1
                continue
            time_admitted += 1
            if constraints and not _page_admits(cols, i, constraints):
                pruned = True
                if cold:
                    cold_pruned += 1
                continue
            idx.append(i)
            n_rows += tp.n_rows
            # a page fully inside ONE range needs no row-level trim (all
            # its rows pass); anything else trims conservatively
            if not trs.is_all and not any(
                    r0.min_ts <= tp.min_ts and tp.max_ts <= r0.max_ts
                    for r0 in trs.ranges):
                trim = True
        if cold_pruned:
            _count_cold_pruned(cold_pruned)
        if idx:
            admitted.append((r, cm, cols, idx))
    if n_rows == 0:
        return ("p",) if pruned and time_admitted else None
    return ("n", sid, admitted, n_rows, trim, pruned)


def _discover_fields(vnode: VnodeStorage, table: str) -> list[str]:
    names: set[str] = set()
    schema = vnode.schemas.get(table)
    if schema is not None:
        return schema.field_names()
    for fm in vnode.summary.version.all_files():
        r = vnode.summary.version.reader(fm)
        g = r.groups.get(table)
        if g:
            for cm in g.chunks.values():
                names.update(c.name for c in cm.columns)
    for cache in [vnode.active, *vnode.immutables]:
        # list(): raft may add a series or a field while this reads
        for (t, sid), sd in list(cache.series.items()):
            if t == table:
                names.update(list(sd.field_chunks))
    return sorted(names)
