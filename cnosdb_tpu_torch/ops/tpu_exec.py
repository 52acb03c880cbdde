"""TpuExec: the device scan-aggregate physical operator.

This is the rebuild's `TpuTableProvider`/`TpuExec` (north star in
BASELINE.json): the counterpart of the reference's TskvExec +
AggregateFilterTskvExec + DataFusion partial AggregateExec
(query_server/query/src/extension/physical/plan_node/tskv_exec.rs:36,
aggregate_filter_scan.rs:27), collapsed into one fused device program per
scanned column:

    host: ScanBatch (from storage.scan) → bucket i32 / group i32 / rank i32
    device: filter mask → segment ids → masked segment reductions
    host: segment labels (tag values, bucket starts) + presence masking

Group-by cardinality maps to segments = group × time-bucket; dense bucket
ranges index directly, sparse ones remap through np.unique.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..models.schema import ValueType
from ..models.strcol import DictArray
from ..storage.scan import ScanBatch
from ..sql.expr import Expr
from ..utils import deadline as _deadline
from . import kernels

_DENSE_BUCKET_LIMIT = 1 << 21

# Guards the per-batch derived caches (_seg_cache / _partials) hanging off
# SHARED scan-cache-resident batches: concurrent queries over one cached
# snapshot race the get-or-create, the eviction pop and the read-modify-
# write memo merge. One process-wide lock — the guarded sections are dict
# bookkeeping only (no kernel work), so contention is negligible.
import threading as _threading
from ..utils import lockwatch

_BATCH_CACHE_LOCK = lockwatch.Lock("tpu_exec.batch_cache")

# process-wide memo observability (satellite of the materialized-rollup
# plane: view-vs-memo hit rates must be comparable on /metrics). Counters
# and the live-batch set share _BATCH_CACHE_LOCK with the memo itself —
# every touch point already holds or takes that lock once.
_MEMO_COUNTERS = {"hit": 0, "miss": 0, "evict": 0}
import weakref as _weakref

# id(batch) → batch, weakly held (ScanBatch is an eq dataclass, so not
# hashable — keyed by identity; entries vanish with their batch)
_memo_batches: "_weakref.WeakValueDictionary" = _weakref.WeakValueDictionary()


def _memo_count(kind: str, n: int = 1) -> None:
    with _BATCH_CACHE_LOCK:
        _MEMO_COUNTERS[kind] = _MEMO_COUNTERS.get(kind, 0) + n


def memo_counters_snapshot() -> dict:
    with _BATCH_CACHE_LOCK:
        return dict(_MEMO_COUNTERS)


def memo_bytes() -> int:
    """Resident bytes across every live batch's partial-agg memo."""
    total = 0
    with _BATCH_CACHE_LOCK:
        batches = list(_memo_batches.values())
    for b in batches:
        partials = getattr(b, "_partials", None)
        if not partials:
            continue
        for part in list(partials.values()):
            for v in part.values():
                nb = getattr(v, "nbytes", None)
                if nb is not None:
                    total += int(nb)
    return total


def memo_clear(target_bytes: int = 0) -> int:
    """Broker reclaim: drop partial-agg memos (pure caches — a cleared
    memo recomputes on next touch). target_bytes=0 clears everything."""
    freed = 0
    with _BATCH_CACHE_LOCK:
        batches = list(_memo_batches.values())
    for b in batches:
        if target_bytes and freed >= target_bytes:
            break
        partials = getattr(b, "_partials", None)
        if not partials:
            continue
        with _BATCH_CACHE_LOCK:
            n = 0
            for part in list(partials.values()):
                for v in part.values():
                    nb = getattr(v, "nbytes", None)
                    if nb is not None:
                        n += int(nb)
            evicted = len(partials)
            partials.clear()
            _MEMO_COUNTERS["evict"] = \
                _MEMO_COUNTERS.get("evict", 0) + evicted
        freed += n
    return freed


def _register_memo_pool() -> None:
    from ..server import memory as _memory

    _memory.register_pool("agg_memo",
                          usage_fn=memo_bytes,
                          reclaim=memo_clear)


_register_memo_pool()


def _FORCE_DEVICE() -> bool:
    import os

    return os.environ.get("CNOSDB_TPU_FORCE_DEVICE_PATH", "0") == "1"


@dataclass
class AggSpec:
    func: str               # count/count_star/sum/mean/min/max/first/last
    column: str | None      # None for count(*)
    alias: str
    param: object = None    # extra constant arg (e.g. sample size k)

    _NEEDS = {
        "count": {"want_count": True},
        "sum": {"want_sum": True},
        "mean": {"want_sum": True, "want_count": True},
        "avg": {"want_sum": True, "want_count": True},
        "min": {"want_min": True},
        "max": {"want_max": True},
        "first": {"want_first": True},
        "last": {"want_last": True},
    }


@dataclass
class TpuQuery:
    filter: Expr | None = None
    # native-kernel thread budget per batch (0 = all cores); the executor
    # divides cores across concurrently-launched vnode batches so 8 pool
    # workers don't each spawn a full-width native pool (oversubscription
    # was the round-4 cold kernel bottleneck)
    kernel_threads: int = 0
    group_tags: list[str] = field(default_factory=list)
    # GROUP BY on STRING field columns: their dictionary codes extend the
    # segment id directly (group = tags × field-codes × bucket) — the
    # hits-style string group-by runs the same integer kernels as tags,
    # never the row-materializing relational fallback
    group_fields: list[str] = field(default_factory=list)
    time_bucket: tuple[int, int] | None = None   # (origin_ns, interval_ns)
    aggs: list[AggSpec] = field(default_factory=list)


@dataclass
class AggResult:
    """Columnar result: group label columns then one column per agg."""

    columns: dict[str, np.ndarray]
    n_rows: int
    # per-column validity (NULL where a group had no values for that agg)
    valid: dict[str, np.ndarray] = field(default_factory=dict)
    # tag-group identity for the VECTORIZED cross-vnode merge: per-row
    # local group index + the label table it indexes (None when string
    # field group axes are present — those merge via the generic path)
    gid: np.ndarray | None = None
    labels: list | None = None


def execute_scan_aggregate(batch: ScanBatch, query: TpuQuery) -> AggResult:
    return finish_scan_aggregate(launch_scan_aggregate(batch, query))


def finish_scan_aggregate(job) -> AggResult:
    """Complete a launched job: fetch device partials (one transfer) and
    assemble the result table."""
    if isinstance(job, AggResult):
        return job
    return job()


def _tag_group_layout(batch: ScanBatch, group_tags: list[str]):
    """series → tag-group mapping. → (group_of_series i32 [n_series],
    group_labels [tag tuples], n_groups)."""
    if group_tags:
        label_of_series = []
        group_map: dict[tuple, int] = {}
        for key in batch.series_keys:
            tags = key.tag_dict() if key is not None else {}
            label = tuple(tags.get(t) for t in group_tags)
            gid = group_map.setdefault(label, len(group_map))
            label_of_series.append(gid)
        group_of_series = np.array(label_of_series, dtype=np.int32)
        group_labels = [None] * len(group_map)
        for label, gid in group_map.items():
            group_labels[gid] = label
        return group_of_series, group_labels, len(group_map)
    return np.zeros(batch.n_series, dtype=np.int32), [()], 1


def _gf_layout(batch: ScanBatch, group_fields: list[str], n: int):
    """GROUP BY field axes: per field the dictionary-code axis (+1 slot
    for the NULL group key). Factorizations are immutable per scan
    snapshot and cached on the batch (numeric np.unique at 10M rows costs
    ~100s of ms per query) — the ScanToken-persistent half of the key
    factorization plane. → (gf_dims, gf_dicts, gf_codes)."""
    gf_dims: list[int] = []
    gf_dicts: list[np.ndarray] = []
    gf_codes: list[np.ndarray] = []
    gf_cache = getattr(batch, "_gf_cache", None)
    if gf_cache is None and group_fields:
        gf_cache = batch._gf_cache = {}
    for fcol in group_fields:
        hit = gf_cache.get(fcol)
        if hit is not None:
            dim, dic, codes = hit
            gf_dims.append(dim)
            gf_dicts.append(dic)
            gf_codes.append(codes)
            continue
        # bound sized to the query: evicting below the current key-set
        # would thrash every repeat of a multi-field GROUP BY
        gf_bound = max(2, len(group_fields))
        f = batch.fields.get(fcol)
        if f is None:  # column absent in this vnode: every row groups NULL
            while len(gf_cache) >= gf_bound:
                gf_cache.pop(next(iter(gf_cache)))
            gf_cache[fcol] = (1, np.empty(0, dtype=object),
                              np.zeros(n, dtype=np.int64))
            gf_dims.append(1)
            gf_dicts.append(np.empty(0, dtype=object))
            gf_codes.append(np.zeros(n, dtype=np.int64))
            continue
        _vt, vals, valid = f
        from ..utils import stages as _stages

        with _stages.stage("factorize_ms"):
            if _vt in (ValueType.STRING, ValueType.GEOMETRY):
                da = vals if isinstance(vals, DictArray) \
                    else DictArray.from_objects(vals)
                u = len(da.values)
                codes = da.codes.astype(np.int64)
                dic = da.values
            else:
                # numeric group keys factorize per batch (np.unique
                # collapses NaNs to one group, matching DataFusion)
                arr = np.asarray(vals)
                if _vt == ValueType.BOOLEAN:
                    arr = arr.astype(np.int64)
                uniq, inv = np.unique(arr, return_inverse=True)
                u = len(uniq)
                codes = inv.astype(np.int64)
                dic = uniq.astype(object)
                if _vt == ValueType.BOOLEAN:
                    dic = np.array([bool(x) for x in uniq], dtype=object)
            if not bool(valid.all()):
                codes = np.where(valid, codes, u)
        while len(gf_cache) >= gf_bound:
            gf_cache.pop(next(iter(gf_cache)))
        gf_cache[fcol] = (u + 1, dic, codes)
        gf_dims.append(u + 1)
        gf_dicts.append(dic)
        gf_codes.append(codes)
    return gf_dims, gf_dicts, gf_codes


def _bucket_geometry(batch: ScanBatch, time_bucket):
    """→ (ts_lo, ts_hi, origin, interval, bmin, dense_span); min/max are
    immutable per scan snapshot and cached (a 100M-row i64 min+max costs
    ~150ms — pure waste on every repeated query)."""
    mm = getattr(batch, "_ts_minmax", None)
    if mm is None:
        mm = batch._ts_minmax = (int(batch.ts.min()), int(batch.ts.max()))
    ts_lo, ts_hi = mm
    if time_bucket is not None:
        origin, interval = time_bucket
        bmin = (ts_lo - origin) // interval
        bmax = (ts_hi - origin) // interval
        return ts_lo, ts_hi, origin, interval, bmin, int(bmax - bmin + 1)
    return ts_lo, ts_hi, 0, 0, 0, 1


def _seg_layout(batch: ScanBatch, group_tags, group_fields, group_of_series,
                gf_dims, gf_codes, origin, interval, bmin, dense_span,
                cpu_mode: bool):
    """Per-row combined (tag × field × bucket) segment ids, cached on the
    batch under the same key the kernel path uses — one derivation serves
    both the segment kernels and the host distinct/collect merges.
    → (seg_ids, bucket_starts, n_buckets, seg_cache, seg_key)."""
    from ..utils import stages as _stages

    n = batch.n_rows
    seg_key = (tuple(group_tags), tuple(group_fields),
               origin, interval, bmin, dense_span)
    with _BATCH_CACHE_LOCK:
        seg_cache = getattr(batch, "_seg_cache", None)
        if seg_cache is None:
            seg_cache = batch._seg_cache = {}
        cached = seg_cache.get(seg_key)
    if cached is not None:
        _stages.count("kernel_cache.hit")
        seg_ids, bucket_starts, n_buckets = cached[:3]
        return seg_ids, bucket_starts, n_buckets, seg_cache, seg_key
    _stages.count("kernel_cache.miss")
    group_of_row = group_of_series[batch.sid_ordinal]
    if gf_dims:
        group_of_row = group_of_row.astype(np.int64)
        for dim, codes in zip(gf_dims, gf_codes):
            group_of_row = group_of_row * dim + codes
    if interval:
        b = (batch.ts - origin) // interval
        if dense_span <= _DENSE_BUCKET_LIMIT:
            bucket_ids = (b - bmin).astype(np.int32)
            bucket_starts = origin + (bmin + np.arange(
                dense_span, dtype=np.int64)) * interval
            n_buckets = dense_span
        else:
            uniq, inv = np.unique(b, return_inverse=True)
            bucket_ids = inv.astype(np.int32)
            bucket_starts = origin + uniq * interval
            n_buckets = len(uniq)
    else:
        bucket_ids = np.zeros(n, dtype=np.int32)
        bucket_starts = None
        n_buckets = 1
    # i64 on the numpy path: bincount would otherwise re-cast an
    # i32 key array to intp on EVERY call (a 40ms copy at 10M rows)
    seg_dtype = np.int64 if cpu_mode else np.int32
    seg_ids = (group_of_row.astype(np.int64) * n_buckets
               + bucket_ids.astype(np.int64)).astype(seg_dtype)
    # small LRU with eviction. NOTE this derived-cache memory rides
    # the batch outside the MemoryPool's admission accounting, so
    # the bound is deliberately tight: ≤2 shapes ≈ 2×8B/row plus
    # run layout + rank/order ≈ 8B/row — ~24B/row worst case on a
    # scan-cache-resident batch
    with _BATCH_CACHE_LOCK:
        while len(seg_cache) >= 2:
            seg_cache.pop(next(iter(seg_cache)))
        # slots: seg_ids, bucket_starts, n_buckets, counts,
        #        run_starts, run_counts (runs built lazily)
        seg_cache[seg_key] = [seg_ids, bucket_starts, n_buckets,
                              None, None, None]
    return seg_ids, bucket_starts, n_buckets, seg_cache, seg_key


@dataclass
class HostGroupLayout:
    """Decoded group/segment layout for host-side merges (_merge_distinct
    in sql/executor.py): per-row combined segment ids plus the tables
    that decode a segment back to its (tag tuple, field values, bucket
    start) group key. Built from the same per-batch caches the kernel
    path populates, so a warm rescan pays nothing."""

    seg_ids: np.ndarray
    num_segments: int
    n_buckets: int
    bucket_starts: np.ndarray | None
    group_labels: list
    gf_dims: list
    gf_dicts: list
    gf_codes: list


def host_group_layout(batch: ScanBatch, group_tags: list[str],
                      group_fields: list[str],
                      time_bucket) -> HostGroupLayout | None:
    """Segment layout for host-side distinct/collect merges, sharing the
    ScanToken-persistent _gf_cache/_seg_cache with launch_scan_aggregate
    (identical cache keys — whichever path runs first seeds the other)."""
    n = batch.n_rows
    if n == 0:
        return None
    group_of_series, group_labels, n_groups = _tag_group_layout(
        batch, group_tags)
    gf_dims, gf_dicts, gf_codes = _gf_layout(batch, group_fields, n)
    for d in gf_dims:
        n_groups *= d
    _lo, _hi, origin, interval, bmin, dense_span = _bucket_geometry(
        batch, time_bucket)
    from .placement import scan_device

    cpu_mode = scan_device().type == "cpu" and not _FORCE_DEVICE()
    seg_ids, bucket_starts, n_buckets, _, _ = _seg_layout(
        batch, group_tags, group_fields, group_of_series, gf_dims,
        gf_codes, origin, interval, bmin, dense_span, cpu_mode)
    return HostGroupLayout(
        seg_ids=seg_ids, num_segments=n_groups * n_buckets,
        n_buckets=n_buckets, bucket_starts=bucket_starts,
        group_labels=group_labels, gf_dims=gf_dims, gf_dicts=gf_dicts,
        gf_codes=gf_codes)


def host_row_mask(batch: ScanBatch, flt) -> np.ndarray | None:
    """Filter-passing row mask with the exact semantics of the host scan
    path below (three-valued logic, missing-column handling, conjunctive
    per-column NULL masking) — shared with the mesh exec lane
    (ops/mesh_exec.py) so sharded and single-device answers agree on the
    same row set. None means no filter (every row participates)."""
    if flt is None:
        return None
    n = batch.n_rows
    env = _filter_env(batch, needed=flt.columns())
    has_is_null = _contains_is_null(flt)
    missing = [c for c in flt.columns() if c not in env]
    if missing and not has_is_null:
        # a schema column with no data in this vnode is all-NULL here:
        # any comparison on it matches nothing
        return np.zeros(n, dtype=bool)
    for c in missing:  # IS NULL paths need the env entries
        env[c] = np.zeros(n)
        env[f"__valid__:{c}"] = np.zeros(n, dtype=bool)
    row_mask = np.asarray(flt.eval(env, np), dtype=bool)
    if row_mask.shape == ():  # constant predicate
        row_mask = np.full(n, bool(row_mask))
    if is_conjunctive(flt):
        skip = is_null_columns(flt) if has_is_null else set()
        av_cache = getattr(batch, "_allvalid_cache", None)
        if av_cache is None:
            av_cache = batch._allvalid_cache = {}
        for cname in flt.columns() - skip:
            f = batch.fields.get(cname)
            if f is None:
                continue
            hit = av_cache.get(cname)
            if hit is None:
                hit = av_cache[cname] = bool(f[2].all())
            if not hit:
                row_mask &= f[2]
    return row_mask


def launch_scan_aggregate(batch: ScanBatch, query: TpuQuery):
    """Start a scan-aggregate; device kernels are dispatched asynchronously
    so a coordinator can launch every vnode's kernel before fetching any
    result (device→host pulls carry fixed relay latency)."""
    n = batch.n_rows
    if n == 0:
        names = query.group_tags + query.group_fields \
            + (["time"] if query.time_bucket else []) \
            + [a.alias for a in query.aggs]
        return AggResult({nm: np.empty(0) for nm in names}, 0)

    # ------------------------------------------------ grouping: series → group
    group_of_series, group_labels, n_groups = _tag_group_layout(
        batch, query.group_tags)

    # ---------------------------------------- string-field group dimensions
    # each GROUP BY field contributes its dictionary-code axis (+1 slot for
    # the NULL group key); combined gid = ((tag_gid·d1 + c1)·d2 + c2)…
    gf_dims, gf_dicts, gf_codes = _gf_layout(batch, query.group_fields, n)
    for d in gf_dims:
        n_groups *= d

    # ------------------------------------------------ aggregate wants
    col_wants: dict[str, dict] = {}
    for a in query.aggs:
        if a.column is None:
            continue
        w = col_wants.setdefault(a.column, {
            "want_count": False, "want_sum": False, "want_min": False,
            "want_max": False, "want_first": False, "want_last": False})
        for k, v in AggSpec._NEEDS[a.func].items():
            w[k] = w[k] or v
    needs_rank = any(a.func in ("first", "last") for a in query.aggs)

    # ------------------------------------------------ bucket geometry (meta only)
    ts_lo, ts_hi, origin, interval, bmin, dense_span = _bucket_geometry(
        batch, query.time_bucket)

    arith = None
    if query.time_bucket is not None:
        from .fused import bucket_arith_params

        arith = bucket_arith_params(ts_lo, origin, interval, int(bmin),
                                    max_span_ns=ts_hi - ts_lo)
    i32_ok = (ts_hi - ts_lo) < (2**31 - 2) * 1_000_000_000
    # placement: when the scan device resolved to CPU (no accelerator, or a
    # degraded host↔device pipe), the pure-numpy host kernels beat XLA's
    # CPU scatter lowering — the fused path is for real devices
    from .placement import scan_device

    # CNOSDB_TPU_FORCE_DEVICE_PATH=1 is a TEST override: it runs the fused
    # DeviceBatch/launch_fused program (and the aggregate_column_host XLA
    # wrapper) on whatever backend jax has — CI exercises the device
    # placement on the CPU backend, where it would otherwise never engage
    # (round-3 verdict: the device path shipped with zero test coverage)
    cpu_mode = scan_device().type == "cpu" and not _FORCE_DEVICE()
    eff_buckets = dense_span if dense_span <= _DENSE_BUCKET_LIMIT \
        else min(n, dense_span)   # sparse remap keeps occupied buckets only
    if gf_dims and n_groups * eff_buckets > (1 << 24):
        # only the new string-field axes can blow this up — tag-only
        # queries keep the pre-existing dense/sparse bucket behavior
        from ..errors import PlanError

        e = PlanError(
            f"group-by cardinality {n_groups} groups × {dense_span} buckets "
            "exceeds the segment-kernel budget")
        e.fallback_relational = True
        raise e

    use_device = (not cpu_mode
                  and not query.group_fields
                  and _device_eligible(batch, query, col_wants, dense_span)
                  and i32_ok
                  and (query.time_bucket is None or arith is not None))

    if use_device:
        from .device_cache import device_batch
        from .fused import launch_fused

        n_buckets = dense_span if query.time_bucket is not None else 1
        if query.time_bucket is not None:
            bucket_starts = origin + (bmin + np.arange(n_buckets, dtype=np.int64)) * interval
        else:
            bucket_starts = None
        num_segments = n_groups * n_buckets
        dbatch = device_batch(batch)
        pending = launch_fused(dbatch, query.filter, group_of_series,
                               n_groups, n_buckets, arith, col_wants)

        def complete():
            res = pending.fetch()
            presence = res.pop("__presence__")["count"]
            present = presence > 0
            col_results = {c: res.get(c) for c in col_wants}
            return _assemble(batch, query, presence, present, col_results,
                             group_labels, bucket_starts, n_buckets,
                             needs_rank, order=None)

        return complete
    else:
        # ------------------------------ fused native single-pass path
        # the C++ twin of the device kernel (native/segagg.cpp): segment
        # derivation + masked reductions in ONE GIL-free multithreaded
        # sweep — this is what makes the COLD scan competitive (the
        # numpy pipeline below costs several full-array passes)
        seg_cache_probe = getattr(batch, "_seg_cache", None)
        probe_key = (tuple(query.group_tags), tuple(query.group_fields),
                     origin, interval, bmin, dense_span)
        if seg_cache_probe is None or probe_key not in seg_cache_probe:
            # cold only: a warm repeat reuses the cached numpy segment
            # layout below, which beats re-sweeping the batch; the fused
            # pass SEEDS that cache with the per-row segment ids it
            # derives anyway
            fused = _try_native_fused(batch, query, col_wants,
                                      group_of_series, n_groups, origin,
                                      interval, bmin, dense_span,
                                      group_labels, needs_rank,
                                      seg_cache_key=probe_key)
            if fused is not None:
                return fused
        # ---------------------------------------- host-prep path
        # segment-id derivation is identical across repeated queries of the
        # same (group tags, bucket) shape over one scan snapshot — cache it
        # on the batch (same rationale as the reference's TsmReader cache:
        # re-derivation, not decode, dominates repeat queries)
        seg_ids, bucket_starts, n_buckets, seg_cache, seg_key = _seg_layout(
            batch, query.group_tags, query.group_fields, group_of_series,
            gf_dims, gf_codes, origin, interval, bmin, dense_span, cpu_mode)
        num_segments = n_groups * n_buckets

        def cached_runs():
            """Run layout of the cached segment ids (storage batches are
            series-contiguous + time-ordered per series, so segments form
            runs; kernels.run_boundaries). → (starts, run_counts)."""
            entry = seg_cache.get(seg_key)
            if entry is None:
                # evicted by a concurrent query's insert: recompute locally
                entry = [seg_ids, bucket_starts, n_buckets, None, None, None]
            if entry[4] is None:
                entry[4] = kernels.run_boundaries(seg_ids, batch.sid_ordinal)
                entry[5] = np.diff(np.append(entry[4], n))
            return entry[4], entry[5]

        # string-field group keys shred the per-series run structure (a
        # run per value change): skip run-layout construction entirely
        prefer_flat = bool(gf_dims)

        def cached_counts() -> np.ndarray:
            """Group sizes over ALL rows — derived from the cached run
            layout (O(runs), not O(n)), so repeated queries pay nothing
            (count/presence of all-valid unfiltered columns)."""
            entry = seg_cache.get(seg_key)
            if entry is not None:
                if entry[3] is None or len(entry[3]) < num_segments:
                    if prefer_flat:
                        entry[3] = np.bincount(
                            seg_ids, minlength=num_segments).astype(np.int64)
                    else:
                        starts, rcounts = cached_runs()
                        entry[3] = np.bincount(
                            seg_ids[starts], weights=rcounts,
                            minlength=num_segments).astype(np.int64)
                return entry[3][:num_segments]
            return np.bincount(seg_ids, minlength=num_segments) \
                .astype(np.int64)

        # per-column validity is immutable for one scan snapshot: memoize
        # the .all() reductions (a 10M-bool reduce costs ~4ms per query)
        av_cache = getattr(batch, "_allvalid_cache", None)
        if av_cache is None:
            av_cache = batch._allvalid_cache = {}

        def col_all_valid(cname, valid):
            hit = av_cache.get(cname)
            if hit is None:
                hit = av_cache[cname] = bool(valid.all())
            return hit

        # -------------------------------------------- filter
        row_mask = None   # None = no filter, every row participates
        sel_idx = None
        zone_pruned = False
        if query.filter is not None and cpu_mode \
                and not _contains_is_null(query.filter):
            # data skipping: block min/max zone maps (the reference's page
            # statistics pruning, reader/column_group/statistics.rs) — a
            # selective filter touches only candidate blocks
            from . import zonemap

            pb = zonemap.possible_blocks(query.filter, batch)
            if pb is not None and len(pb) and pb.mean() <= 0.25:
                idx = zonemap.candidate_rows(pb, n)
                sel_idx = _eval_filter_on_rows(batch, query.filter, idx)
                zone_pruned = True
        if query.filter is not None and not zone_pruned:
            row_mask = np.ones(n, dtype=bool)
            env = _filter_env(batch, needed=query.filter.columns())
            has_is_null = _contains_is_null(query.filter)
            missing = [c for c in query.filter.columns() if c not in env]
            if missing and not has_is_null:
                # a schema column with no data in this vnode is all-NULL
                # here: any comparison on it matches nothing
                row_mask = np.zeros(n, dtype=bool)
            else:
                for c in missing:  # IS NULL paths need the env entries
                    env[c] = np.zeros(n)
                    env[f"__valid__:{c}"] = np.zeros(n, dtype=bool)
                row_mask = np.asarray(query.filter.eval(env, np), dtype=bool)
                if row_mask.shape == ():  # constant predicate
                    row_mask = np.full(n, bool(row_mask))
                # SQL three-valued logic: a NULL operand makes a comparison
                # non-matching. Comparison LEAVES are already masked in
                # sql.expr; the post-hoc pass below additionally covers
                # bare-column and NOT-wrapped predicates, and is only
                # sound for conjunctive (OR-free) filters — per-column,
                # skipping columns under an explicit IS NULL
                if is_conjunctive(query.filter):
                    skip = is_null_columns(query.filter) if has_is_null \
                        else set()
                    for cname in query.filter.columns() - skip:
                        if cname in batch.fields and not col_all_valid(
                                cname, batch.fields[cname][2]):
                            row_mask &= batch.fields[cname][2]
        if zone_pruned:
            all_rows = len(sel_idx) == n
            if all_rows:
                sel_idx = None
        else:
            all_rows = row_mask is None or bool(row_mask.all())
            if row_mask is None:
                row_mask = np.ones(n, dtype=bool) if not cpu_mode \
                    else None  # the numpy path never touches it when all_rows
            if not all_rows:
                if cpu_mode:
                    # compress ONCE under a selective filter: every kernel
                    # then touches O(selected) rows, not O(n) masked arrays
                    sel_idx = np.nonzero(row_mask)[0]
                else:
                    seg_ids = np.where(row_mask, seg_ids, 0).astype(np.int32)

        # -------------------------------------------- rank for first/last
        # run kernels resolve first/last from per-run endpoint timestamps
        # (no O(n log n) argsort); the rank machinery remains for the XLA
        # host wrapper, unordered synthetic batches, and string columns
        ordered = _ordered_within_series(batch)
        fl_string = any(
            a.func in ("first", "last")
            and ((a.column in batch.fields
                  and batch.fields[a.column][0] in (ValueType.STRING,
                                                    ValueType.GEOMETRY))
                 # TAG columns aggregate through the string path too
                 or (a.column is not None and a.column != "time"
                     and a.column not in batch.fields))
            for a in query.aggs)
        rank_based_fl = needs_rank and (not cpu_mode or not ordered
                                        or fl_string)
        if rank_based_fl:
            rank = getattr(batch, "_rank_cache", None)
            if rank is None:
                order = np.argsort(batch.ts, kind="stable")
                rank = np.empty(n, dtype=np.int32)
                rank[order] = np.arange(n, dtype=np.int32)
                batch._rank_cache = rank
                batch._order_cache = order
            order = batch._order_cache
        else:
            order = None
            rank = getattr(batch, "_zero_rank", None)
            if rank is None or len(rank) != n:
                rank = batch._zero_rank = np.zeros(n, dtype=np.int32)

        # -------------------------------------------- per-column kernels
        seg_kernel = (kernels.numpy_segment_partials if cpu_mode
                      else kernels.aggregate_column_host)
        sel_runs = None
        ts_sel = None
        if cpu_mode and sel_idx is not None and not prefer_flat:
            seg_sel = seg_ids[sel_idx]
            starts_sel = kernels.run_boundaries(
                seg_sel, batch.sid_ordinal[sel_idx])
            rcounts_sel = np.diff(np.append(starts_sel, len(seg_sel)))
            sel_runs = (seg_sel, starts_sel, rcounts_sel)
            if needs_rank and not rank_based_fl:
                ts_sel = batch.ts[sel_idx]
        if all_rows:
            presence = cached_counts()
        elif sel_runs is not None:
            seg_sel, starts_sel, rcounts_sel = sel_runs
            presence = np.bincount(
                seg_sel[starts_sel] if len(seg_sel) else seg_sel[:0],
                weights=rcounts_sel,
                minlength=num_segments).astype(np.int64)
        elif sel_idx is not None:
            presence = np.bincount(seg_ids[sel_idx],
                                   minlength=num_segments).astype(np.int64)
        else:
            presence = seg_kernel(
                np.zeros(n, dtype=np.int64), row_mask, seg_ids, rank,
                num_segments,
                {"want_count": True, "want_sum": False, "want_min": False,
                 "want_max": False})["count"]
        present = presence > 0

        # ------------------------- partial-result memoization (warm path)
        # a scan snapshot is immutable, so per-column segment partials
        # under a fixed segmentation are pure functions of (snapshot,
        # seg_key, column, wants): repeated UNFILTERED queries reuse them
        # in O(segments) instead of re-sweeping O(n) rows (the reference
        # re-reads from its TsmReader cache; this engine's warm contract
        # is the decoded snapshot + its derived partials). The cold
        # native fused pass seeds the same cache.
        memo_ok = query.filter is None and sel_idx is None \
            and (row_mask is None or all_rows)
        with _BATCH_CACHE_LOCK:
            partials = getattr(batch, "_partials", None)
            if partials is None:
                partials = batch._partials = {}

        def memo_get(cname, wants):
            if not memo_ok:
                return None
            hit = partials.get((seg_key, cname))
            if hit is not None:
                for need in _wanted_keys(wants):
                    if need not in hit:
                        hit = None
                        break
            _memo_count("hit" if hit is not None else "miss")
            return hit

        def memo_put(cname, r):
            if memo_ok and isinstance(r, dict):
                with _BATCH_CACHE_LOCK:
                    old = partials.get((seg_key, cname))
                    merged = {**old, **r} if old else dict(r)
                    while len(partials) >= 16:
                        partials.pop(next(iter(partials)))
                        _MEMO_COUNTERS["evict"] += 1
                    partials[(seg_key, cname)] = merged
                    _memo_batches[id(batch)] = batch

        col_results = {}
        for cname, wants in col_wants.items():
            # deadline checkpoint between partial-agg chunks: each column
            # is a host-staging + device-dispatch unit, so an expired or
            # killed request stops before paying for the next column
            _deadline.check_current()
            cached_r = memo_get(cname, wants)
            if cached_r is not None:
                col_results[cname] = cached_r
                continue
            if cname == "time":
                # min/max/first/last/count over the time column itself:
                # timestamps are always valid i64
                vt, vals, valid = ValueType.INTEGER, batch.ts, \
                    np.ones(n, dtype=bool)
            elif cname not in batch.fields:
                if batch.n_series:
                    # aggregate over a TAG column (count(station) etc.):
                    # synthesize per-row values from the series keys; the
                    # planner already validated the name, so a non-field
                    # here is a tag (reference: tags are Utf8 dictionary
                    # columns and aggregate like strings)
                    per = np.array(
                        [None if k is None else k.tag_value(cname)
                         for k in batch.series_keys], dtype=object)
                    vals = per[batch.sid_ordinal]
                    valid = np.array([x is not None for x in vals],
                                     dtype=bool)
                    vt = ValueType.STRING
                else:
                    col_results[cname] = None
                    continue
            else:
                vt, vals, valid = batch.fields[cname]
            if vt in (ValueType.STRING, ValueType.GEOMETRY):
                if sel_idx is not None:
                    sv = np.zeros(n, dtype=bool)
                    sv[sel_idx] = True
                    sv &= valid
                elif row_mask is not None:
                    sv = valid & row_mask
                else:
                    sv = valid
                r = _host_string_agg(
                    vals, sv, seg_ids, rank, num_segments, wants)
                memo_put(cname, r)
                col_results[cname] = r
                continue
            if vt == ValueType.BOOLEAN:
                dev_vals = vals.astype(np.int64)
            elif vt == ValueType.UNSIGNED and not cpu_mode:
                # order-preserving bias: u64 ^ 2^63 viewed as i64 keeps the
                # kernel's comparisons/min/max exact for values ≥ 2^63;
                # sums stay exact mod 2^64 and _assemble un-biases. The
                # numpy path compares/accumulates uint64 natively: no bias.
                from .device_cache import biased_u64

                dev_vals = biased_u64(vals)
            else:
                dev_vals = vals
            all_valid = col_all_valid(cname, valid)
            col_fl = wants.get("want_first") or wants.get("want_last")
            if cpu_mode and not (col_fl and rank_based_fl) \
                    and not (prefer_flat and not col_fl):
                # (string-field group keys without first/last skip the
                # run-aware block entirely — the scatter kernels below do
                # flat bincounts over sel_idx/valid subsets)
                # ------------------------------- run-aware host kernels
                need_ts = bool(col_fl)
                if all_rows and all_valid:
                    starts, rcounts = cached_runs()
                    if not col_fl and len(starts) > (n >> 2):
                        # fine-grained runs (string-field group keys shred
                        # the per-series run structure): a flat bincount
                        # scatter beats reduceat over ~n tiny runs
                        r = kernels.numpy_segment_partials(
                            dev_vals, valid, seg_ids, rank, num_segments,
                            {**wants, "want_count": False},
                            assume_all_valid=True)
                    else:
                        r = kernels.run_segment_partials(
                            dev_vals, seg_ids, starts, num_segments,
                            {**wants, "want_count": False},
                            ts=batch.ts if need_ts else None,
                            run_counts=rcounts)
                    r["count"] = presence
                elif all_valid and sel_runs is not None:
                    seg_sel, starts_sel, rcounts_sel = sel_runs
                    if not col_fl and len(starts_sel) > (len(seg_sel) >> 2):
                        r = kernels.numpy_segment_partials(
                            dev_vals[sel_idx],
                            np.ones(len(seg_sel), dtype=bool), seg_sel,
                            rank[sel_idx], num_segments,
                            {**wants, "want_count": False},
                            assume_all_valid=True)
                    else:
                        r = kernels.run_segment_partials(
                            dev_vals[sel_idx], seg_sel, starts_sel,
                            num_segments, {**wants, "want_count": False},
                            ts=(ts_sel if ts_sel is not None
                                else (batch.ts[sel_idx] if need_ts else None)),
                            run_counts=rcounts_sel)
                    r["count"] = presence
                else:
                    # nulls present: compress valid rows — compression
                    # preserves the run structure
                    if sel_idx is not None:
                        vsub = valid[sel_idx]
                        idx2 = sel_idx if vsub.all() else sel_idx[vsub]
                    else:
                        idx2 = np.flatnonzero(valid)
                    seg2 = seg_ids[idx2]
                    starts2 = kernels.run_boundaries(
                        seg2, batch.sid_ordinal[idx2])
                    r = kernels.run_segment_partials(
                        dev_vals[idx2], seg2, starts2, num_segments,
                        {**wants, "want_count": True},
                        ts=batch.ts[idx2] if need_ts else None)
                memo_put(cname, r)
                col_results[cname] = r
                continue
            # --------------------------- rank/scatter fallback kernels
            if sel_idx is not None:
                # compressed path: gather selected rows once per column
                v_sel = dev_vals[sel_idx]
                valid_sel = (np.ones(len(sel_idx), dtype=bool) if all_valid
                             else valid[sel_idx])
                col_results[cname] = seg_kernel(
                    v_sel, valid_sel, seg_ids[sel_idx], rank[sel_idx],
                    num_segments, {**wants, "want_count": True})
                continue
            if all_rows and all_valid and cpu_mode:
                # count == cached group sizes; skip the redundant bincount
                r = kernels.numpy_segment_partials(
                    dev_vals, valid, seg_ids, rank, num_segments,
                    {**wants, "want_count": False}, assume_all_valid=True)
                r["count"] = presence
                memo_put(cname, r)
                col_results[cname] = r
                continue
            col_valid = valid if all_rows else (valid & row_mask)
            r = seg_kernel(
                dev_vals, col_valid, seg_ids, rank, num_segments,
                {**wants, "want_count": True})
            memo_put(cname, r)
            col_results[cname] = r

        return _assemble(batch, query, presence, present, col_results,
                         group_labels, bucket_starts, n_buckets, needs_rank,
                         order, unsigned_biased=not cpu_mode,
                         gf=(gf_dims, gf_dicts) if gf_dims else None)


def _wanted_keys(wants: dict):
    """Result-dict keys a wants spec needs (memo superset matching)."""
    out = ["count"]
    if wants.get("want_sum"):
        out.append("sum")
    if wants.get("want_min"):
        out.append("min")
    if wants.get("want_max"):
        out.append("max")
    if wants.get("want_first"):
        out += ["first"]
    if wants.get("want_last"):
        out += ["last"]
    return out


def _kernel_threads(query: TpuQuery) -> int:
    if query.kernel_threads > 0:
        return query.kernel_threads
    import os

    return min(8, os.cpu_count() or 1)


def _try_native_fused(batch, query, col_wants, group_of_series, n_groups,
                      origin, interval, bmin, dense_span, group_labels,
                      needs_rank, seg_cache_key=None):
    """Route qualifying scan-aggregates through native fused_seg_agg_f64:
    unfiltered dense-bucket queries whose aggregates are count/sum/mean/
    min/max over FLOAT columns (+ count(*)). Returns a complete() closure
    or None to fall back."""
    from ..storage import native

    if not native.available():
        return None
    if query.group_fields:
        return None
    if query.filter is not None and _contains_is_null(query.filter):
        return None   # IS NULL filters keep the classic 3VL machinery
    if query.time_bucket is not None and dense_span > _DENSE_BUCKET_LIMIT:
        return None
    for a in query.aggs:
        if a.func not in ("count", "sum", "mean", "avg", "min", "max",
                          "first", "last"):
            return None
        if a.column is not None and a.column != "time":
            f = batch.fields.get(a.column)
            if f is None or f[0] != ValueType.FLOAT:
                return None
        if a.column == "time":
            return None
    n_buckets = dense_span if query.time_bucket is not None else 1
    num_segments = n_groups * n_buckets
    if num_segments > (1 << 26):
        return None
    lut = group_of_series.astype(np.int64)
    sid = np.ascontiguousarray(batch.sid_ordinal, dtype=np.int32)
    ts = np.ascontiguousarray(batch.ts, dtype=np.int64)
    row_mask = None
    if query.filter is not None:
        # full-array eval (no index gathers): same semantics as
        # _eval_filter_on_rows with rows=None
        n = batch.n_rows
        cols = query.filter.columns()
        env = _filter_env(batch, needed=cols)
        if any(c not in env for c in cols):
            row_mask = np.zeros(n, dtype=np.uint8)
        else:
            m = np.asarray(query.filter.eval(env, np))
            if m.shape == ():
                m = np.full(n, bool(m))
            m = m.astype(bool)
            if is_conjunctive(query.filter):
                for c in cols:
                    v = env.get(f"__valid__:{c}")
                    if v is not None and not v.all():
                        m &= v
            row_mask = m.astype(np.uint8)
    col_results: dict = {}
    presence = None
    want_seg = seg_cache_key is not None
    seg_out = None
    for cname, wants in col_wants.items():
        f = batch.fields[cname]
        vals = np.ascontiguousarray(f[1], dtype=np.float64)
        valid = f[2]
        valid_u8 = None if bool(valid.all()) else \
            np.ascontiguousarray(valid, dtype=np.uint8)
        # count always rides along: _assemble derives validity (has any
        # value) from it for every aggregate
        r = native.fused_seg_agg_f64(
            ts, sid, lut, origin, interval, int(bmin),
            n_buckets if query.time_bucket is not None else 0,
            vals, valid_u8, row_mask, num_segments,
            {**wants, "want_count": True}, out_seg=want_seg,
            n_threads=_kernel_threads(query))
        if r is None:
            return None
        presence = r.pop("presence")
        seg_out = r.pop("seg", seg_out)
        want_seg = False   # one seg pass is enough
        if query.filter is None and seg_cache_key is not None:
            # seed the warm-path partials memo: the fused pass already
            # computed these over the full snapshot (same eviction cap
            # as memo_put — unbounded shapes must not pile up on one
            # long-lived cached batch)
            with _BATCH_CACHE_LOCK:
                partials = getattr(batch, "_partials", None)
                if partials is None:
                    partials = batch._partials = {}
                old = partials.get((seg_cache_key, cname))
                while len(partials) >= 16:
                    partials.pop(next(iter(partials)))
                partials[(seg_cache_key, cname)] = \
                    {**old, **r} if old else dict(r)
        col_results[cname] = r
    if presence is None:
        # count(*)-only query: presence pass without a value column
        r = native.fused_seg_agg_f64(
            ts, sid, lut, origin, interval, int(bmin),
            n_buckets if query.time_bucket is not None else 0,
            None, None, row_mask, num_segments, {},
            n_threads=_kernel_threads(query))
        if r is None:
            return None
        presence = r["presence"]
    present = presence > 0
    if query.time_bucket is not None:
        bucket_starts = origin + (int(bmin) + np.arange(
            n_buckets, dtype=np.int64)) * interval
    else:
        bucket_starts = None
    if seg_out is not None:
        # seed the warm-path segment cache (slots: seg_ids,
        # bucket_starts, n_buckets, counts, run_starts, run_counts) —
        # seg ids are filter-independent; counts only cacheable when no
        # filter shaped this presence
        with _BATCH_CACHE_LOCK:
            seg_cache = getattr(batch, "_seg_cache", None)
            if seg_cache is None:
                seg_cache = batch._seg_cache = {}
            while len(seg_cache) >= 2:
                seg_cache.pop(next(iter(seg_cache)))
            seg_cache[seg_cache_key] = [
                seg_out, bucket_starts, n_buckets,
                presence if row_mask is None else None, None, None]

    def complete():
        return _assemble(batch, query, presence, present, col_results,
                         group_labels, bucket_starts, n_buckets,
                         needs_rank=False, order=None,
                         unsigned_biased=False)

    return complete


def _assemble(batch, query, presence, present, col_results, group_labels,
              bucket_starts, n_buckets, needs_rank, order,
              unsigned_biased: bool = True, gf=None) -> AggResult:
    out_cols: dict[str, np.ndarray] = {}
    out_valid: dict[str, np.ndarray] = {}
    sel = np.nonzero(present)[0]
    grp_idx = (sel // n_buckets).astype(np.int64)
    bkt_idx = (sel % n_buckets).astype(np.int64)
    if gf is not None:
        # peel the field-code axes off the combined gid (innermost first);
        # code == U is the NULL group key
        gf_dims, gf_dicts = gf
        gid = grp_idx
        for fcol, dim, dic in zip(reversed(query.group_fields),
                                  reversed(gf_dims), reversed(gf_dicts)):
            code = gid % dim
            gid = gid // dim
            lab = np.empty(len(code), dtype=object)
            non_null = code < (dim - 1)
            if non_null.any():
                lab[non_null] = dic[code[non_null]]
            out_cols[fcol] = lab
        grp_idx = gid
    for i, t in enumerate(query.group_tags):
        lab_col = np.empty(len(group_labels), dtype=object)
        lab_col[:] = [lab[i] for lab in group_labels]
        out_cols[t] = lab_col[grp_idx]
    if bucket_starts is not None:
        out_cols["time"] = bucket_starts[bkt_idx]

    for a in query.aggs:
        if a.column is None:
            out_cols[a.alias] = presence[sel]
            continue
        r = col_results.get(a.column)
        if r is None:
            if a.func == "count":  # COUNT of an absent column is 0, never NULL
                out_cols[a.alias] = np.zeros(len(sel), dtype=np.int64)
            else:
                out_cols[a.alias] = np.zeros(len(sel))
                out_valid[a.alias] = np.zeros(len(sel), dtype=bool)
            continue
        cnt = r.get("count")
        unsigned = (unsigned_biased and a.column in batch.fields
                    and batch.fields[a.column][0] == ValueType.UNSIGNED)
        boolean = (a.column in batch.fields
                   and batch.fields[a.column][0] == ValueType.BOOLEAN)

        def unbias(x):
            return (np.ascontiguousarray(x).view(np.uint64)
                    ^ np.uint64(1 << 63))

        def unbias_sum(s, c):
            # sum of biased vals = true_sum - count·2^63 (mod 2^64)
            return (np.ascontiguousarray(s).view(np.uint64)
                    + c.astype(np.uint64) * np.uint64(1 << 63))

        if a.func == "count":
            out_cols[a.alias] = cnt[sel]
        elif a.func in ("mean", "avg"):
            c = cnt[sel]
            s = (unbias_sum(r["sum"][sel], c).astype(np.float64) if unsigned
                 else r["sum"][sel].astype(np.float64))
            with np.errstate(invalid="ignore", divide="ignore"):
                out_cols[a.alias] = np.where(c > 0, s / np.maximum(c, 1), np.nan)
            out_valid[a.alias] = c > 0
        elif a.func == "sum":
            have = cnt[sel] > 0
            s = r["sum"][sel]
            out_cols[a.alias] = unbias_sum(s, cnt[sel]) if unsigned else s
            out_valid[a.alias] = have
        elif a.func in ("min", "max"):
            have = cnt[sel] > 0
            v = r[a.func][sel]
            v = unbias(v) if unsigned else v
            if boolean:
                v = v.astype(bool)   # kernels run bools as i64; the
                # value identity is BOOLEAN (min(f2) renders 'false')
            out_cols[a.alias] = v
            out_valid[a.alias] = have
        elif a.func in ("first", "last"):
            have = cnt[sel] > 0
            v = r[a.func][sel]
            v = unbias(v) if unsigned else v
            if boolean:
                # reference first/last render BOOLEAN as 1/0 (its
                # selector accumulator widens; min/max keep true/false —
                # function/common/first.slt vs min.slt)
                v = v.astype(np.int64)
            out_cols[a.alias] = v
            out_valid[a.alias] = have
            # hidden timestamp of the selected row: lets a coordinator merge
            # first/last partials across vnodes by actual time order. Run
            # kernels return the timestamps directly; rank kernels return
            # positions into the time-sorted order.
            tsv = r.get(f"{a.func}_ts")
            if tsv is not None:
                out_cols[a.alias + "__ts"] = tsv[sel]
            else:
                rk = r.get(f"{a.func}_rank")
                if rk is not None and needs_rank:
                    sorted_ts = _sorted_ts(batch, order)
                    ranks = np.clip(rk[sel], 0, len(sorted_ts) - 1)
                    out_cols[a.alias + "__ts"] = sorted_ts[ranks]
    return AggResult(out_cols, len(sel), out_valid,
                     gid=(grp_idx if gf is None else None),
                     labels=(group_labels if gf is None else None))


def _sorted_ts(batch: ScanBatch, order) -> np.ndarray:
    cached = getattr(batch, "_sorted_ts", None)
    if cached is None:
        cached = batch.ts[order] if order is not None else np.sort(batch.ts, kind="stable")
        batch._sorted_ts = cached
    return cached


def _device_eligible(batch: ScanBatch, query: TpuQuery,
                     col_wants: dict, dense_span: int) -> bool:
    """Fused device path applies when the whole query is expressible over
    device-resident numeric columns (no strings/tags in filter or aggs, no
    IS NULL, no TRY_CAST or cast to a string or timestamp, dense bucket
    range)."""
    from ..sql.expr import _CAST_KINDS, Cast, iter_child_exprs

    if dense_span > _DENSE_BUCKET_LIMIT:
        return False
    for cname in col_wants:
        if cname == "time":
            return False   # i64 timestamps never ride to device; host path
        f = batch.fields.get(cname)
        if f is None and any(k is not None and k.tag_value(cname) is not None
                             for k in batch.series_keys):
            # a TAGS column aggregates from the series keys on the host;
            # a field absent from this batch stays (count 0, else NULL)
            return False
        if f is not None and f[0] in (ValueType.STRING, ValueType.GEOMETRY):
            return False
        if f is not None and f[0] == ValueType.UNSIGNED:
            # the host kernel path is exact (biased i64); the fused
            # program's int64 slots would carry it exactly too, but no
            # test holds that yet
            return False
    if query.filter is not None:
        if _contains_is_null(query.filter):
            return False
        todo = [query.filter]
        while todo:
            e = todo.pop()
            if isinstance(e, Cast) and (
                    e.safe or _CAST_KINDS.get(e.target.upper()) not in
                    ("i", "u", "f", "b")):
                return False   # TRY_CAST, strings and timestamps: host
            todo.extend(iter_child_exprs(e))
        for c in query.filter.columns():
            f = batch.fields.get(c)
            if c == "time":
                return False  # i64 time never rides to device; host path
            if f is None:
                return False  # tag / absent column → host semantics
            if f[0] in (ValueType.STRING, ValueType.GEOMETRY):
                return False
    return True


def _contains_is_null(e) -> bool:
    from ..sql.expr import IsNull

    if isinstance(e, IsNull):
        return True
    for attr in ("left", "right", "operand", "expr", "low", "high"):
        sub = getattr(e, attr, None)
        if isinstance(sub, Expr) and _contains_is_null(sub):
            return True
    args = getattr(e, "args", None)
    if args:
        return any(_contains_is_null(a) for a in args)
    return False


def is_conjunctive(e) -> bool:
    """True when the filter tree contains no OR and no NOT: post-hoc
    validity masking (AND-ing a column's valid mask into the row mask) is
    only sound then — under a disjunction a row may match through a
    branch that never touches the NULL column, and NOT over AND is a
    disjunction by De Morgan (NOT (i = 5 AND f > 2) must match an
    i=NULL, f=0 row through the right branch). Non-conjunctive filters
    rely on the comparison-leaf masking in sql.expr instead."""
    from ..sql.expr import BinOp, UnaryOp

    if isinstance(e, BinOp) and e.op == "or":
        return False
    if isinstance(e, UnaryOp) and e.op == "not" and _contains_and(e.operand):
        return False
    from ..sql.expr import iter_child_exprs

    return all(is_conjunctive(c) for c in iter_child_exprs(e))


def _contains_and(e) -> bool:
    from ..sql.expr import BinOp, iter_child_exprs

    if isinstance(e, BinOp) and e.op == "and":
        return True
    return any(_contains_and(c) for c in iter_child_exprs(e))


def is_null_columns(e) -> set:
    """Columns referenced INSIDE NULL-aware nodes (IS NULL, CASE):
    validity masking must skip exactly these — masking them defeats the
    node's own NULL handling, while skipping masking for every other
    column lets its garbage NULL-slot values match."""
    from ..sql.expr import Case, IsNull, iter_child_exprs

    if isinstance(e, (IsNull, Case)):
        return set(e.columns())
    out: set = set()
    for c in iter_child_exprs(e):
        out |= is_null_columns(c)
    return out


def stacked_filter_masks(env: dict, filters: list, n_rows: int,
                         field_cols: set) -> np.ndarray:
    """Fused micro-batch filter stage: evaluate M member filters over ONE
    shared scan environment → an ``(M, n_rows)`` bool stack, one row mask
    per member. This is the demux half of batching — the scan (decode,
    upload, device dispatch) was paid once for the whole group; each
    member's mask applies the SAME 3VL conjunctive validity semantics as
    the solo path in `QueryExecutor._exec_raw_batches`, so fused results
    are bit-identical to solo. A ``None`` filter means "all rows"."""
    masks = np.empty((len(filters), n_rows), dtype=bool)
    for i, f in enumerate(filters):
        if f is None:
            masks[i] = True
            continue
        # full copy (np.array, not asarray): the eval result may BE a
        # shared-env column (filter `bool_field`), and the in-place
        # validity AND below must never write through to the env that
        # every other member reads
        m = np.array(f.eval(env, np), dtype=bool)
        if m.shape == ():
            m = np.full(n_rows, bool(m))
        if is_conjunctive(f):
            skip = is_null_columns(f)
            for c in f.columns() - skip:
                vk = f"__valid__:{c}"
                if c in field_cols and vk in env:
                    m &= env[vk]
        masks[i] = m
    return masks


def _ordered_within_series(batch: ScanBatch) -> bool:
    """True when (a) timestamps are non-decreasing within every series run
    AND (b) each series occupies exactly one contiguous run — the storage
    layout guarantees both for scan batches; synthetic batches are checked
    once and the result cached. Run-kernel first/last depend on both:
    without (b), filter/null compression can join two chunks of a
    recurring series into one run whose timestamps jump backwards at the
    seam, and run endpoints stop being the time extremes (sum/count/
    min/max never depend on either)."""
    cached = getattr(batch, "_ordered_ws", None)
    if cached is None:
        if batch.n_rows <= 1:
            cached = True
        else:
            changes = np.diff(batch.sid_ordinal) != 0
            ok = (np.diff(batch.ts) >= 0) | changes
            cached = bool(ok.all()) and \
                int(changes.sum()) + 1 == len(np.unique(batch.sid_ordinal))
        batch._ordered_ws = cached
    return cached


def _eval_filter_on_rows(batch: ScanBatch, flt: Expr,
                         idx: np.ndarray) -> np.ndarray:
    """Evaluate `flt` over the candidate rows only (zone-map pruning) —
    same semantics as the full-scan path sans IS NULL (callers exclude
    it): missing columns match nothing, a NULL field operand excludes the
    row. → selected row indices (subset of idx, ascending). Shares
    _filter_env so both paths build identical environments."""
    cols = flt.columns()
    env = _filter_env(batch, needed=cols, rows=idx)
    if any(c not in env for c in cols):
        return idx[:0]   # all-NULL column: comparisons match nothing
    mask = np.asarray(flt.eval(env, np), dtype=bool)
    if mask.shape == ():
        return idx if bool(mask) else idx[:0]
    if is_conjunctive(flt):   # see the 3VL notes in the classic path
        for c in cols:
            v = env.get(f"__valid__:{c}")
            if v is not None and not v.all():
                mask &= v
    return idx[np.flatnonzero(mask)]


def _filter_env(batch: ScanBatch, needed: set | None = None,
                rows: np.ndarray | None = None) -> dict:
    """Filter-evaluation env. `needed` restricts which columns materialize:
    per-row tag expansion builds 10M-element OBJECT arrays, so only tags
    the filter actually references are worth paying for. With `rows`, all
    entries are gathered to that index subset (zone-map candidate rows) —
    one construction path for both the full-scan and pruned evaluations."""
    def sub(a):
        return a if rows is None else a[rows]

    env: dict = {"time": sub(batch.ts)}
    for name, (vt, vals, valid) in batch.fields.items():
        if rows is not None and needed is not None and name not in needed:
            continue   # gathers cost O(rows); skip unreferenced fields
        env[name] = sub(vals)
        env[f"__valid__:{name}"] = sub(valid)
    tag_names = set()
    for k in batch.series_keys:
        if k is not None:
            tag_names.update(t.key for t in k.tags)
    if needed is not None:
        tag_names &= needed
    sid = None
    for t in tag_names:
        per_series = np.array(
            [(k.tag_value(t) if k is not None else None) for k in batch.series_keys],
            dtype=object)
        if sid is None:
            sid = sub(batch.sid_ordinal)
        env[t] = per_series[sid]
    return env


def _host_string_agg(vals, valid, seg_ids, rank, num_segments, wants):
    """String column aggregation on dictionary CODES (count/first/last/
    min/max): the sorted-dictionary invariant makes code order string
    order, so everything is integer ufunc.at — no per-row Python."""
    from ..models.strcol import DictArray

    if not isinstance(vals, DictArray):
        vals = DictArray.from_objects(vals)
    out = {}
    segv = seg_ids[valid]
    cv = vals.codes[valid].astype(np.int64)
    uniq = vals.values
    u = max(len(uniq), 1)
    count = np.bincount(segv, minlength=num_segments).astype(np.int64)
    out["count"] = count
    have = count > 0
    if wants.get("want_min") or wants.get("want_max"):
        mins_c = np.full(num_segments, np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(mins_c, segv, cv)
        maxs_c = np.full(num_segments, -1, dtype=np.int64)
        np.maximum.at(maxs_c, segv, cv)
        mins = np.empty(num_segments, dtype=object)
        maxs = np.empty(num_segments, dtype=object)
        mins[have] = uniq[mins_c[have]]
        maxs[have] = uniq[maxs_c[have]]
        out["min"], out["max"] = mins, maxs
    if wants.get("want_first") or wants.get("want_last"):
        # pack (rank, code) into one i64 so a single min/max scatter picks
        # both the extreme rank and the value it carries
        packed = rank[valid].astype(np.int64) * u + cv
        fpk = np.full(num_segments, np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(fpk, segv, packed)
        lpk = np.full(num_segments, -1, dtype=np.int64)
        np.maximum.at(lpk, segv, packed)
        fv = np.empty(num_segments, dtype=object)
        lv = np.empty(num_segments, dtype=object)
        fv[have] = uniq[fpk[have] % u]
        lv[have] = uniq[lpk[have] % u]
        fr = np.where(have, fpk // u, 2**31 - 1)
        lr = np.where(have, lpk // u, -(2**31))
        out["first"], out["last"] = fv, lv
        out["first_rank"], out["last_rank"] = fr, lr
    if wants.get("want_sum"):
        out["sum"] = np.zeros(num_segments)
    return out
