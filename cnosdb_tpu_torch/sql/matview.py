"""Materialized rollup plane: durable incremental views + planner rewrite.

Role-parity with CnosDB's downsampling/stream-rollup story, built from
parts this engine already has: a ``CREATE MATERIALIZED VIEW name AS
SELECT <aggs> FROM t GROUP BY time_bucket(...), tags`` statement
registers a rollup whose per-bucket PARTIAL aggregates (the same
wire-compatible partials ``ops/group_agg.py`` / ``_merge_partial``
already merge across vnodes) are persisted beside each vnode's TSM data
and advanced delta-only:

  * **Delta protocol** — per (view, vnode) a state file holds
    ``{hwm, groups}`` where ``groups`` maps (tag values..., bucket_ts)
    to the partial dict ``_merge_partial`` produces. A refresh scans
    only ``[hwm, new_hwm)`` (TSM time pruning keeps that delta-sized),
    folds the kernel partials in, then atomically replaces the state
    file (tmp + fsync + rename) BEFORE advancing the durable
    ``WatermarkTracker`` entry — so the tracker never runs ahead of the
    state and a crash between the two never double-counts a row.
  * **Watermark** — ``new_hwm = now - delay_ns`` aligned DOWN to the
    view's bucket grid (sql/stream.py WatermarkTracker semantics): late
    rows within the delay are still raw when their bucket seals.
  * **Subsumption rewrite** — an aggregate query over the same table is
    rewritten when its group tags ⊆ the view's, its physical partials
    are a subset of the view's, its bucket is a multiple of the view's
    (origin-congruent) or absent, its residual filter is empty and any
    tag constraints touch only view group tags. Sealed view buckets
    seed the executor's accumulator; only the unsealed tail plus
    non-bucket-aligned range edges are scanned raw and merged through
    the existing partial-merge path — bit-identical to a full scan.
  * **Failure model** — the state file is the unit of truth; an
    unrefreshed or torn vnode degrades that vnode to hwm = -inf, which
    disables the rewrite (correct, just slower). Rows acked into the
    WAL but folded from the memcache before a crash replay into raw
    storage and are NOT re-folded (delta starts at the persisted hwm).
    Rows arriving later than the watermark delay never enter sealed
    buckets — the same contract streaming rollups have.

Definitions live in the meta catalog (raft-replicated like stream
definitions); every node maintains the views for its LOCAL vnodes on
flush, and the coordinator-side rewrite fans out ``matview_partials``
RPCs for remote vnodes.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from .. import faults
from ..errors import QueryError
from ..models.predicate import I64_MIN, ColumnDomains, TimeRange, TimeRanges
from ..utils import lockwatch, stages
from .planner import AggregatePlan, plan_select
from .stream import WatermarkTracker

log = logging.getLogger("cnosdb.matview")

faults.register_point("matview.persist", __name__,
                      desc="matview state persist, between fsync and rename")

# partial functions a view can persist and the rewrite can merge — the
# same set the vectorized cross-vnode merge supports (executor
# _VEC_MERGE_FUNCS); anything else (collect/distinct payloads) is not a
# fixed-size partial and disqualifies the view/query
MERGEABLE_FUNCS = ("count", "sum", "min", "max", "first", "last")

_LOCK = lockwatch.Lock("matview.counters")
_COUNTERS: dict[str, int] = {}


def _count(name: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters_snapshot() -> dict[str, int]:
    with _LOCK:
        return dict(sorted(_COUNTERS.items()))


def _now_ns() -> int:
    # event-time watermark: a cross-process timestamp compared against
    # row timestamps, so wall clock is the correct clock here
    return int(time.time() * 1e9)


def _align_down(ts: int, origin: int, interval: int) -> int:
    return origin + (int(ts) - origin) // interval * interval


def _align_up(ts: int, origin: int, interval: int) -> int:
    return origin - (origin - int(ts)) // interval * interval


def _py(v):
    """numpy scalar → JSON-serializable Python value."""
    if isinstance(v, np.generic):
        return v.item()
    return v


@dataclass
class MatViewDef:
    """A compiled view: the durable definition plus the derived plan
    bits the maintainer and the rewrite need."""

    name: str
    tenant: str
    database: str
    table: str
    select_sql: str
    delay_ns: int
    user: str
    group_tags: list[str] = field(default_factory=list)
    bucket: tuple[int, int] = (0, 1)
    phys_aggs: list = field(default_factory=list)      # AggSpec partials
    field_names: list[str] = field(default_factory=list)

    @property
    def owner(self) -> str:
        return f"{self.tenant}.{self.database}"

    def definition(self) -> dict:
        return {"tenant": self.tenant, "database": self.database,
                "select_sql": self.select_sql, "delay_ns": self.delay_ns,
                "user": self.user}


def compile_view(name: str, select, select_sql: str, delay_ns: int,
                 tenant: str, database: str, meta) -> MatViewDef:
    """Validate eligibility at CREATE time (not at first refresh): the
    SELECT must decompose into mergeable per-bucket partials."""
    from .executor import _decompose_aggs

    schema = meta.table(tenant, database, select.table)
    plan = plan_select(select, schema)
    if not isinstance(plan, AggregatePlan) or plan.bucket is None:
        raise QueryError(
            "materialized view requires an aggregate SELECT grouped by "
            "a time bucket (date_bin/time_window)")
    if select.where is not None:
        raise QueryError("materialized view SELECT cannot have WHERE — "
                         "filters belong on the querying side")
    if plan.group_fields:
        raise QueryError("materialized view can only group by tags and "
                         "the time bucket (field group keys change "
                         "identity on ALTER)")
    if plan.gapfill or plan.having is not None or plan.order_by \
            or plan.limit is not None or plan.offset is not None:
        raise QueryError("materialized view SELECT cannot use gapfill/"
                         "HAVING/ORDER BY/LIMIT")
    phys_aggs, _finalize = _decompose_aggs(plan.aggs)
    bad = [a.func for a in phys_aggs if a.func not in MERGEABLE_FUNCS]
    if bad:
        raise QueryError(
            f"aggregate partial {bad[0]!r} is not incrementally "
            f"mergeable; materialized views support "
            f"count/sum/mean/min/max/first/last")
    return MatViewDef(
        name=name, tenant=tenant, database=database, table=plan.table,
        select_sql=select_sql, delay_ns=int(delay_ns), user="",
        group_tags=list(plan.group_tags), bucket=plan.bucket,
        phys_aggs=phys_aggs,
        field_names=sorted({a.column for a in phys_aggs if a.column}))


class _FoldPlan:
    """The minimal plan surface ``executor._merge_partial`` reads."""

    __slots__ = ("group_tags", "group_fields", "bucket")

    def __init__(self, group_tags: list[str], bucket):
        self.group_tags = group_tags
        self.group_fields = []
        self.bucket = bucket


@dataclass
class Rewrite:
    """One subsumed query: accumulator seeded from sealed view buckets
    plus the raw time ranges still to scan."""

    view: str
    acc: dict
    scan_ranges: TimeRanges
    seal: int


def _fold_parts(dst: dict, src: dict, mapping) -> None:
    """Merge one persisted partial dict into an accumulator entry —
    mirror of the per-row branch in ``executor._merge_partial``, keyed
    by (view alias → query alias, func)."""
    for valias, qalias, func in mapping:
        if valias not in src:
            continue
        v = src[valias]
        cur = dst.get(qalias)
        if func == "count":
            dst[qalias] = (cur or 0) + int(v)
        elif func == "sum":
            dst[qalias] = v if cur is None else cur + v
        elif func == "min":
            dst[qalias] = v if cur is None else min(cur, v)
        elif func == "max":
            dst[qalias] = v if cur is None else max(cur, v)
        else:  # first / last
            ts = src.get(valias + "__ts", 0)
            cur_ts = dst.get(qalias + "__ts")
            if cur is None or cur_ts is None \
                    or (func == "first" and ts < cur_ts) \
                    or (func == "last" and ts > cur_ts):
                dst[qalias] = v
                dst[qalias + "__ts"] = ts


class MatviewEngine:
    """Per-node maintainer + query-rewrite engine.

    Owns the in-memory state cache for this node's local vnodes, the
    durable watermark registry, and the flush-triggered background
    refresh thread. Registered as ``coord.matview_maintainer`` so the
    ``matview_partials`` RPC and remote rewrites can reach it.
    """

    def __init__(self, executor, state_dir: str):
        self.executor = executor
        self.coord = executor.coord
        self.state_dir = state_dir
        self.tracker = WatermarkTracker(
            os.path.join(state_dir, "watermarks.json"))
        self.views: dict[str, MatViewDef] = {}
        self._states: dict[tuple, dict] = {}   # (name, owner, vid) → state
        self._lock = lockwatch.Lock("matview.state")
        # refresh mutual exclusion is per view and guards only the
        # in-flight set — scan/aggregate work never runs under it, so a
        # slow device refresh of one view cannot stall the others
        self._refresh_cv = threading.Condition()
        self._refreshing: set[str] = set()
        self._dirty: set[tuple] = set()        # (owner, vnode_id) flushed
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._meta_seen: dict | None = None
        self.coord.matview_maintainer = self
        engine = getattr(self.coord, "engine", None)
        if engine is not None:
            engine.flush_listener = self.notify_flush

    # --------------------------------------------------------- registration
    def register(self, vdef: MatViewDef) -> None:
        with self._lock:
            self.views[vdef.name] = vdef
        self._ensure_thread()

    def drop(self, name: str) -> None:
        """Unregister + remove every local persisted partial and
        watermark entry (DROP must not leak state files)."""
        with self._lock:
            vdef = self.views.pop(name, None)
            for key in [k for k in self._states if k[0] == name]:
                self._states.pop(key)
        prefix = f"{name}@"
        wkeys = [k for k in list(self.tracker.watermarks)
                 if k.startswith(prefix)]
        owners = {k.split("@", 1)[1].rsplit(":", 1)[0] for k in wkeys}
        if vdef is not None:
            owners.add(vdef.owner)
        for wkey in wkeys:
            self.tracker.remove(wkey)
        engine = self.coord.engine
        for owner in owners:
            for (o, vid) in list(engine.vnodes):
                if o != owner:
                    continue
                path = self._state_path(name, owner, vid)
                if os.path.exists(path):
                    os.remove(path)
        _count("drop")

    def sync_from_meta(self) -> None:
        """Reconcile the local registry with the replicated catalog —
        how a CREATE/DROP issued on another node reaches this one."""
        try:
            defs = dict(self.executor.meta.matviews)
        except Exception:
            stages.count_error("matview.meta_sync")
            return
        if defs == self._meta_seen:
            return
        self._meta_seen = defs
        from .parser import parse_sql

        for name, d in defs.items():
            if name in self.views:
                continue
            try:
                sel = parse_sql(d["select_sql"])[0]
                self.register(compile_view(
                    name, sel, d["select_sql"], d.get("delay_ns", 0),
                    d.get("tenant", "cnosdb"), d.get("database", "public"),
                    self.executor.meta))
            except Exception:
                log.exception("failed to restore materialized view %s", name)
        for name in [n for n in self.views if n not in defs]:
            self.drop(name)

    # ------------------------------------------------------------- triggers
    def notify_flush(self, owner: str, vnode_id: int) -> None:
        """Flush hook (storage/vnode.py): cheap mark-dirty + wake; the
        refresh itself runs on the background thread, never on the
        write path."""
        with self._lock:
            if not self.views and self._meta_seen is not None:
                return
            self._dirty.add((owner, int(vnode_id)))
        self._wake.set()

    def _ensure_thread(self) -> None:
        if self._thread is not None \
                or os.environ.get("CNOSDB_MATVIEW_AUTO", "1") == "0":
            return
        t = threading.Thread(target=self._run, daemon=True,
                             name="matview-maintainer")
        self._thread = t
        t.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2)

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=5.0)
            if self._stop.is_set():
                return
            self._wake.clear()
            with self._lock:
                dirty = self._dirty
                self._dirty = set()
            if not dirty:
                continue
            try:
                self.sync_from_meta()
                owners = {o for (o, _vid) in dirty}
                for name, vdef in list(self.views.items()):
                    if vdef.owner in owners:
                        self.refresh(name)
            except Exception:
                log.exception("matview background refresh failed")
                stages.count_error("matview.refresh")

    # -------------------------------------------------------------- refresh
    def refresh(self, name: str, now_ns: int | None = None) -> int:
        """Advance every LOCAL vnode of the view to the watermark;
        returns the number of vnodes refreshed. Explicit ``now_ns``
        keeps tests and the debug endpoint deterministic."""
        vdef = self.views.get(name)
        if vdef is None:
            raise QueryError(f"unknown materialized view {name!r}")
        now = _now_ns() if now_ns is None else int(now_ns)
        done = 0
        with self._refresh_cv:
            while name in self._refreshing:   # two racers would double-
                self._refresh_cv.wait()       # apply deltas past the hwm
            self._refreshing.add(name)
        try:
            for split in self._placed_splits(vdef):
                if self.coord.distributed \
                        and split.node_id != self.coord.node_id:
                    continue
                if self._refresh_vnode(vdef, split.vnode_id, now):
                    done += 1
        finally:
            with self._refresh_cv:
                self._refreshing.discard(name)
                self._refresh_cv.notify_all()
        if done:
            # a refreshed rollup changes what matview-rewritten aggregates
            # read: drop the serving plane's cached results for the base
            # table (hygiene — probes revalidate tokens regardless)
            try:
                from ..server import serving

                serving.invalidate(vdef.tenant, vdef.database, vdef.table)
            except Exception:
                stages.count_error("serving.invalidate")
        return done

    def _placed_splits(self, vdef: MatViewDef):
        try:
            return self.coord.table_vnodes(
                vdef.tenant, vdef.database, vdef.table,
                TimeRanges.all(), ColumnDomains.all())
        except Exception:
            stages.count_error("matview.placement")
            return []

    def _refresh_vnode(self, vdef: MatViewDef, vnode_id: int,
                       now: int) -> bool:
        origin, interval = vdef.bucket
        end = _align_down(now - vdef.delay_ns, origin, interval)
        st = self._get_state(vdef.name, vdef.owner, vnode_id)
        hwm = st["hwm"] if st is not None else I64_MIN
        if end <= hwm:
            return False
        v = self.coord.engine.vnode(vdef.owner, vnode_id)
        if v is None:
            return False
        # a member of a replicated set first confirms the read through its
        # read index, leader's or follower's: one that has not applied
        # every acked row below the watermark would move `hwm` past them,
        # and they would be missing from the view for good. One that
        # cannot confirm leaves `hwm` where it was: the next refresh
        # retries
        if self.coord.confirm_read(vdef.owner, vnode_id,
                                   follower=True) is not None:
            _count("refresh_unconfirmed")
            return False
        from ..ops.tpu_exec import (TpuQuery, finish_scan_aggregate,
                                    launch_scan_aggregate)
        from ..storage.scan import scan_vnode

        t0 = time.perf_counter()
        batch = scan_vnode(
            v, vdef.table,
            time_ranges=TimeRanges([TimeRange(hwm, end - 1)]),
            field_names=vdef.field_names)
        result = None
        if batch is not None and batch.n_rows:
            q = TpuQuery(group_tags=vdef.group_tags,
                         time_bucket=vdef.bucket, aggs=vdef.phys_aggs)
            result = finish_scan_aggregate(launch_scan_aggregate(batch, q))
            _count("delta_rows", int(batch.n_rows))
        from .executor import _merge_partial

        key = (vdef.name, vdef.owner, vnode_id)
        with self._lock:
            st = self._states.get(key)
            if st is None:
                st = self._states[key] = {"hwm": I64_MIN, "groups": {}}
            if result is not None:
                _merge_partial(st["groups"], result,
                               _FoldPlan(vdef.group_tags, vdef.bucket),
                               vdef.phys_aggs)
            st["hwm"] = end
            payload = self._wire_state(st)
        self._persist_state(vdef.name, vdef.owner, vnode_id, payload)
        # tracker AFTER the state file: the durable watermark must never
        # run ahead of the partials it describes
        self.tracker.set(f"{vdef.name}@{vdef.owner}:{vnode_id}", end)
        _count("refresh")
        stages.count("matview.delta_rows",
                     int(batch.n_rows) if batch is not None else 0)
        prof = stages.current_profile()
        if prof is not None:
            prof.add_ms("matview.refresh_ms",
                        (time.perf_counter() - t0) * 1e3)
        return True

    # ------------------------------------------------------- state storage
    def _state_path(self, name: str, owner: str, vnode_id: int) -> str:
        return os.path.join(self.coord.engine.vnode_dir(owner, vnode_id),
                            "matview", f"{name}.json")

    @staticmethod
    def _wire_state(st: dict) -> dict:
        rows = [[[_py(k) for k in key],
                 {a: _py(v) for a, v in parts.items()}]
                for key, parts in st["groups"].items()]
        return {"hwm": int(st["hwm"]), "rows": rows}

    def _persist_state(self, name: str, owner: str, vnode_id: int,
                       payload: dict) -> None:
        path = self._state_path(name, owner, vnode_id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        faults.fire("matview.persist", view=name, path=path)
        os.replace(tmp, path)

    def _get_state(self, name: str, owner: str, vnode_id: int) -> dict | None:
        key = (name, owner, vnode_id)
        with self._lock:
            st = self._states.get(key)
        if st is not None:
            return st
        st = self._load_state(name, owner, vnode_id)
        if st is None:
            return None
        with self._lock:
            return self._states.setdefault(key, st)

    def _load_state(self, name: str, owner: str, vnode_id: int) -> dict | None:
        path = self._state_path(name, owner, vnode_id)
        if not os.path.exists(path):
            return None
        from .executor import _canon_group_key

        try:
            with open(path) as f:
                d = json.load(f)
            groups = {tuple(_canon_group_key(k) for k in key): parts
                      for key, parts in d["rows"]}
            return {"hwm": int(d["hwm"]), "groups": groups}
        except Exception:
            # a torn/corrupt state file degrades this vnode to
            # "unrefreshed" (rewrite disabled, raw scans still correct)
            stages.count_error("matview.state_load")
            return None

    def partials_for(self, name: str, owner: str, vnode_id: int) -> dict:
        """RPC surface: one vnode's sealed partial set, wire form."""
        st = self._get_state(name, owner, vnode_id)
        if st is None:
            return {"hwm": None, "rows": []}
        with self._lock:
            return self._wire_state(st)

    # -------------------------------------------------------------- rewrite
    def rewrite(self, plan: AggregatePlan, phys_aggs, tenant: str,
                db: str) -> Rewrite | None:
        """Subsumption check + seed construction; None → raw scan."""
        self.sync_from_meta()
        with self._lock:
            cands = [v for v in self.views.values()
                     if v.tenant == tenant and v.database == db
                     and v.table == plan.table]
        if not cands:
            return None
        for vdef in cands:
            rw = self._try_rewrite(vdef, plan, phys_aggs)
            if rw is not None:
                _count("rewrite_hit")
                stages.count("matview.hit")
                stages.count("matview.seed_groups", len(rw.acc))
                return rw
        _count("rewrite_miss")
        stages.count("matview.miss")
        return None

    def _subsumes(self, vdef: MatViewDef, plan: AggregatePlan,
                  phys_aggs) -> list | None:
        """→ alias mapping [(view_alias, query_alias, func)] or None."""
        if plan.group_fields or plan.gapfill:
            return None
        if plan.filter is not None and not (
                set(plan.filter.columns()) <= set(vdef.group_tags)):
            # a residual filter over view group tags is decidable per
            # sealed group (all its rows share those exact tag values);
            # anything touching fields/time must see raw rows
            return None
        if not set(plan.group_tags) <= set(vdef.group_tags):
            return None
        if plan.tag_domains.is_none or not set(
                plan.tag_domains.domains) <= set(vdef.group_tags):
            return None
        vo, vi = vdef.bucket
        if plan.bucket is not None:
            qo, qi = plan.bucket
            if qi % vi != 0 or (qo - vo) % vi != 0:
                return None
        by_sig = {(a.func, a.column, repr(a.param)): a.alias
                  for a in vdef.phys_aggs}
        mapping = []
        for a in phys_aggs:
            if a.func not in MERGEABLE_FUNCS:
                return None
            valias = by_sig.get((a.func, a.column, repr(a.param)))
            if valias is None:
                return None
            mapping.append((valias, a.alias, a.func))
        return mapping

    def _try_rewrite(self, vdef: MatViewDef, plan: AggregatePlan,
                     phys_aggs) -> Rewrite | None:
        mapping = self._subsumes(vdef, plan, phys_aggs)
        if mapping is None:
            return None
        splits = self._placed_splits(vdef)
        if not splits:
            return None
        # gather per-vnode (hwm, rows): local under the state lock,
        # remote via RPC fan-out (outside any lock)
        entries, remote = [], []
        with self._lock:
            for split in splits:
                if self.coord.distributed \
                        and split.node_id != self.coord.node_id:
                    remote.append(split)
                    continue
                st = self._get_state_locked(vdef.name, vdef.owner,
                                            split.vnode_id)
                if st is None:
                    return None   # unrefreshed vnode → raw scan
                entries.append((st["hwm"],
                                [(k, dict(p))
                                 for k, p in st["groups"].items()]))
        for split in remote:
            wire = self._remote_partials(vdef, split)
            if wire is None or wire.get("hwm") is None:
                return None
            from .executor import _canon_group_key

            entries.append((int(wire["hwm"]),
                            [(tuple(_canon_group_key(k) for k in key), parts)
                             for key, parts in wire.get("rows", [])]))
        vo, vi = vdef.bucket
        seal = _align_down(min(hwm for hwm, _ in entries), vo, vi)
        # usable view-bucket spans per query range + residual raw ranges
        spans, residual = [], []
        for r in plan.time_ranges.ranges:
            lo = _align_up(r.min_ts, vo, vi)
            hi = _align_down(min(r.max_ts + 1, seal), vo, vi)
            if hi <= lo:
                residual.append(r)
                continue
            spans.append((lo, hi))
            if lo > r.min_ts:
                residual.append(TimeRange(r.min_ts, lo - 1))
            if hi <= r.max_ts:
                residual.append(TimeRange(hi, r.max_ts))
        if not spans:
            return None
        tag_idx = {t: i for i, t in enumerate(vdef.group_tags)}
        domain_items = [(tag_idx[c], dom) for c, dom
                        in plan.tag_domains.domains.items()]
        qb = plan.bucket
        acc: dict = {}
        for _hwm, rows in entries:
            for key, parts in rows:
                vts = key[-1]
                if not any(lo <= vts < hi for lo, hi in spans):
                    continue
                if domain_items and not all(
                        dom.contains_value(key[i])
                        for i, dom in domain_items):
                    continue
                if plan.filter is not None:
                    # tags-only residual (checked in _subsumes): every
                    # raw row in this sealed group carries exactly these
                    # tag values, so one eval decides the group. Expr
                    # eval expects array operands (e.g. != is ~(a == b),
                    # and ~ on a Python bool yields a truthy int), so
                    # feed 1-element object arrays — the same code path
                    # the raw scan drives with column arrays.
                    env = {t: np.asarray([key[i]], dtype=object)
                           for t, i in tag_idx.items()}
                    try:
                        if not bool(np.asarray(
                                plan.filter.eval(env, np)).reshape(-1)[0]):
                            continue
                    except Exception:
                        stages.count_error("matview.filter_eval")
                        return None  # degrade to raw scan
                qkey = tuple(key[tag_idx[t]] for t in plan.group_tags)
                if qb is not None:
                    qkey += (qb[0] + (vts - qb[0]) // qb[1] * qb[1],)
                _fold_parts(acc.setdefault(qkey, {}), parts, mapping)
        return Rewrite(view=vdef.name, acc=acc,
                       scan_ranges=TimeRanges(residual), seal=seal)

    def _get_state_locked(self, name, owner, vnode_id):
        """_get_state variant for callers already holding self._lock."""
        key = (name, owner, vnode_id)
        st = self._states.get(key)
        if st is None:
            st = self._load_state(name, owner, vnode_id)
            if st is not None:
                self._states[key] = st
        return st

    def _remote_partials(self, vdef: MatViewDef, split) -> dict | None:
        try:
            _count("remote_fetch")
            return self.coord._rpc(split.node_id, "matview_partials",
                                   {"view": vdef.name, "owner": vdef.owner,
                                    "vnode_id": split.vnode_id})
        except Exception:
            stages.count_error("matview.remote_partials")
            return None

    # ---------------------------------------------------------- inspection
    def status(self, name: str) -> dict:
        vdef = self.views.get(name)
        if vdef is None:
            raise QueryError(f"unknown materialized view {name!r}")
        out = {"table": vdef.table, "delay_ns": vdef.delay_ns,
               "bucket": list(vdef.bucket), "group_tags": vdef.group_tags,
               "vnodes": {}}
        for split in self._placed_splits(vdef):
            if self.coord.distributed \
                    and split.node_id != self.coord.node_id:
                continue
            st = self._get_state(name, vdef.owner, split.vnode_id)
            out["vnodes"][str(split.vnode_id)] = {
                "hwm": None if st is None else int(st["hwm"]),
                "groups": 0 if st is None else len(st["groups"]),
                "watermark": self.tracker.watermarks.get(
                    f"{name}@{vdef.owner}:{split.vnode_id}")}
        return out

    def verify(self, name: str) -> dict:
        """Compare every local vnode's incremental state against a
        from-scratch recompute over the same sealed row set — the
        crash/replay chaos oracle."""
        vdef = self.views.get(name)
        if vdef is None:
            raise QueryError(f"unknown materialized view {name!r}")
        from ..ops.tpu_exec import (TpuQuery, finish_scan_aggregate,
                                    launch_scan_aggregate)
        from ..storage.scan import scan_vnode
        from .executor import _merge_partial

        out = {"equal": True, "vnodes": 0, "mismatches": []}
        for split in self._placed_splits(vdef):
            if self.coord.distributed \
                    and split.node_id != self.coord.node_id:
                continue
            st = self._get_state(name, vdef.owner, split.vnode_id)
            if st is None:
                continue
            out["vnodes"] += 1
            v = self.coord.engine.vnode(vdef.owner, split.vnode_id)
            fresh: dict = {}
            if v is not None and st["hwm"] > I64_MIN:
                batch = scan_vnode(
                    v, vdef.table,
                    time_ranges=TimeRanges(
                        [TimeRange(I64_MIN, st["hwm"] - 1)]),
                    field_names=vdef.field_names)
                if batch is not None and batch.n_rows:
                    r = finish_scan_aggregate(launch_scan_aggregate(
                        batch, TpuQuery(group_tags=vdef.group_tags,
                                        time_bucket=vdef.bucket,
                                        aggs=vdef.phys_aggs)))
                    _merge_partial(fresh, r,
                                   _FoldPlan(vdef.group_tags, vdef.bucket),
                                   vdef.phys_aggs)
            with self._lock:
                have = {k: dict(p) for k, p in st["groups"].items()}
            for bad in _diff_states(have, fresh):
                out["equal"] = False
                if len(out["mismatches"]) < 8:
                    out["mismatches"].append(
                        {"vnode": split.vnode_id, "detail": bad})
        return out


def _diff_states(have: dict, fresh: dict):
    for key in set(have) | set(fresh):
        a, b = have.get(key), fresh.get(key)
        if a is None or b is None:
            yield f"group {key!r} only in " \
                  f"{'state' if b is None else 'recompute'}"
            continue
        for alias in set(a) | set(b):
            x, y = a.get(alias), b.get(alias)
            if x is None or y is None:
                yield f"group {key!r} part {alias} only on one side"
            elif isinstance(x, float) or isinstance(y, float):
                if not np.isclose(float(x), float(y), rtol=1e-9, atol=0):
                    yield f"group {key!r} part {alias}: {x} != {y}"
            elif _py(x) != _py(y):
                yield f"group {key!r} part {alias}: {x} != {y}"
