"""Coordinator: routes writes to placed vnodes, fans scans out over them.

Role-parity with the reference's Coordinator trait / CoordService
(coordinator/src/lib.rs:56-140, service.rs:548-834): write_points splits a
WriteBatch per (bucket by timestamp → shard by series hash) placement from
meta, and table_vnodes enumerates the vnodes a predicate's time ranges
touch. Vnodes placed on other nodes are reached over the msgpack-HTTP RPC
plane: writes forward to the replica leader's node with retry-on-leader-
change (reference tskv_executor.rs TskvLeaderExecutor + rpc/tskv.rs
RaftWrite), scans stream back as Arrow IPC (reference QueryRecordBatch),
and a scan that fails on the leader's node fails over to follower replicas
(reference reader/mod.rs:36 CheckedCoordinatorRecordBatchStream).
"""
from __future__ import annotations

import contextvars
import logging
import os
import queue as queue_mod
import threading
import time
from dataclasses import dataclass, field
from hashlib import blake2b

import numpy as np

from ..errors import ChecksumMismatch, CoordinatorError, DeadlineExceeded, \
    TsmError
from ..utils import stages
from ..utils import deadline as deadline_mod
from ..utils.backoff import Backoff
from ..models.points import SeriesRows, WriteBatch
from ..models.predicate import ColumnDomains, TimeRanges
from ..models.schema import TskvTableSchema, ValueType
from ..server import memory
from ..storage.engine import TsKv
from ..storage.scan import ScanBatch, scan_vnode
from . import health
from .meta import MetaStore
from .raft import ELECTION_TIMEOUT
from ..utils import lockwatch

log = logging.getLogger(__name__)

# Per-node circuit breaker: after CB_THRESHOLD consecutive connection-level
# failures, calls to that node fast-fail for CB_COOLDOWN seconds instead of
# each eating a full RPC timeout (a dead peer would otherwise stall every
# split of every scan). One probe per cooldown window re-tests the node.
CB_THRESHOLD = int(os.environ.get("CNOSDB_CB_THRESHOLD", "3"))
CB_COOLDOWN = float(os.environ.get("CNOSDB_CB_COOLDOWN", "2.0"))
# Deadline-burn threshold for breaker resets: only a success faster than
# this fraction of the hop's timeout absolves accumulated failures — a
# single crawl-speed success from a browning-out node must not rearm it.
CB_BURN_FRACTION = float(os.environ.get("CNOSDB_CB_BURN_FRACTION", "0.5"))
# A leader read's budget for reaching the raft leader through redirects
# and the backoff of an election: the scan RPC's own timeout, capped by
# the request's deadline
LEADER_READ_TIMEOUT_S = 10.0
# A leader's budget for confirming a read through its read index (one
# raft round, and the apply of what it committed), capped by the
# request's deadline
READ_INDEX_TIMEOUT_S = 5.0
# A read of a replicated set refuses once, over this span, no member
# confirmed it and no leader a member named answered: every member was
# unreachable, or refused without naming a leader it could reach. A
# group that lost its leader elects a new one about one election timeout
# later (a prevote and a vote round, each settled as soon as a majority
# answers), and its members then name it; five of the longest spans
# leave room for a split vote and a loaded host, and a read of a group
# that cannot elect (a node cut off from its peers) refuses in well
# under 2 s instead of waiting out LEADER_READ_TIMEOUT_S
LEADERLESS_READ_S = 5 * ELECTION_TIMEOUT[1]


@dataclass
class PlacedSplit:
    """One scan unit: a vnode plus the predicate pushed to it
    (reference data_source/split/mod.rs PlacedSplit)."""

    owner: str
    vnode_id: int
    table: str
    time_ranges: TimeRanges
    tag_domains: ColumnDomains
    node_id: int = 0
    # "hot" | "cold": cold = the vnode holds object-store-tiered files, so
    # its scan lane prunes against local sidecars and ranged-GETs only the
    # surviving pages (storage/tiering.py); informational for planning,
    # metrics and the cold-recovery retry — the readers themselves are
    # tier-transparent
    tier: str = "hot"
    # failover candidates: other replicas as (vnode_id, node_id)
    alternates: list = field(default_factory=list)
    # replicas meta marks BROKEN: data-suspect until the repair clears it
    broken_ids: set = field(default_factory=set)
    # a replicated set's read: the scan asks for the group's raft leader,
    # follows its redirects, and is served once the leader confirms it
    # through its read index
    leader_read: bool = False
    # a leader read planned at a member that need not lead (the stand-in
    # of a BROKEN leader, a failover): it serves once its read index
    # confirms, the follower read index where it follows
    confirmed: bool = False


class Coordinator:
    SCAN_CACHE_SIZE = 32
    # byte cap across cached ScanBatches (sum of array nbytes): entry
    # count alone lets a few huge vnodes pin gigabytes of host memory
    SCAN_CACHE_MAX_BYTES = int(os.environ.get(
        "CNOSDB_CACHE_SCAN_CACHE_MAX_BYTES", str(1024 * 1024 * 1024)))

    def __init__(self, meta, engine: TsKv, node_id: int | None = None,
                 memory_pool=None):
        from ..utils.memory_pool import DEFAULT_POOL

        self.meta = meta
        self.engine = engine
        self.memory_pool = memory_pool or DEFAULT_POOL
        # distributed iff the catalog is a remote MetaClient: placement may
        # then name vnodes on other nodes, reached over RPC
        self.distributed = not isinstance(meta, MetaStore)
        self.node_id = node_id if node_id is not None else meta.node_id
        self._replica_mgr = None  # built on first multi-replica write
        self._replica_mgr_lock = lockwatch.Lock("coord.replica_mgr")
        self._closed = False      # a closed node builds no raft members
        # (owner, replica set id) → the vnode last seen leading it, for
        # the leader reads of the sets this node holds no member of
        self._leaders_seen: dict = {}
        # set by sql/matview.MatviewEngine; serves matview_partials RPCs
        self.matview_maintainer = None
        # ScanBatch snapshots keyed by vnode data_version: repeated queries
        # reuse both the host batch and its device-resident twin (the
        # reference's TsmReader LRU cache, promoted to whole-scan snapshots
        # because host→device transfer dominates on this hardware);
        # lock-guarded: node-service handler threads scan concurrently
        # key → (ScanToken, ScanBatch, nbytes); LRU by dict re-insertion
        self._scan_cache: dict = {}
        self._scan_cache_bytes = 0
        self._scan_cache_lock = lockwatch.Lock("coord.scan_cache")
        # memory-governance plane: the scan cache is an evictable pool —
        # the broker shrinks it LRU-first when the node crosses its soft
        # watermark (latest coordinator instance wins, like the engine)
        memory.register_pool("scan_cache",
                             usage_fn=lambda: self.scan_cache_stats()[1],
                             reclaim=self._reclaim_scan_cache)
        # schema auto-creation callbacks land on meta; keep engine's view hot
        meta.watch(self._on_meta_event)
        # seed the engine's schema view from the catalog for EVERY owner
        # (not just usage_schema's bootstrap tables): on restart no
        # create_table events replay, and WAL replay / flush need the
        # schema to re-key replayed fields by column id and to stamp
        # flushed chunks. MetaClient delegates `tables` to its cache
        # replica, so distributed nodes seed the same way (and keep
        # hydrating via watch events).
        for owner, tbls in getattr(meta, "tables", {}).items():
            for t in tbls.values():
                self.engine.set_table_schema(owner, t)
        # throttle clock + cumulative counters per usage metric key,
        # lock-guarded: executor/HTTP threads record concurrently
        self._usage_last: dict = {}
        self._usage_lock = lockwatch.Lock("coord.usage")
        # circuit breaker: node_id → [consecutive_failures, open_until]
        self._cb: dict = {}
        self._cb_lock = lockwatch.Lock("coord.circuit_breakers")
        # hedged-scan plane: per-coordinator in-flight hedge cap (hedges
        # add load exactly when the cluster is slow — bound them) and a
        # sequence for derived per-attempt hedge qids
        self._hedge_limiter = health.HedgeLimiter(health.HEDGE_MAX_INFLIGHT)
        self._hedge_seq = 0
        self._hedge_lock = lockwatch.Lock("coord.hedge_seq")

    def _rpc(self, node_id: int, method: str, payload: dict,
             timeout: float = 10.0, hedge: bool = False):
        from .net import RpcError, RpcThrottled, RpcUnavailable, rpc_call

        addr = self.meta.node_addr(node_id)
        if not addr:
            raise RpcUnavailable(f"node {node_id} has no address")
        now = time.monotonic()
        with self._cb_lock:
            st = self._cb.get(node_id)
            if st is not None and st[0] >= CB_THRESHOLD:
                if now < st[1]:
                    raise RpcUnavailable(
                        f"{method}@node {node_id}: circuit open after "
                        f"{st[0]} consecutive failures "
                        f"(probe in {st[1] - now:.1f}s)")
                # half-open: this call is the single probe; keep the
                # circuit closed to everyone else until it resolves
                st[1] = now + CB_COOLDOWN
                health.count_breaker(node_id, "half_open")
        if health.enabled() and method in health.HEDGEABLE \
                and not hedge and not health.SLOW_START.admit(node_id):
            # freshly-closed breaker still ramping: fast-fail this READ
            # to an alternate instead of piling full traffic back onto a
            # barely-recovered node (writes are raft-placed, no
            # alternate exists, so they always pass). Hedges bypass the
            # ramp: a hedge is a single limiter-capped rescue probe for
            # a query whose preferred replica is ALREADY browned out —
            # the ramping node may be its only fast alternate
            raise RpcThrottled(
                f"{method}@node {node_id}: slow-start ramp after breaker "
                f"close — read routed to an alternate")
        dl = deadline_mod.current()
        if dl is not None and dl.qid is not None:
            # remember every node this request sent work to, so a kill /
            # expiry / disconnect can fan best-effort cancel_scan out
            dl.remote_nodes.add(addr)
        t0 = time.monotonic()
        try:
            reply = rpc_call(addr, method, payload, timeout=timeout)
        except RpcUnavailable:
            if dl is not None and dl.dead():
                # the socket timed out because OUR budget ran dry (or the
                # query was killed mid-read), not because the peer is
                # sick: don't poison the breaker or mark replicas broken
                dl.check()  # raises DeadlineExceeded / cancelled
            with self._cb_lock:
                st = self._cb.setdefault(node_id, [0, 0.0])
                st[0] += 1
                if st[0] >= CB_THRESHOLD:
                    st[1] = time.monotonic() + CB_COOLDOWN
                    if st[0] == CB_THRESHOLD:
                        health.count_breaker(node_id, "open")
            # an opened breaker voids any in-progress readmission ramp
            health.SLOW_START.clear(node_id)
            raise
        except RpcError:
            # app-level rejection: the node answered, so it is alive
            self._cb_reset(node_id)
            raise
        if time.monotonic() - t0 < CB_BURN_FRACTION * timeout:
            self._cb_reset(node_id)
        # a slow success deliberately leaves the consecutive-failure
        # counter standing: the node answered, but at brownout speed —
        # resetting on it would let a node timing out for everyone else
        # rearm itself with one crawled reply
        return reply

    def _cb_reset(self, node_id: int) -> None:
        """Breaker success path: clear accumulated failures; when this
        closes an OPEN breaker, start the slow-start readmission ramp
        instead of readmitting full traffic at once."""
        with self._cb_lock:
            st = self._cb.pop(node_id, None)
        if st is not None and st[0] >= CB_THRESHOLD:
            health.count_breaker(node_id, "closed")
            health.SLOW_START.begin(node_id)

    def _on_meta_event(self, event: str, payload: dict):
        if event == "update_vnode":
            # placement changed: raft peer resolution + scan snapshots must
            # re-derive from the new replica-set layout
            if self._replica_mgr is not None:
                self._replica_mgr.invalidate(payload["owner"],
                                             payload["rs_id"])
            with self._scan_cache_lock:
                self._scan_cache.clear()
                self._scan_cache_bytes = 0
            return
        if event in ("create_table", "update_table", "recover_table"):
            owner = payload["owner"]
            tenant, db = owner.split(".", 1)
            schema = self.meta.table_opt(tenant, db, payload["table"])
            if schema is not None:
                self.engine.set_table_schema(owner, schema)
        elif event == "drop_table":
            self.engine.drop_table(payload["owner"], payload["table"])
        elif event == "purge_table":
            # a trashed incarnation was superseded by CREATE of the same
            # name: hard-delete its rows before the new table goes live
            self.engine.drop_table(payload["owner"], payload["table"])
            with self._scan_cache_lock:
                self._scan_cache.clear()
                self._scan_cache_bytes = 0
        elif event == "trash_table":
            # soft delete: schema gone, row data stays until purge
            self.engine.remove_table_schema(payload["owner"],
                                            payload["table"])
        elif event == "drop_db":
            self.engine.drop_database(payload["owner"])
        elif event == "purge_vnode":
            # targeted reclamation of one trashed incarnation's vnode
            self.engine.drop_vnode(payload["owner"], payload["vnode_id"])
        elif event == "trash_db":
            # soft delete: close vnodes, keep every file for RECOVER
            self.engine.close_database(payload["owner"])
            with self._scan_cache_lock:
                self._scan_cache.clear()
                self._scan_cache_bytes = 0
        elif event == "recover_db":
            owner = payload["owner"]
            tenant, db = owner.split(".", 1)
            for t in self.meta.tables.get(owner, {}).values():
                self.engine.set_table_schema(owner, t)

    # ---------------------------------------------------------------- write
    def write_points(self, tenant: str, db: str, batch: WriteBatch,
                     sync: bool = False):
        """Split per placement and write each vnode group
        (reference service.rs:565 write_lines)."""
        with stages.stage("write.apply_ms"):
            owner = f"{tenant}.{db}"
            self.meta.database(tenant, db)  # raises if missing
            # gate large ingests on the memory budget (reference
            # raft/writer.rs:58-84 gates writes on GreedyMemoryPool)
            est = batch.n_rows() * 128
            record = db != "usage_schema"
            if record:
                # memory-governance ladder at USER ingress only: internal
                # usage_schema rows and the raft apply/heartbeat plane are
                # never backpressured (they are how the node drains)
                memory.write_admit(est)
            pre_sizes = None
            if record:
                try:
                    pre_sizes = self._vnode_cache_sizes(owner)
                except Exception:
                    record = False   # metrics must never fail the write
            with self.memory_pool.reservation(est, f"write to {owner}"):
                self._write_points_inner(tenant, db, owner, batch, sync)
            if record:
                try:
                    self._record_write_usage(tenant, db, owner, est,
                                             pre_sizes)
                except Exception:
                    stages.count_error("swallow.coord.record_write_usage")

    def _write_points_inner(self, tenant, db, owner, batch, sync):
        per_rs: dict[int, tuple[object, WriteBatch]] = {}
        prec = self.meta.database(tenant, db).options.precision
        factor = prec.to_ns_factor()
        if factor != 1:
            # ns inputs TRUNCATE to the database's precision
            # (db_precision.slt: us-db stores ...010001 as ...010000)
            for table, series_list in batch.tables.items():
                for sr in series_list:
                    ts = np.asarray(sr.timestamps, dtype=np.int64)
                    sr.timestamps = ts - (ts % factor)
        for table, series_list in batch.tables.items():
            self._ensure_schema(tenant, db, table, series_list)
            for sr in series_list:
                groups = self._split_series_by_bucket(tenant, db, sr)
                for rs, sub in groups:
                    entry = per_rs.get(rs.id)
                    if entry is None:
                        entry = per_rs[rs.id] = (rs, WriteBatch())
                    entry[1].add_series(table, sub)
        for rs, sub_batch in per_rs.values():
            self._write_replica_set(owner, rs, sub_batch, sync)

    # ----------------------------------------------------- usage metrics
    # The reference's metrics reporter (usage_schema.rs) writes REAL rows
    # into cnosdb.usage_schema: cumulative per-tenant counters
    # (coord_data_in/out, coord_writes/queries, sql/http_*) and per-vnode
    # gauges (vnode_cache_size pre+post around each write,
    # vnode_disk_storage after it). Metric writes never recurse (records
    # skip when the target db IS usage_schema) and never fail the caller.

    def _vnode_cache_sizes(self, owner: str) -> dict:
        # only already-open local vnodes — lazily opening every on-disk
        # vnode would defeat the point of a cheap gauge. Snapshot under
        # engine.lock: concurrent writes open vnodes mid-iteration.
        with self.engine.lock:
            vnodes = list(self.engine.vnodes.items())
        return {vid: v.active.usage_size
                for (o, vid), v in vnodes if o == owner}

    def record_usage(self, table: str, tags: dict, value: int,
                     throttle: bool = False, cumulative: bool = False):
        """Append one point to usage_schema.<table>. `throttle` caps the
        series at one sample per second; `cumulative` accumulates the
        value into a monotone counter first (prometheus-style)."""
        try:
            key = (table, tuple(sorted(tags.items())))
            now = time.monotonic()   # throttle interval, not a timestamp
            with self._usage_lock:
                if cumulative:
                    cnt = self._usage_last.setdefault(("c", key), [0])
                    cnt[0] += value
                    value = cnt[0]
                if throttle:
                    last = self._usage_last.get(("t", key))
                    if last is not None and now - last < 1.0:
                        return
                    self._usage_last[("t", key)] = now
            from ..models.points import SeriesRows, WriteBatch
            from ..models.schema import ValueType
            from ..models.series import SeriesKey, Tag

            sk = SeriesKey(table, [Tag(k, str(v)) for k, v in tags.items()])
            wb = WriteBatch()
            wb.add_series(table, SeriesRows(
                sk, [time.time_ns()],
                {"value": (int(ValueType.UNSIGNED), [int(value)])}))
            self.write_points("cnosdb", "usage_schema", wb)
        except Exception:
            stages.count_error("swallow.coord.report_usage")  # metrics must never fail or recurse into the caller

    def _record_write_usage(self, tenant, db, owner, est_bytes, pre_sizes):
        node = str(self.node_id)
        base = {"tenant": tenant, "database": db, "node_id": node}
        self.record_usage("coord_data_in", base, est_bytes,
                          throttle=True, cumulative=True)
        self.record_usage("coord_writes", base, 1,
                          throttle=True, cumulative=True)
        post = self._vnode_cache_sizes(owner)
        for vid, sz in post.items():
            pre = (pre_sizes or {}).get(vid, 0)
            if sz == pre and vid in (pre_sizes or {}):
                continue   # untouched vnode
            vt = {"tenant": tenant, "database": db, "node_id": node,
                  "vnode_id": str(vid)}
            self.record_usage("vnode_cache_size", vt, pre)
            self.record_usage("vnode_cache_size", vt, sz)
            v = self.engine.vnodes.get((owner, vid))
            if v is not None:
                self.record_usage("vnode_disk_storage", vt, v.disk_size())

    def _split_series_by_bucket(self, tenant: str, db: str, sr: SeriesRows):
        """A series' rows can straddle buckets; split rows by bucket then
        route to `shard = hash % shard_num` within each."""
        from ..models.points import ts_bounds

        h = sr.key.hash_id()
        if not len(sr.timestamps):
            return []
        # fast path: whole series fits one bucket (the common case)
        lo, hi = ts_bounds(sr.timestamps)
        b_lo = self.meta.locate_bucket_for_write(tenant, db, lo)
        if b_lo.contains(hi):
            return [(b_lo.vnode_for(h), sr)]
        rs_rows: dict[int, tuple[object, list[int]]] = {}
        for i, ts in enumerate(sr.timestamps):
            bucket = self.meta.locate_bucket_for_write(tenant, db, int(ts))
            rs = bucket.vnode_for(h)
            rs_rows.setdefault(rs.id, (rs, []))[1].append(i)

        def take(col, idxs):
            if isinstance(col, np.ndarray):
                return col[np.asarray(idxs, dtype=np.int64)]
            return [col[i] for i in idxs]

        out = []
        for rs, idxs in rs_rows.values():
            if len(idxs) == len(sr.timestamps):
                out.append((rs, sr))
            else:
                sub = SeriesRows(
                    sr.key, take(sr.timestamps, idxs),
                    {k: (vt, take(vals, idxs))
                     for k, (vt, vals) in sr.fields.items()})
                out.append((rs, sub))
        return out

    def _write_replica_set(self, owner: str, rs, batch: WriteBatch,
                           sync: bool):
        """Single-replica sets write the engine directly (locally or on the
        owning node); replicated sets go through raft consensus on the
        leader (reference service.rs write_replica_by_raft)."""
        from ..storage.wal import WalEntryType

        # stamp schema version/column ids before any encode: the WAL-bound
        # payload then replays correctly across RENAME/DROP on every path
        # (direct, RPC-forwarded, raft-replicated)
        batch.stamp_schema(self.engine.schemas.get(owner, {}))
        if len(rs.vnodes) <= 1:
            target = rs.vnodes[0].node_id if rs.vnodes else self.node_id
            if not self.distributed or target == self.node_id:
                self.engine.write(owner, rs.leader_vnode_id, batch, sync=sync)
            else:
                self._rpc(target, "write_vnode",
                          {"owner": owner, "vnode_id": rs.leader_vnode_id,
                           "data": batch.encode(), "sync": sync})
            return
        data = batch.encode()
        if not self.distributed:
            self.replica_manager().write(owner, rs, WalEntryType.WRITE,
                                         data, sync=sync)
            return
        self._write_replicated(owner, rs, WalEntryType.WRITE, data, sync)

    def _write_replicated(self, owner: str, rs, entry_type: int, data: bytes,
                          sync: bool, timeout: float = 15.0):
        """Find the raft leader across nodes, retrying on leader change /
        node loss (reference TskvLeaderExecutor::do_request retry loop).
        The caller's request deadline caps the whole retry budget — a
        short-deadline write fails fast instead of riding the 15 s
        default."""
        from .net import RpcError, RpcUnavailable
        from .raft import NotLeader

        timeout = deadline_mod.cap_current(timeout)
        deadline = time.monotonic() + timeout
        bo = Backoff(initial=0.05, cap=1.0)
        hint_vnode: int | None = None
        last_err = None
        has_local = any(v.node_id == self.node_id for v in rs.vnodes)
        while time.monotonic() < deadline:
            deadline_mod.check_current()
            # 1. a local member may be (or become) the leader
            if has_local:
                try:
                    return self.replica_manager().propose_local(
                        owner, rs, entry_type, data, sync=sync)
                except NotLeader as e:
                    hint_vnode = e.args[0] if e.args else None
                    last_err = e
            # 2. forward to the hinted leader's node, then every other node
            order = []
            if hint_vnode is not None:
                v = rs.vnode(hint_vnode)
                if v is not None and v.node_id != self.node_id:
                    order.append(v.node_id)
            order += [v.node_id for v in rs.vnodes
                      if v.node_id != self.node_id and v.node_id not in order]
            for nid in order:
                try:
                    r = self._rpc(nid, "write_replica",
                                  {"owner": owner, "rs": rs.to_dict(),
                                   "entry_type": entry_type, "data": data,
                                   "sync": sync})
                except (RpcUnavailable, RpcError) as e:
                    last_err = e
                    continue
                if r.get("ok"):
                    return r.get("index")
                hint_vnode = r.get("hint")
            if not bo.sleep(deadline):
                break
        raise CoordinatorError(
            f"no reachable leader for replica set {rs.id} of {owner}"
        ) from last_err

    def _replica_change_membership(self, owner: str, rs, members: list[int],
                                   timeout: float = 15.0) -> int:
        """Drive a single-step raft config change to whichever node leads
        the group (same retry/forward shape as _write_replicated;
        reference raft/manager.rs:323-566 change-membership admin)."""
        from ..errors import ReplicationError
        from .net import RpcError, RpcUnavailable
        from .raft import NotLeader

        timeout = deadline_mod.cap_current(timeout)
        deadline = time.monotonic() + timeout
        bo = Backoff(initial=0.05, cap=1.0)
        hint_vnode: int | None = None
        last_err = None
        has_local = not self.distributed or \
            any(v.node_id == self.node_id for v in rs.vnodes)
        while time.monotonic() < deadline:
            deadline_mod.check_current()
            if has_local:
                try:
                    return self.replica_manager().change_membership_local(
                        owner, rs, members)
                except NotLeader as e:
                    hint_vnode = e.args[0] if e.args else None
                    last_err = e
                except ReplicationError as e:
                    # leader is the member being removed (needs the pending
                    # stepdown to land) or a commit timeout: retry
                    last_err = e
            order = []
            if hint_vnode is not None:
                v = rs.vnode(hint_vnode)
                if v is not None and v.node_id != self.node_id:
                    order.append(v.node_id)
            order += [v.node_id for v in rs.vnodes
                      if v.node_id != self.node_id and v.node_id not in order]
            if self.distributed:
                for nid in order:
                    try:
                        r = self._rpc(nid, "replica_change_membership",
                                      {"owner": owner, "rs": rs.to_dict(),
                                       "members": members})
                    except (RpcUnavailable, RpcError) as e:
                        last_err = e
                        continue
                    if r.get("ok"):
                        return r.get("index")
                    hint_vnode = r.get("hint")
            if not bo.sleep(deadline):
                break
        raise CoordinatorError(
            f"membership change failed for replica set {rs.id} of {owner}"
        ) from last_err

    def _replica_stepdown(self, owner: str, rs, vnode_id: int) -> None:
        """Best-effort: ask the member (wherever it lives) to yield
        leadership before its removal/move."""
        v = rs.vnode(vnode_id)
        if v is None:
            return
        try:
            if not self.distributed or v.node_id == self.node_id:
                self.replica_manager().stepdown_local(owner, rs, vnode_id)
            else:
                self._rpc(v.node_id, "replica_stepdown",
                          {"owner": owner, "rs": rs.to_dict(),
                           "vnode_id": vnode_id})
        except Exception:
            stages.count_error("swallow.coord.replica_stepdown")

    def _replica_progress(self, owner: str, rs,
                          vnode_id: int) -> tuple[int, int] | None:
        """(match, commit) of a member as seen by the group leader."""
        if not self.distributed or \
                any(v.node_id == self.node_id for v in rs.vnodes):
            pr = self.replica_manager().member_progress(owner, rs, vnode_id)
            if pr is not None:
                return pr
        if self.distributed:
            members = [v for v in rs.vnodes if v.node_id != self.node_id]
            if health.enabled() and len(members) > 1:
                # read-only quorum probe: ask the healthiest member
                # first so one browning-out peer can't put its full RPC
                # timeout in front of every progress check
                members = health.SCORER.rank(
                    members,
                    lambda v: self.meta.node_addr(v.node_id)
                    or f"node:{v.node_id}")
            for v in members:
                try:
                    r = self._rpc(v.node_id, "replica_progress",
                                  {"owner": owner, "rs": rs.to_dict(),
                                   "vnode_id": vnode_id})
                except Exception:
                    continue
                if r.get("ok"):
                    return r["match"], r["commit"]
        return None

    def replica_manager(self):
        mgr = self._replica_mgr
        if mgr is not None:
            return mgr
        # built once: a booting node's first raft messages arrive on
        # several RPC threads at once, and a second manager would start a
        # second raft member of each local vnode on the same WAL, unseen
        # by /debug/health; one that won leadership left the registered
        # member a follower with no leader and its group stuck
        with self._replica_mgr_lock:
            if self._closed:
                # a raft message or a scan that reaches a closed node
                # (a kept-alive connection) would start raft members that
                # tick for good
                raise CoordinatorError(f"node {self.node_id} is closed")
            if self._replica_mgr is None:
                from .replica import ReplicaGroupManager

                self._replica_mgr = ReplicaGroupManager(
                    self.engine,
                    node_id=self.node_id if self.distributed else None,
                    meta=self.meta if self.distributed else None)
            return self._replica_mgr

    def close(self):
        """Stop raft tickers BEFORE closing the engine — heartbeats append
        to the WAL, which must outlive them."""
        with self._replica_mgr_lock:
            self._closed = True
        if self._replica_mgr is not None:
            self._replica_mgr.stop()
            self._replica_mgr = None
        self.engine.close()

    def _ensure_schema(self, tenant: str, db: str, table: str,
                       series_list: list[SeriesRows]):
        """Auto-create/evolve the table schema from incoming points
        (reference database.rs build_write_group schema inference)."""
        schema = self.meta.table_opt(tenant, db, table)
        if schema is None:
            tags = sorted({t.key for sr in series_list for t in sr.key.tags})
            fields = {}
            for sr in series_list:
                for name, (vt, _vals) in sr.fields.items():
                    fields.setdefault(name, ValueType(vt))
            schema = TskvTableSchema.new_measurement(
                tenant, db, table, tags, sorted(fields.items()),
                precision=self.meta.database(tenant, db).options.precision)
            self.meta.create_table(schema, if_not_exists=True)
            return
        from ..models.schema import ColumnType

        changed = False
        for sr in series_list:
            for t in sr.key.tags:
                if not schema.contains_column(t.key):
                    schema.add_column(t.key, ColumnType.tag(),
                                      sorted_insert=True)
                    changed = True
            for name, (vt, _vals) in sr.fields.items():
                if not schema.contains_column(name):
                    schema.add_column(name, ColumnType.field(ValueType(vt)),
                                      sorted_insert=True)
                    changed = True
        if changed:
            self.meta.update_table(schema)

    # ---------------------------------------------------------------- read
    def table_vnodes(self, tenant: str, db: str, table: str,
                     time_ranges: TimeRanges,
                     tag_domains: ColumnDomains) -> list[PlacedSplit]:
        """Predicate → splits (reference SplitManager::splits +
        coord.table_vnodes)."""
        owner = f"{tenant}.{db}"
        lo = None if time_ranges.is_all else time_ranges.min_ts
        hi = None if time_ranges.is_all else time_ranges.max_ts
        from ..models.meta_data import VnodeStatus

        splits = []
        seen = set()
        for bucket in self.meta.buckets_for(tenant, db, lo, hi):
            for rs in bucket.shard_group:
                vnode_id = rs.leader_vnode_id
                # every read of a replicated set is a leader read: it
                # starts at the live raft leader (meta's static leader may
                # be a follower that has not applied the tail of the log
                # since an election); a node with no view of the leader
                # (it holds no member of the set, or its member is between
                # leaders) starts at the leader it last saw, else meta's
                # static one, and follows the redirects
                replicated = len(rs.vnodes) > 1
                live = self._live_leader_vnode(owner, rs)
                if live is not None:
                    vnode_id = live
                elif replicated:
                    vnode_id = self._leader_seen(owner, rs) or vnode_id
                candidate = vnode_id
                # prefer a RUNNING replica over a broken-marked leader
                v = rs.vnode(vnode_id)
                if v is not None and v.status == VnodeStatus.BROKEN:
                    healthy = [x for x in rs.vnodes
                               if x.status == VnodeStatus.RUNNING]
                    if healthy:
                        v = healthy[0]
                        vnode_id = v.id
                # route to the chosen vnode's placement node
                node_id = v.node_id if v is not None \
                    else (rs.leader_node_id or self.node_id)
                if vnode_id in seen:
                    continue
                seen.add(vnode_id)
                # alternates: RUNNING replicas first; BROKEN ones stay as a
                # last resort (only the anti-entropy repair clears the
                # mark); COPYING replicas have no data yet and are never
                # read
                running = [(a.id, a.node_id) for a in rs.vnodes
                           if a.id != vnode_id
                           and a.status == VnodeStatus.RUNNING]
                broken = [(a.id, a.node_id) for a in rs.vnodes
                          if a.id != vnode_id
                          and a.status == VnodeStatus.BROKEN]
                split = PlacedSplit(owner, vnode_id, table,
                                    time_ranges, tag_domains,
                                    node_id=node_id,
                                    tier=self._split_tier(owner, vnode_id,
                                                          node_id),
                                    alternates=running + broken)
                split.broken_ids = {a.id for a in rs.vnodes
                                    if a.status == VnodeStatus.BROKEN}
                # a stand-in for a BROKEN leader serves it as a follower,
                # through the follower read index
                split.leader_read = replicated
                split.confirmed = replicated and vnode_id != candidate
                splits.append(split)
        return splits

    def _live_leader_vnode(self, owner: str, rs) -> int | None:
        """The vnode that leads the replicated set in raft, as this node
        sees it: a local member that leads, else the leader a local
        member follows. None where the set has one replica, where the
        node has no view of its leader (it holds no member of the set, or
        its member is between leaders), or where the view names no vnode
        of the set or a COPYING one (no data yet)."""
        from ..models.meta_data import VnodeStatus

        mgr = self._replica_mgr
        if len(rs.vnodes) <= 1 or mgr is None:
            return None
        live = mgr.current_leader_vnode(owner, rs)
        if live is None:
            live = mgr.leader_hint(owner, rs)
        v = rs.vnode(live) if live is not None else None
        if v is None or v.status == VnodeStatus.COPYING:
            return None
        return live

    def _leader_seen(self, owner: str, rs) -> int | None:
        """The vnode that answered this node's last leader read of the
        replicated set, if it still names a vnode of the set that is not
        COPYING."""
        from ..models.meta_data import VnodeStatus

        vid = self._leaders_seen.get((owner, rs.id))
        v = rs.vnode(vid) if vid is not None else None
        if v is None or v.status == VnodeStatus.COPYING:
            return None
        return vid

    def confirm_read(self, owner: str, vnode_id: int,
                     follower: bool = False) -> dict | None:
        """The member check of a read of `vnode_id` on this node, for the
        scan RPC's handler, this node's own reads (_leader_scan), its tag
        reads and its view refreshes alike → None where the vnode's raft
        member confirms the read: as the leader, through its read index,
        or, with `follower`, as a follower too, through the follower read
        index (it has applied what the group committed before the read
        arrived): the read is served here. Else the not-leader reply, its
        hint the leader the member follows or a newer one it heard of
        (None while the group elects, or where the member leads but
        cannot confirm it). None also where the set has one replica or
        the vnode no member here: the read is served as one without a
        flag."""
        from .raft import NotLeader

        hit = self.meta.find_vnode(vnode_id)
        if hit is None or len(hit[2].vnodes) <= 1:
            return None
        member = self.replica_manager().get_or_build(
            owner, hit[2]).get(vnode_id)
        if member is None:
            return None
        try:
            member.read_index(deadline_mod.cap_current(READ_INDEX_TIMEOUT_S),
                              follow=follower)
        except NotLeader as e:
            hint = e.leader_id
            return {"ok": False, "not_leader": True,
                    "hint": hint if hint != vnode_id else None}
        return None

    def _leader_scan(self, split: PlacedSplit, payload: dict, scan_here,
                     targets: list | None = None,
                     hedge: bool = False) -> ScanBatch | None:
        """A read of a replicated set (PlacedSplit.leader_read) → the batch
        of the member that confirmed it: no member serves it before it
        confirms (confirm_read). A member on this node is checked here and
        read by `scan_here(vnode_id)`, a remote one through the scan RPC
        with a flag. `targets` are the members to ask, (vnode, node) in
        failover order, the planned one first (by default the split's
        vnode, then its alternates). The planned member is asked as the
        leader (`leader_read`): one that does not lead answers not-leader
        with the leader it follows, and the read goes there; the stand-in
        of a BROKEN leader (PlacedSplit.confirmed) is asked as a confirmed
        read (`confirmed`), which a follower serves too, once its follower
        read index confirms it. Where no leader is named (an election, a
        leader that could not confirm it leads), the one named was asked
        already or is BROKEN, or a member does not answer, the read asks
        the members not asked yet, in order, as confirmed reads, then
        backs off and asks them again. It refuses (CoordinatorError, the
        leader-read error) once, over LEADERLESS_READ_S, no member
        confirmed it and no leader a member named answered, and in any
        case at the request's deadline or LEADER_READ_TIMEOUT_S, the cap
        of a read that keeps being redirected."""
        from .net import RpcError, RpcUnavailable

        t0 = time.monotonic()
        deadline = t0 + deadline_mod.cap_current(LEADER_READ_TIMEOUT_S)
        quiet_since = t0        # a named leader's last answer
        bo = Backoff(initial=0.05, cap=1.0)
        targets = targets or ([(split.vnode_id, split.node_id)]
                              + list(split.alternates))
        members = dict(targets)
        hit = self.meta.find_vnode(split.vnode_id)
        rs = hit[2] if hit is not None else None
        vnode_id, node_id = targets[0]
        confirmed = split.confirmed
        named = not confirmed   # asking a member named as the leader
        asked = set()
        rejected = None         # a member's app-level refusal of the scan
        health.count_leader_read("read")
        while True:
            deadline_mod.check_current()
            asked.add(vnode_id)
            here = node_id == self.node_id or not self.distributed
            answered = True
            if here:
                r = self.confirm_read(split.owner, vnode_id,
                                      follower=confirmed)
            else:
                flag = "confirmed" if confirmed else "leader_read"
                try:
                    r = self._rpc(node_id, "scan_vnode",
                                  {**payload, "vnode_id": vnode_id,
                                   flag: True}, hedge=hedge)
                except RpcError as e:
                    # a member that does not answer names no leader: the
                    # read asks the others
                    if not isinstance(e, RpcUnavailable):
                        rejected = e
                    r, answered = {"not_leader": True, "hint": None}, False
            if r is None or not r.get("not_leader"):
                if rs is not None and not confirmed:
                    self._leaders_seen[(split.owner, rs.id)] = vnode_id
                return scan_here(vnode_id) if here else self._decode_reply(r)
            if answered and named:
                quiet_since = time.monotonic()
            hint = r.get("hint")
            if hint in members and hint not in asked \
                    and hint not in split.broken_ids:
                health.count_leader_read("redirect")
                vnode_id, node_id = hint, members[hint]
                confirmed, named = False, True
                continue
            health.count_leader_read("no_leader")
            confirmed, named = True, False
            nxt = next((t for t in targets if t[0] not in asked), None)
            if nxt is None:
                if not bo.sleep(min(deadline,
                                    quiet_since + LEADERLESS_READ_S)):
                    why = (f"; a member rejected the scan: {rejected}"
                           if rejected is not None else "")
                    raise CoordinatorError(
                        f"no raft leader of the replica set of vnode "
                        f"{split.vnode_id} of {split.owner} confirmed a "
                        f"read in {time.monotonic() - t0:.2f}s (last asked "
                        f"vnode {vnode_id}, hint {hint}){why}")
                asked.clear()
                nxt = targets[0]
            vnode_id, node_id = nxt

    def _decode_reply(self, r: dict) -> ScanBatch | None:
        """A scan RPC's reply → its batch, charged to the request (the
        reply buffer and its decoded twin are its to pay for:
        MemoryExceeded kills only it)."""
        from .ipc import decode_scan_batch

        raw = r.get("ipc")
        if raw is None:
            return None
        memory.charge_query(len(raw), "rpc_result")
        return decode_scan_batch(raw)

    def _local_leader_read(self, split: PlacedSplit, field_names,
                           fingerprint, scan_here) -> ScanBatch | None:
        """A leader read planned at a member on this node: _leader_scan,
        which reads a member here through `scan_here(split)` once it
        confirms, and asks the set's other members where it cannot."""
        def at(vnode_id):
            if vnode_id == split.vnode_id:
                return scan_here(split)
            return scan_here(PlacedSplit(
                split.owner, vnode_id, split.table, split.time_ranges,
                split.tag_domains, node_id=self.node_id,
                tier=self._split_tier(split.owner, vnode_id, self.node_id),
                alternates=[a for a in split.alternates if a[0] != vnode_id],
                broken_ids=set(split.broken_ids), leader_read=True))

        return self._leader_scan(split, self._scan_payload(
            split, split.vnode_id, field_names, fingerprint), at)

    def _scan_payload(self, split: PlacedSplit, vnode_id: int, field_names,
                      fingerprint) -> dict:
        """The scan RPC's request for `split` at `vnode_id`."""
        return {"owner": split.owner, "vnode_id": vnode_id,
                "table": split.table,
                "trs": split.time_ranges.to_wire(),
                "doms": split.tag_domains.to_wire(),
                "field_names": field_names, "fp": fingerprint}

    def _split_tier(self, owner: str, vnode_id: int, node_id: int) -> str:
        """COLD iff the (locally-placed) vnode has object-store-tiered
        files — a registry peek, no vnode open; remote vnodes report hot
        (their own node makes the tier call when it scans)."""
        if node_id != self.node_id and self.distributed:
            return "hot"
        from ..storage import tiering

        d = self.engine.vnode_dir(owner, vnode_id)
        try:
            return "cold" if tiering.cold_ids(d) else "hot"
        except TsmError:
            # torn cold registry: the tier is only a planning hint, so
            # answer "cold" and let the scan hit the damage inside the
            # guarded path, where _recover_cold rebuilds and retries
            return "cold"

    def _recover_cold(self, owner: str, vnode_id: int) -> int:
        """Rebuild lost / corrupt cold-tier sidecars of a LOCAL vnode
        from the object store (ranged tail reads — no full download).
        → sidecars rebuilt; 0 when the vnode has no cold files or the
        rebuild failed (callers then fall back to replica repair)."""
        from ..storage import tiering

        try:
            v = self.engine.vnode(owner, vnode_id)
            if v is None:
                return 0
            try:
                if not tiering.cold_ids(v.dir):
                    return 0
            except TsmError:
                pass    # torn registry: exactly what recover_vnode heals
            n = tiering.recover_vnode(v)
        except Exception:
            log.exception("cold-tier recovery of vnode %s failed", vnode_id)
            return 0
        if n:
            self._drop_vnode_cache_entries(owner, vnode_id)
        return n

    def scan_table(self, tenant: str, db: str, table: str,
                   time_ranges: TimeRanges | None = None,
                   tag_domains: ColumnDomains | None = None,
                   field_names: list[str] | None = None,
                   page_filter=None,
                   fingerprint: str | None = None,
                   compressed_spec=None) -> list[ScanBatch]:
        """Fan a scan out over placed vnodes → one ScanBatch per vnode.

        `page_filter` (optional sql.expr tree) lets the storage scan prune
        pages its statistics prove can't match — the returned batches then
        only cover filter-relevant rows, so callers MUST apply that same
        filter. Cache entries are keyed by the filter's rendering.
        `compressed_spec` (storage/compressed_domain.CompressedSpec)
        additionally engages the compressed-domain lane: batches may come
        back with rows already dropped and `compressed_partials` attached
        (possibly with ZERO rows and only partials) — valid ONLY for
        queries with that exact spec, so engaged batches cache under a
        spec-extended key.
        """
        # a soft-dropped (trashed) table's rows stay on disk for RECOVER
        # but must not be readable until then
        if self.meta.table_opt(tenant, db, table) is None \
                and self.meta.external_opt(tenant, db, table) is None:
            return []
        trs = time_ranges or TimeRanges.all()
        doms = tag_domains or ColumnDomains.all()
        splits = self.table_vnodes(tenant, db, table, trs, doms)

        from ..utils import executor

        workers = min(executor.pool_size("scan"), len(splits))
        # divide the host's cores across concurrent vnode scans: the
        # native page decoder threads inside each scan multiply with the
        # pool width, and oversubscription thrashes the cold path
        ncpu = os.cpu_count() or 1
        n_threads = max(1, ncpu // max(1, workers))

        # extract pruning constraints + cache-key rendering ONCE per query
        # (the filter tree walk is per-query, not per-vnode); a filter
        # with no usable conjuncts degrades to a plain shared scan. The
        # key renders the CONSTRAINTS (not the whole filter) so two
        # filters that prune identically share one cache entry.
        page_constraints = filter_key = None
        if page_filter is not None:
            from ..storage.scan import _page_constraints

            page_constraints = _page_constraints(page_filter,
                                                 field_names or [])
            if page_constraints:
                filter_key = repr(sorted(
                    (c, [(op, repr(v)) for op, v in cons])
                    for c, cons in page_constraints.items()))
            else:
                page_constraints = None

        def one(split):
            if self.distributed and split.node_id != self.node_id:
                return self._scan_remote(split, field_names,
                                         fingerprint=fingerprint)
            if split.leader_read:
                return self._local_leader_read(split, field_names,
                                               fingerprint, local)
            return local(split)

        def local(split):
            try:
                return self._scan_local(split, field_names, page_constraints,
                                        filter_key, n_threads,
                                        compressed_spec)
            except TsmError as e:
                # cold-tier metadata damage (lost / corrupt skip-index
                # sidecar): repairable in place from the object store —
                # rebuild the sidecars via ranged tail reads and retry the
                # scan ONCE. Safe to retry locally: TsmError never
                # quarantines, so the manifest still names every file.
                if not self._recover_cold(split.owner, split.vnode_id):
                    raise
                log.warning("rebuilt cold sidecars on vnode %s after: %s",
                            split.vnode_id, e)
                return self._scan_local(split, field_names, page_constraints,
                                        filter_key, n_threads,
                                        compressed_spec)
            except ChecksumMismatch as e:
                # corruption already quarantined + vnode marked BROKEN by
                # _scan_local; fail the in-flight scan over to a replica
                # alternate rather than erroring the query. The corrupt
                # primary is NOT retried locally — post-quarantine it would
                # answer with silently-missing rows.
                alts = list(split.alternates)
                if not alts:
                    raise
                # a replicated set's alternate serves once its read index
                # confirms it, leader's or follower's
                fo = PlacedSplit(split.owner, alts[0][0], split.table,
                                 split.time_ranges, split.tag_domains,
                                 node_id=alts[0][1], alternates=alts[1:],
                                 broken_ids=set(split.broken_ids),
                                 leader_read=split.leader_read,
                                 confirmed=split.leader_read)
                log.warning("scan failover after corruption on vnode %s: %s",
                            split.vnode_id, e)
                return self._scan_remote(fo, field_names)

        if len(splits) > 1:
            # vnode scans are independent: decode in parallel (the C++
            # codec calls and big numpy ops release the GIL, so the cold
            # TSM→columns path scales with cores — the reference's scan
            # fans out across DataFusion partitions the same way) on the
            # long-lived shared pool (utils/executor.py), not a per-call
            # ThreadPoolExecutor
            results = executor.run_all("scan", one, splits)
        else:
            results = [one(s) for s in splits]
        # a 0-row batch can still carry the whole vnode's answer as
        # compressed-domain partials — it must reach the executor's merge
        return [b for b in results if b is not None
                and (b.n_rows
                     or getattr(b, "compressed_partials", None))]

    def _scan_local(self, split: PlacedSplit, field_names,
                    page_constraints: dict | None = None,
                    filter_key: str | None = None,
                    n_threads: int = 1,
                    compressed_spec=None) -> ScanBatch | None:
        """One local vnode scan (`_scan_local_once`). A compaction or an
        L0 promotion that lands between the scan's file set and its
        reader opens unlinks a file the scan still names: the scan then
        runs again over the new file set, at most twice more. A file
        missing from a file set (ids and levels) that did not move is
        raised."""
        def file_set(v):
            with v.locked("lock_wait_ms", "scan"):
                return frozenset((fm.file_id, fm.level)
                                 for fm in v.summary.version.all_files())

        attempts = 3
        for attempt in range(attempts):
            v = self.engine.vnode(split.owner, split.vnode_id)
            before = file_set(v) if v is not None else None
            try:
                return self._scan_local_once(split, field_names,
                                             page_constraints, filter_key,
                                             n_threads, compressed_spec)
            except FileNotFoundError:
                if attempt == attempts - 1 or v is None \
                        or file_set(v) == before:
                    raise
                stages.count_error("scan.compacted_retry")

    def _scan_local_once(self, split: PlacedSplit, field_names,
                         page_constraints: dict | None = None,
                         filter_key: str | None = None,
                         n_threads: int = 1,
                         compressed_spec=None) -> ScanBatch | None:
        table, trs, doms = split.table, split.time_ranges, split.tag_domains
        v = self.engine.vnode(split.owner, split.vnode_id)
        if v is None:
            return None
        sids = None
        if not doms.is_all:
            sids = v.index.get_series_ids_by_domains(table, doms)
            if len(sids) == 0:
                return None
        sids_key = (blake2b(np.ascontiguousarray(sids).tobytes(),
                            digest_size=16).hexdigest()
                    if sids is not None else None)
        # a predicate-pruned batch holds only pages that can satisfy THAT
        # constraint set: it is cached under the constraints' rendering
        # and never serves a different query. The UNFILTERED entry remains
        # valid for any filtered query (superset + row filter), so probe
        # it as a fallback; and a scan the constraints didn't actually
        # prune is stored under the shared unfiltered key.
        # schema_version keys DDL: after ALTER (drop/add/rename column) a
        # cached batch may hold stale columns — especially under
        # field_names=None (SELECT *), where the requested set is
        # implicit and identical keys would collide across the ALTER
        schema = v.schemas.get(table)
        base_key = (split.owner, split.vnode_id, table,
                    getattr(schema, "schema_version", None),
                    tuple(field_names) if field_names is not None else None,
                    tuple((r.min_ts, r.max_ts) for r in trs.ranges),
                    sids_key)
        key = base_key + (filter_key,)
        key0 = base_key + (None,)
        # a compressed-domain batch may have rows dropped / pre-answered
        # that only THIS spec's filter+aggregates account for: it caches
        # under a spec-extended key. The plain/pruned entries stay valid
        # fallbacks for a spec'd query (superset + executor row filter),
        # but never the reverse — NOTE filter_key alone is not enough:
        # specs with different predicates can share a constraint
        # rendering (e.g. bool conjuncts render no constraints at all).
        spec_key = (base_key + (filter_key, compressed_spec.key)
                    if compressed_spec is not None else None)
        from ..utils import stages

        # token BEFORE probe/decode: a write racing the decode makes the
        # stored token conservative (its rows re-decode next delta and
        # dedup away), never stale
        token = v.scan_token()
        stale = None
        probes = (key, key0) if filter_key else (key0,)
        if spec_key is not None:
            probes = (spec_key,) + probes
        with self._scan_cache_lock:
            for k in probes:
                hit = self._scan_cache.get(k)
                if hit is None:
                    continue
                if hit[0].data_version == v.data_version:
                    self._scan_cache[k] = self._scan_cache.pop(k)  # LRU
                    stages.count("scan_hit")
                    return hit[1]
                if stale is None:
                    stale = (k, hit)
        try:
            if stale is not None:
                b = self._scan_delta(v, stale, token, table, trs, sids,
                                     field_names, page_constraints,
                                     key, key0, n_threads)
                if b is not None:
                    return b
            stages.count("scan_miss")
            with stages.stage("decode_ms"):
                b = scan_vnode(v, table, series_ids=sids, time_ranges=trs,
                               field_names=field_names,
                               page_constraints=page_constraints,
                               n_threads=n_threads,
                               upload_hook=self._upload_hook(),
                               decode_hook=self._decode_hook(),
                               compressed_spec=compressed_spec)
        except ChecksumMismatch as e:
            # quarantine-on-read: drop the corrupt file from the live
            # Version (manifest-durable, excluded from every future scan),
            # invalidate this vnode's cached batches, and mark the vnode
            # BROKEN so scans route to replica alternates until
            # anti-entropy repairs it. Runs HERE (not in the dispatcher)
            # so a remote scan_vnode RPC quarantines on the owning node.
            self._quarantine_on_read(split.owner, split.vnode_id, e)
            raise
        if getattr(b, "_compressed_engaged", False):
            key = spec_key   # lane-shaped batch: valid for this spec only
        elif not getattr(b, "_pages_pruned", False):
            key = key0   # nothing pruned: the batch is the full scan
        self._cache_store(key, token, b)
        return b

    def _scan_delta(self, v, stale, token, table, trs, sids, field_names,
                    page_constraints, key, key0, n_threads):
        """Incremental rescan off a stale cache entry: decode only the
        TSM files / memcache rows the entry's token doesn't cover, merge
        into the cached batch (and its device twin), re-cache under the
        advanced token. → the merged batch, or None when only a full
        rescan is sound (destructive mutation, files compacted away,
        schema drift between the batches)."""
        from ..storage.scan import DeltaVnodeView, merge_scan_batches
        from ..utils import stages

        hit_key, (old, cached, _nb) = stale
        if old.destructive_version != token.destructive_version:
            return None   # tombstones / tag re-keys: no delta can express
        if not (old.file_ids <= token.file_ids):
            return None   # files compacted away: cached rows may be gone
        if getattr(cached, "_compressed_engaged", False):
            # compressed-domain batches pre-answer pages as partials that
            # a merge can't extend — only a full rescan is sound
            return None
        new_fids = token.file_ids - old.file_ids
        if not new_fids and token.mem_seq <= old.mem_seq:
            # nothing actually new (e.g. an L0→L1 promotion kept the same
            # file ids): refresh the token on the cached batch
            stages.count("delta_hit")
            self._cache_store(hit_key, token, cached)
            return cached
        view = DeltaVnodeView(v, new_fids, old.mem_seq)
        with stages.stage("decode_ms"):
            delta = scan_vnode(view, table, series_ids=sids,
                               time_ranges=trs, field_names=field_names,
                               page_constraints=page_constraints,
                               n_threads=n_threads,
                               upload_hook=self._upload_hook(),
                               decode_hook=self._decode_hook())
        cached_pruned = getattr(cached, "_pages_pruned", False)
        pruned = cached_pruned or getattr(delta, "_pages_pruned", False)
        if delta.n_rows == 0:
            merged, gather = cached, None
        else:
            res = merge_scan_batches(cached, delta)
            if res is None:
                return None
            merged, gather = res
            merged._pages_pruned = pruned
            if gather is not None \
                    and getattr(cached, "_device_batch", None) is not None:
                try:
                    from ..ops.device_cache import merged_device_batch

                    with stages.stage("merge_ms"):
                        merged_device_batch(merged, cached, delta, gather)
                except Exception:
                    stages.count_error("scan.device_merge")
        stages.count("delta_hit")
        stages.count("delta_rows", delta.n_rows)
        # a pruned result is only valid for this constraint set: it must
        # live under the filtered key even when the stale hit was the
        # unfiltered fallback entry
        store_key = hit_key if hit_key == key else (key if pruned else key0)
        self._cache_store(store_key, token, merged)
        return merged

    def _cache_store(self, key, token, batch):
        # every batch cached here was decoded by THIS node's scan path:
        # its rows can upload straight onto the execution mesh, so the
        # shard-aware planner (ops/mesh_exec) may claim it. Remote
        # batches (msgpack replies in _scan_remote*) never pass through
        # and stay off-mesh — the executor merges those over the legacy
        # RPC path.
        batch._mesh_local = True
        nb = _batch_nbytes(batch)
        with self._scan_cache_lock:
            old = self._scan_cache.pop(key, None)
            if old is not None:
                self._scan_cache_bytes -= old[2]
            while self._scan_cache and (
                    len(self._scan_cache) >= self.SCAN_CACHE_SIZE
                    or self._scan_cache_bytes + nb
                    > self.SCAN_CACHE_MAX_BYTES):
                lru = next(iter(self._scan_cache))
                self._scan_cache_bytes -= self._scan_cache.pop(lru)[2]
            self._scan_cache[key] = (token, batch, nb)
            self._scan_cache_bytes += nb

    def scan_cache_stats(self) -> tuple[int, int]:
        """→ (entries, bytes) for /metrics."""
        with self._scan_cache_lock:
            return len(self._scan_cache), self._scan_cache_bytes

    def _reclaim_scan_cache(self, target_bytes: int) -> int:
        """Broker reclaim callback: evict LRU entries until
        `target_bytes` are freed (or the cache is empty). Safe to lose
        any entry — snapshots revalidate by ScanToken on the next
        scan."""
        freed = 0
        with self._scan_cache_lock:
            while self._scan_cache and freed < target_bytes:
                lru = next(iter(self._scan_cache))
                freed += self._scan_cache.pop(lru)[2]
            self._scan_cache_bytes = max(0,
                                         self._scan_cache_bytes - freed)
        return freed

    def table_tokens(self, tenant: str, db: str, table: str):
        """Serving-plane invalidation key: the table's schema version plus
        one ScanToken tuple per covering vnode, each captured under that
        vnode's lock. Equality of two captures proves no flush / delete /
        compaction / tier / DDL event touched the table's DATABASE in
        between (vnodes are shared per-database, so a write to a sibling
        table conservatively misses — never serves stale). Walks
        `meta.buckets_for` directly instead of `table_vnodes` to skip the
        per-split tier peek — this runs on every result-cache probe.

        → None when the table is dropped, a covering vnode is replicated
        (the scan may read a replica this capture didn't token), or a
        remote owner can't answer — callers must bypass caching then."""
        schema = self.meta.table_opt(tenant, db, table)
        if schema is None:
            return None
        owner = f"{tenant}.{db}"
        toks: dict = {"schema": getattr(schema, "schema_version", None)}
        seen = set()
        for bucket in self.meta.buckets_for(tenant, db, None, None):
            for rs in bucket.shard_group:
                if len(rs.vnodes) > 1:
                    return None
                vnode_id = rs.leader_vnode_id
                if vnode_id in seen:
                    continue
                seen.add(vnode_id)
                v = self.engine.vnode(owner, vnode_id)
                if v is not None:
                    t = v.scan_token()
                    toks[vnode_id] = (t.data_version,
                                      t.destructive_version,
                                      t.file_ids, t.mem_seq)
                    continue
                if not self.distributed:
                    return None
                info = rs.vnode(vnode_id)
                if info is None:
                    return None
                try:
                    r = self._rpc(info.node_id, "vnode_token",
                                  {"owner": owner, "vnode_id": vnode_id})
                except Exception:
                    return None
                t = r.get("token") if isinstance(r, dict) else None
                if t is None:
                    return None
                toks[vnode_id] = (t["data_version"],
                                  t["destructive_version"],
                                  frozenset(t["file_ids"]), t["mem_seq"])
        return toks

    def _upload_hook(self):
        """Eager-upload factory for the scan pipeline — only when queries
        will actually take the device path; on pure-CPU placements the
        staging copy is wasted work. Placement errors propagate: with no
        CUDA device and no CPU placement asked for, scan_device raises."""
        from ..ops.placement import scan_device
        from ..ops.tpu_exec import _FORCE_DEVICE

        if scan_device().type != "cpu" or _FORCE_DEVICE():
            from ..ops.device_cache import EagerUploader

            return EagerUploader
        return None

    def _decode_hook(self):
        """Device-decode lane factory for the scan pipeline: a fresh
        DeviceDecodeLane per scan when the plane is enabled (a CUDA scan
        device, or forced via CNOSDB_DEVICE_DECODE=1), else None — scans
        then use the native/Python host lanes exactly as before."""
        from ..ops import device_decode

        if device_decode.enabled():
            return device_decode.DeviceDecodeLane
        return None

    def _scan_remote(self, split: PlacedSplit, field_names,
                     fingerprint: str | None = None) -> ScanBatch | None:
        """Scan one split on its owning node, failing over to replica
        alternates (reference opener.rs:84-120 remote open +
        reader/mod.rs:36 broken-replica failover). `fingerprint` tags the
        RPC with the serving-plane query identity so the owning node's
        scan cache + stage counters attribute the work cluster-wide.

        With the gray-failure plane on (the default), failover
        candidates are health-ranked instead of fixed-order and the scan
        is hedged against tail latency; CNOSDB_HEDGE=0 restores the
        legacy byte-identical routing below."""
        targets = [(split.vnode_id, split.node_id)] + list(split.alternates)
        if not health.enabled():
            return self._scan_remote_solo(split, targets, field_names,
                                          fingerprint)
        targets = self._rank_targets(targets, split)
        return self._scan_remote_hedged(split, targets, field_names,
                                        fingerprint)

    def _rank_targets(self, targets: list, split: PlacedSplit) -> list:
        """Health-ranked FAILOVER order for one split's (vnode, node)
        candidates. The planner's primary choice (the live raft leader,
        or its healthy stand-in when the leader is meta-BROKEN) stays
        pinned at the head: leader-follow is what gives scans
        read-your-writes — a follower that hasn't applied the tail of
        the log yet answers with silently-missing rows, so health may
        never promote a replica into the primary slot. Everything
        after the head is health-ordered: local placements first, then
        power-of-two-choices among scorer-HEALTHY replicas, DEGRADED
        next, scorer-BROKEN after — and meta-BROKEN replicas stay
        pinned at the very tail (meta marks them data-suspect; the
        scorer only judges responsiveness, never data state). A
        browned-out leader is not rescued at all: a hedge would read a
        follower (see _scan_remote_hedged); only a leader that does not
        answer fails over, in this order, to the members that confirm the
        read through their read index (_leader_scan)."""
        head, rest = targets[:1], targets[1:]
        live = [t for t in rest if t[0] not in split.broken_ids]
        tail = [t for t in rest if t[0] in split.broken_ids]

        def addr_of(t):
            if t[1] == self.node_id:
                return None
            return self.meta.node_addr(t[1]) or f"node:{t[1]}"

        return head + health.SCORER.rank(live, addr_of) + tail

    def _scan_remote_solo(self, split: PlacedSplit, targets, field_names,
                          fingerprint: str | None = None) -> ScanBatch | None:
        """Legacy fixed-order failover loop (CNOSDB_HEDGE=0 A/B path). A
        replicated set's read is _leader_scan over the same targets: no
        member serves it before it confirms."""
        from .net import RpcError, RpcUnavailable

        last_unreach = None
        last_reject = None

        def scan_here(vnode_id):
            return self._scan_local(PlacedSplit(
                split.owner, vnode_id, split.table, split.time_ranges,
                split.tag_domains), field_names)

        if split.leader_read:
            return self._leader_scan(split, self._scan_payload(
                split, split.vnode_id, field_names, fingerprint), scan_here,
                targets)
        for vnode_id, node_id in targets:
            if node_id == self.node_id:
                if self.engine.vnode(split.owner, vnode_id) is None:
                    # placement says local but the data is absent (dropped /
                    # never installed): other replicas may still have it
                    continue
                return scan_here(vnode_id)
            payload = self._scan_payload(split, vnode_id, field_names,
                                         fingerprint)
            try:
                r = self._rpc(node_id, "scan_vnode", payload)
            except RpcUnavailable as e:
                # this node could not reach the replica: _rpc's breaker
                # and the health scorer book it for this node alone. Meta
                # is every node's catalog, and a mark there would shun
                # the replica cluster-wide after the fault healed
                last_unreach = e
                continue
            except RpcError as e:
                last_reject = e
                continue
            # an answer does not clear a BROKEN mark: a replica whose
            # file was quarantined answers with fewer rows
            return self._decode_reply(r)
        if last_reject is not None:
            # at least one replica ANSWERED and rejected the scan — an
            # app-level error, not an availability problem; its message is
            # the actionable one (e.g. memory-pool rejection)
            msg = (f"scan of vnode {split.vnode_id} of {split.owner} "
                   f"rejected: {last_reject}")
            if last_unreach is not None:
                msg += f" (other replicas unreachable: {last_unreach})"
            raise CoordinatorError(msg) from last_reject
        raise CoordinatorError(
            f"all replicas unreachable for vnode {split.vnode_id} "
            f"of {split.owner}") from last_unreach

    def _hedge_delay_s(self, node_id: int) -> float:
        """Adaptive hedge trigger for an attempt against `node_id`: that
        node's (addr, scan) p95, floored by [query] hedge_delay_ms_floor
        so a microsecond warm-cache p95 can't hedge every call."""
        floor_s = health.HEDGE_DELAY_FLOOR_MS / 1e3
        if node_id == self.node_id:
            return floor_s
        addr = self.meta.node_addr(node_id)
        if not addr:
            return floor_s
        return health.SCORER.hedge_delay(addr, "scan", floor_s=floor_s)

    def _scan_remote_hedged(self, split: PlacedSplit, targets, field_names,
                            fingerprint: str | None = None):
        """Hedged scan over health-ranked targets — the tail-latency
        defense (fires unless CNOSDB_HEDGE=0).

        The best-ranked target is tried exactly as the legacy path
        would; if it hasn't answered within the adaptive hedge delay
        (its (addr, scan) p95, floored by config and capped by the
        remaining Deadline budget), the SAME scan fires at the
        next-ranked replica under a derived child deadline carrying its
        OWN hedge qid. The first success wins bit-identically (replicas
        are raft-converged, and the winner's IPC bytes decode the same
        whoever served them); every other in-flight attempt is
        cancelled through the cancel_scan fan-out, which names only the
        loser's hedge qid so the query's scans of OTHER vnodes are
        untouched. A failed attempt triggers immediate failover to the
        next target — failovers are not hedges and skip the limiter.
        A leader read (every split of a replicated set the planner sent to
        its raft leader, PlacedSplit.leader_read) is never hedged: every
        other replica is a follower that may not have applied the tail
        of the log, and its answer, first in, would miss rows the leader
        acknowledged; such a read waits for the leader, which serves it
        once its read index confirms it (booked as suppressed, reason
        leader_read). It is one attempt, _leader_scan over the targets:
        where the leader does not answer, it asks the other members
        itself, each serving only once its read index confirms the read,
        leader's or follower's.
        Every exit of this lane books into cnosdb_hedge_total
        (hedge-accounting lint rule)."""
        from .net import RpcError, RpcThrottled, RpcUnavailable

        parent = deadline_mod.current()
        base_qid = (parent.qid if parent is not None else None) or "scan"
        resq: queue_mod.Queue = queue_mod.Queue()
        inflight: dict[int, dict] = {}       # attempt idx → {dl, ...}
        hedges_fired = 0
        next_target = 0
        armed = True          # one suppression verdict per scan
        leader_read = split.leader_read
        last_unreach = last_reject = None
        throttled_idxs: list[int] = []   # slow-start-refused targets

        def scan_here(vnode_id):
            return self._scan_local(PlacedSplit(
                split.owner, vnode_id, split.table, split.time_ranges,
                split.tag_domains), field_names)

        def launch(is_hedge: bool, idx: int | None = None,
                   bypass_ramp: bool = False) -> None:
            nonlocal next_target, hedges_fired
            if idx is None:
                idx = next_target
                next_target += 1
            bypass_ramp = bypass_ramp or is_hedge
            vnode_id, node_id = targets[idx]
            with self._hedge_lock:
                self._hedge_seq += 1
                seq = self._hedge_seq
            child = deadline_mod.derived(f"{base_qid}#h{seq}")
            ctx = contextvars.copy_context()   # profile rides along
            holds_slot = is_hedge

            def attempt():
                try:
                    with deadline_mod.scope(child):
                        if leader_read:
                            resq.put((idx, "batch", self._leader_scan(
                                split, self._scan_payload(
                                    split, vnode_id, field_names,
                                    fingerprint), scan_here, targets,
                                hedge=bypass_ramp)))
                            return
                        if node_id == self.node_id:
                            if self.engine.vnode(split.owner,
                                                 vnode_id) is None:
                                # placement says local but the data is
                                # absent (dropped / never installed)
                                resq.put((idx, "skip", None))
                                return
                            resq.put((idx, "batch", scan_here(vnode_id)))
                            return
                        payload = self._scan_payload(split, vnode_id,
                                                     field_names, fingerprint)
                        r = self._rpc(node_id, "scan_vnode", payload,
                                      hedge=bypass_ramp)
                        resq.put((idx, "remote", r))
                except RpcUnavailable as e:
                    # a peer this node cannot reach (booked by _rpc's
                    # breaker and the health scorer, for this node alone:
                    # no mark in meta), or a slow-start ramp refusal that
                    # never contacted it
                    resq.put((idx, "unreach", e))
                except RpcError as e:
                    resq.put((idx, "reject", e))
                except BaseException as e:
                    # deadline expiry / cancel / local engine failure —
                    # the collector decides whether it unwinds the query
                    resq.put((idx, "error", e))
                finally:
                    if holds_slot:
                        self._hedge_limiter.release()

            inflight[idx] = {"dl": child, "vnode_id": vnode_id,
                             "node_id": node_id, "hedge": is_hedge,
                             "t0": time.monotonic()}
            if is_hedge:
                hedges_fired += 1
                health.count_hedge("fired")
                stages.count("hedge.fired")
            threading.Thread(target=ctx.run, args=(attempt,), daemon=True,
                             name=f"hedge-scan-{base_qid}-{seq}").start()

        def abandon(reason: str) -> None:
            """Cancel every still-in-flight attempt (their own hedge
            qids only) and book the cancellations. Each loser's
            elapsed-so-far is fed to the scorer as a censored latency
            sample — the loser IS at least this slow, and waiting for
            its reply to land before learning that would keep routing
            scans at a straggler for a full brownout-latency window."""
            now = time.monotonic()
            for o in inflight.values():
                o["dl"].cancel(reason)
                # best-effort cancel off the query thread: delivering it
                # to the loser synchronously would make every rescued
                # query pay the straggler's latency all over again
                threading.Thread(
                    target=self.cancel_remote_scans, args=(o["dl"],),
                    daemon=True,
                    name=f"hedge-cancel-{base_qid}").start()
                if o["node_id"] != self.node_id:
                    addr = self.meta.node_addr(o["node_id"])
                    if addr:
                        health.SCORER.observe_censored(
                            addr, "scan", now - o["t0"])
                health.count_hedge("cancelled")
                stages.count("hedge.cancelled")
            inflight.clear()

        launch(is_hedge=False)
        while inflight:
            wait_s = None
            if armed and inflight:
                # the hedge trigger is the cheaper of the NEWEST launched
                # attempt's scan p95 and the NEXT candidate's: a hedge is
                # worth firing once the outstanding call is slower than
                # what the alternate typically delivers (so a scan routed
                # to a known-slow replica — stale score, exploration — is
                # rescued at the fast replica's pace, not the slow one's).
                # Capped by the remaining deadline budget.
                wait_s = self._hedge_delay_s(targets[next_target - 1][1])
                if next_target < len(targets):
                    wait_s = min(wait_s,
                                 self._hedge_delay_s(targets[next_target][1]))
                if parent is not None:
                    rem = parent.remaining()
                    if rem is not None:
                        wait_s = min(wait_s, max(rem, 0.0))
            try:
                idx, kind, value = resq.get(timeout=wait_s)
            except queue_mod.Empty:
                # trigger elapsed, attempt still in flight: hedge — or
                # book exactly why not (the suppression accounting is
                # what proves hedging stays tail-only). A target that
                # was refused by the slow-start ramp stays eligible
                # HERE: the ramp gates organic reads, while a hedge is
                # a single limiter-capped rescue probe that bypasses it
                # — without the retry, a ramping replica plus a browned
                # primary leaves the query waiting out the full
                # brownout with no alternate at all.
                retry_idx = None
                if leader_read:
                    health.count_hedge("suppressed", "leader_read")
                    stages.count("hedge.suppressed")
                    armed = False
                    continue
                if next_target >= len(targets):
                    if not throttled_idxs:
                        health.count_hedge("suppressed", "no_alternate")
                        stages.count("hedge.suppressed")
                        armed = False
                        continue
                    retry_idx = throttled_idxs[0]
                rem = parent.remaining() if parent is not None else None
                if parent is not None and (parent.dead()
                                           or (rem is not None
                                               and rem <= 0.05)):
                    # no budget left to pay for a second attempt; the
                    # in-flight socket timeout is capped by the same
                    # budget and will resolve the scan shortly
                    health.count_hedge("suppressed", "no_budget")
                    stages.count("hedge.suppressed")
                    armed = False
                    continue
                if not self._hedge_limiter.try_acquire(
                        health.HEDGE_MAX_INFLIGHT):
                    health.count_hedge("suppressed", "limiter")
                    stages.count("hedge.suppressed")
                    armed = False
                    continue
                if retry_idx is not None:
                    throttled_idxs.pop(0)
                launch(is_hedge=True, idx=retry_idx)
                continue
            a = inflight.pop(idx, None)
            if a is None:     # late result of an already-settled attempt
                continue
            if kind in ("batch", "remote"):
                won_by_hedge = a["hedge"]
                abandon("hedge loser")
                if won_by_hedge:
                    health.count_hedge("won")
                    stages.count("hedge.won")
                lost = hedges_fired - (1 if won_by_hedge else 0)
                if lost > 0:
                    health.count_hedge("lost", n=lost)
                # a loser's reply is never decoded nor charged
                return value if kind == "batch" else self._decode_reply(value)
            if kind == "error" and not a["hedge"]:
                # primary-lineage failure of the typed kind the legacy
                # loop propagates immediately (deadline gone, cancel,
                # local checksum damage): unwind instead of retrying
                # replicas with a budget/state that is already dead
                if hedges_fired:
                    health.count_hedge("lost", n=hedges_fired)
                abandon("hedge abort")
                raise value
            # failed / skipped attempt: record and fail over
            if kind == "unreach":
                last_unreach = value
                if isinstance(value, RpcThrottled):
                    throttled_idxs.append(idx)   # hedge may retry it
            elif kind in ("reject", "error"):
                last_reject = value
            if not inflight:
                if next_target < len(targets):
                    launch(is_hedge=False)   # failover, not a hedge
                elif throttled_idxs:
                    # nothing left but ramp-refused targets: a refusal
                    # is load-shedding, not unavailability — retry past
                    # the ramp rather than failing the whole scan
                    launch(is_hedge=False, idx=throttled_idxs.pop(0),
                           bypass_ramp=True)
        if hedges_fired:
            health.count_hedge("lost", n=hedges_fired)
        if last_reject is not None:
            # at least one replica ANSWERED and rejected the scan — an
            # app-level error, not an availability problem
            stages.count_error("hedge.exhausted")
            msg = (f"scan of vnode {split.vnode_id} of {split.owner} "
                   f"rejected: {last_reject}")
            if last_unreach is not None:
                msg += f" (other replicas unreachable: {last_unreach})"
            raise CoordinatorError(msg) from last_reject
        stages.count_error("hedge.exhausted")
        raise CoordinatorError(
            f"all replicas unreachable for vnode {split.vnode_id} "
            f"of {split.owner}") from last_unreach

    def cancel_remote_scans(self, dl) -> int:
        """Best-effort cancel fan-out: tell every node this request sent
        work to (recorded in `dl.remote_nodes` by `_rpc`) to stop scans
        for its qid. Fired on KILL QUERY, deadline expiry, and HTTP
        client disconnect. Runs with the deadline scope CLEARED — the
        whole point is that the request's own budget is already dead.
        Returns the number of nodes that acknowledged."""
        from .net import RpcError, rpc_call

        if dl is None or not dl.qid:
            return 0
        acked = 0
        with deadline_mod.scope(None):
            for addr in list(dl.remote_nodes):
                try:
                    rpc_call(addr, "cancel_scan", {"qid": dl.qid},
                             timeout=1.0)
                    acked += 1
                except RpcError:
                    pass  # best-effort: the node may be gone already
        return acked

    # ---------------------------------------------------------------- admin
    def drop_table(self, tenant: str, db: str, table: str):
        self.meta.drop_table(tenant, db, table)

    def drop_database(self, tenant: str, db: str,
                      if_exists: bool = True):
        self.meta.drop_database(tenant, db, if_exists=if_exists)

    def _mark_vnode_broken(self, vnode_id: int):
        """Data-suspect marking (reference reader/mod.rs:36
        CheckedCoordinatorRecordBatchStream → Broken status) after a
        quarantine on read or by the scrubber; readers then prefer
        RUNNING replicas until the anti-entropy repair clears the mark.
        A replica one node cannot reach is not marked: that is the node's
        own health scorer's to judge. Skips the meta write when already
        marked — repeated corruption hits must not turn into O(catalog)
        meta broadcasts."""
        from ..models.meta_data import VnodeStatus

        try:
            hit = self.meta.find_vnode(vnode_id)
            if hit is not None and hit[3].status == VnodeStatus.BROKEN:
                return
            self.meta.update_vnode(vnode_id, status=int(VnodeStatus.BROKEN))
        except Exception:
            stages.count_error("swallow.coord.mark_vnode_broken")  # advisory only; the scan already failed over

    def _clear_vnode_broken(self, vnode_id: int):
        from ..models.meta_data import VnodeStatus

        try:
            self.meta.update_vnode(vnode_id, status=int(VnodeStatus.RUNNING))
        except Exception:
            stages.count_error("swallow.coord.clear_vnode_broken")

    # ---------------------------------------------------------------- admin
    def move_vnode(self, vnode_id: int, to_node: int):
        """MOVE VNODE <id> TO NODE <n> (reference raft/manager.rs:323-566 +
        DownloadFile snapshot shipping): copy the data, flip placement,
        drop the source copy. Placement flips LAST so a failure at any
        earlier step leaves the original intact (the ResourceManager
        retry contract collapses to at-most-once placement mutation)."""
        hit = self.meta.find_vnode(vnode_id)
        if hit is None:
            raise CoordinatorError(f"unknown vnode {vnode_id}")
        owner, _b, rs, v = hit
        src_node = v.node_id
        if src_node == to_node:
            return
        if self.meta.node_addr(to_node) is None and self.distributed:
            raise CoordinatorError(f"unknown target node {to_node}")
        if len(rs.vnodes) > 1:
            # placement move of one raft MEMBER: same member id, new home.
            # Yield leadership if it leads, tear the member down at the
            # source (its WAL dies with the data), flip placement as
            # COPYING — readers must not trust the gutted replica until
            # the leader rebuilds it via log replay or file-level snapshot
            # install (reference manager.rs move = add_follower + remove).
            from ..models.meta_data import VnodeStatus

            self._replica_stepdown(owner, rs, vnode_id)
            if src_node == self.node_id or not self.distributed:
                if self._replica_mgr is not None:
                    self._replica_mgr.stop_member(owner, rs.id, vnode_id)
                self.engine.drop_vnode(owner, vnode_id)
            else:
                try:
                    self._rpc(src_node, "vnode_drop",
                              {"owner": owner, "vnode_id": vnode_id,
                               "rs_id": rs.id})
                except Exception:
                    stages.count_error("swallow.coord.vnode_drop_rpc")  # source unreachable: placement is authoritative
            self.meta.update_vnode(vnode_id, node_id=to_node,
                                   status=int(VnodeStatus.COPYING))
            hit2 = self.meta.find_replica_set(rs.id)
            rs2 = hit2[1] if hit2 is not None else rs
            self._wait_member_caught_up(owner, rs2, vnode_id,
                                        what=f"moved replica {vnode_id}")
            self.meta.update_vnode(vnode_id, status=int(VnodeStatus.RUNNING))
            return
        data = self._fetch_vnode_snapshot(owner, vnode_id, src_node)
        if data is not None:
            self._install_vnode_snapshot(owner, vnode_id, to_node, data)
        self.meta.update_vnode(vnode_id, node_id=to_node, status=0)
        try:
            if src_node == self.node_id:
                self.engine.drop_vnode(owner, vnode_id)
            elif self.distributed:
                self._rpc(src_node, "vnode_drop",
                          {"owner": owner, "vnode_id": vnode_id})
        except Exception:
            stages.count_error("swallow.coord.vnode_drop_rpc")  # orphaned source data is garbage, not corruption

    def copy_vnode(self, vnode_id: int, to_node: int) -> int:
        """COPY VNODE <id> TO NODE <n>: add a replica seeded from a
        snapshot (reference REPLICA ADD + add_follower). Restricted to
        non-raft (single-replica) sets — raft membership change is the
        round-3 path."""
        hit = self.meta.find_vnode(vnode_id)
        if hit is None:
            raise CoordinatorError(f"unknown vnode {vnode_id}")
        owner, _b, rs, v = hit
        if len(rs.vnodes) > 1:
            return self._copy_into_replicated(owner, rs, to_node)
        from ..models.meta_data import VnodeStatus

        data = self._fetch_vnode_snapshot(owner, vnode_id, v.node_id)
        # register as COPYING so readers skip it, install, THEN go RUNNING;
        # a failed install rolls the placeholder back out
        new_id = self.meta.add_replica_vnode(rs.id, to_node,
                                             status=int(VnodeStatus.COPYING))
        try:
            if data is not None:
                self._install_vnode_snapshot(owner, new_id, to_node, data)
            # the RUNNING flip is part of the same all-or-nothing publish:
            # a replica stranded in COPYING would hold storage but never
            # serve reads
            self.meta.update_vnode(new_id, status=int(VnodeStatus.RUNNING))
        except Exception:
            try:
                self.meta.remove_replica_vnode(new_id)
            except Exception:
                stages.count_error("swallow.coord.remove_placeholder")  # meta unreachable: placeholder stays; retryable
            raise
        return new_id

    def _copy_into_replicated(self, owner: str, rs, to_node: int) -> int:
        """REPLICA ADD on a live raft group: grow the placement (COPYING),
        extend the raft config via the leader, let the new member catch up
        from the log / a file-level snapshot, then publish it RUNNING
        (reference manager.rs:323-566 add_follower → wait → promote)."""
        from ..models.meta_data import VnodeStatus

        new_id = self.meta.add_replica_vnode(rs.id, to_node,
                                             status=int(VnodeStatus.COPYING))
        hit = self.meta.find_replica_set(rs.id)
        if hit is None:  # placement vanished under us
            raise CoordinatorError(f"replica set {rs.id} disappeared")
        rs_new = hit[1]
        members = sorted({v.id for v in rs.vnodes} | {new_id})
        try:
            self._replica_change_membership(owner, rs_new, members)
            self._wait_member_caught_up(owner, rs_new, new_id,
                                        what=f"new replica {new_id}")
            self.meta.update_vnode(new_id, status=int(VnodeStatus.RUNNING))
            return new_id
        except Exception:
            # roll back: shrink the config (best effort) and remove the
            # COPYING placeholder so readers/writers never trust it
            try:
                self._replica_change_membership(
                    owner, rs_new, sorted(v.id for v in rs.vnodes),
                    timeout=5.0)
            except Exception:
                stages.count_error("swallow.coord.membership_rollback")
            try:
                self.meta.remove_replica_vnode(new_id)
            except Exception:
                stages.count_error("swallow.coord.remove_placeholder")
            raise

    def _wait_member_caught_up(self, owner: str, rs, vnode_id: int,
                               what: str, timeout: float = 45.0) -> None:
        """Block until the member has ACKED a freshly-proposed no-op.

        The leader's match_index can hold a STALE pre-rebuild value (it is
        assigned, not monotonically validated, and nothing resets it when
        a member is gutted and rebuilt) — so catching up is proven by the
        member acknowledging an entry proposed AFTER the change: raft's
        consistency check means it can only ack an index whose whole log
        prefix (or snapshot) it actually holds."""
        from ..storage.wal import WalEntryType

        target = self._write_replicated(owner, rs, WalEntryType.RAFT_BLANK,
                                        b"", sync=False)
        deadline = time.monotonic() + timeout
        bo = Backoff(initial=0.05, cap=1.0)
        while True:
            pr = self._replica_progress(owner, rs, vnode_id)
            if pr is not None and pr[0] >= target:
                return
            if time.monotonic() > deadline:
                raise CoordinatorError(
                    f"{what} has not caught up (stays COPYING, unread; "
                    f"retry the admin op to re-check)")
            bo.sleep(deadline)

    def drop_replica(self, vnode_id: int):
        """REPLICA REMOVE: shrink the raft config via the leader (the
        member yields leadership first if it holds it), update placement,
        tear down the raft member, then drop the data on the OWNING node
        (node-aware — the vnode may not be local). A live raft ticker
        would recreate the WAL the drop removes, so the member stops
        before the data drop."""
        hit = self.meta.find_vnode(vnode_id)
        if hit is None:
            raise CoordinatorError(f"unknown vnode {vnode_id}")
        owner, _b, rs, v = hit
        node = v.node_id
        survivor_to_stop = None
        if len(rs.vnodes) > 2:
            members = sorted(x.id for x in rs.vnodes if x.id != vnode_id)
            self._replica_stepdown(owner, rs, vnode_id)
            self._replica_change_membership(owner, rs, members)
        elif len(rs.vnodes) == 2:
            # dropping to a single replica: the survivor leaves consensus
            # entirely (single-vnode sets bypass raft), so no config-change
            # commit is needed — its member stops AFTER placement updates
            # (a write racing the update must not rebuild it)
            survivor_to_stop = next(x for x in rs.vnodes if x.id != vnode_id)
            self._replica_stepdown(owner, rs, vnode_id)
        self.meta.remove_replica_vnode(vnode_id)
        if survivor_to_stop is not None:
            # stop the member WHERE IT LIVES — otherwise a remote survivor
            # keeps a live raft ticker on the same WAL the direct write
            # path now appends to
            if survivor_to_stop.node_id == self.node_id \
                    or not self.distributed:
                if self._replica_mgr is not None:
                    self._replica_mgr.stop_member(owner, rs.id,
                                                  survivor_to_stop.id)
            else:
                try:
                    self._rpc(survivor_to_stop.node_id, "replica_stop_member",
                              {"owner": owner, "rs_id": rs.id,
                               "vnode_id": survivor_to_stop.id})
                except Exception:
                    stages.count_error("swallow.coord.replica_stop_member")  # stale member is inert once placement updated
        if self._replica_mgr is not None:
            self._replica_mgr.stop_member(owner, rs.id, vnode_id)
        if node == self.node_id or not self.distributed:
            self.engine.drop_vnode(owner, vnode_id)
        else:
            try:
                self._rpc(node, "vnode_drop",
                          {"owner": owner, "vnode_id": vnode_id,
                           "rs_id": rs.id})
            except Exception:
                stages.count_error("swallow.coord.vnode_drop_rpc")  # orphaned data is garbage, placement is authoritative

    def destroy_replica_set(self, rs_id: int):
        """REPLICA DESTORY: tear down a (damaged) replica set wholesale —
        stop every member, remove the set from placement, drop the data
        (reference parser.rs:2046; manager.rs destory_replica_group)."""
        hit = self.meta.find_replica_set(rs_id)
        if hit is None:
            raise CoordinatorError(f"unknown replica set {rs_id}")
        owner, rs = hit
        removed = self.meta.remove_replica_set(rs_id)
        for v in removed:
            if v.node_id == self.node_id or not self.distributed:
                if self._replica_mgr is not None:
                    self._replica_mgr.stop_member(owner, rs_id, v.id)
                self.engine.drop_vnode(owner, v.id)
            else:
                try:
                    self._rpc(v.node_id, "vnode_drop",
                              {"owner": owner, "vnode_id": v.id,
                               "rs_id": rs_id})
                except Exception:
                    stages.count_error("swallow.coord.vnode_drop_rpc")  # unreachable node: placement is authoritative

    def compact_vnode(self, vnode_id: int):
        """COMPACT VNODE on whichever node owns it."""
        hit = self.meta.find_vnode(vnode_id)
        if hit is None:
            raise CoordinatorError(f"unknown vnode {vnode_id}")
        owner, _b, _rs, v = hit
        if v.node_id == self.node_id or not self.distributed:
            vn = self.engine.vnode(owner, vnode_id)
            if vn is not None:
                vn.compact_major()
        else:
            self._rpc(v.node_id, "vnode_compact",
                      {"owner": owner, "vnode_id": vnode_id})
        try:
            from ..server import serving

            serving.invalidate_owner(owner)
        except Exception:
            stages.count_error("serving.invalidate")

    def checksum_group(self, rs_id: int) -> list[tuple[int, int, str]]:
        """Per-replica content checksums for one replica set (reference
        compaction/check.rs ChecksumGroup): replicas must agree regardless
        of their physical flush/compaction state."""
        hit = self.meta.find_replica_set(rs_id)
        if hit is None:
            raise CoordinatorError(f"unknown replica set {rs_id}")
        owner, rs = hit
        out = []
        for v in rs.vnodes:
            if v.node_id == self.node_id or not self.distributed:
                vn = self.engine.vnode(owner, v.id)
                cs = vn.checksum() if vn is not None else ""
            else:
                try:
                    cs = self._rpc(v.node_id, "vnode_checksum",
                                   {"owner": owner, "vnode_id": v.id}) \
                        .get("checksum", "")
                except Exception:
                    cs = "<unreachable>"
            out.append((v.id, v.node_id, cs))
        return out

    # ------------------------------------------------------- integrity
    def _drop_vnode_cache_entries(self, owner: str, vnode_id: int) -> None:
        """Evict every cached ScanBatch of one vnode (quarantine/repair
        changed its on-disk truth; the data_version bump would catch a
        probe, but the entries must not pin memory either)."""
        with self._scan_cache_lock:
            for k in [k for k in self._scan_cache
                      if k[0] == owner and k[1] == vnode_id]:
                self._scan_cache_bytes -= self._scan_cache.pop(k)[2]

    def _quarantine_on_read(self, owner: str, vnode_id: int, exc) -> None:
        """A ChecksumMismatch surfaced during a scan: quarantine the
        offending TSM file and mark the vnode BROKEN. Advisory best-effort
        — the scan is failing over regardless."""
        from ..storage import scrub

        scrub.count("corruptions_detected")
        path = (getattr(exc, "ctx", None) or {}).get("path")
        try:
            v = self.engine.vnode(owner, vnode_id)
            if v is not None and path \
                    and v.quarantine_file(path=path) is not None:
                scrub.count("files_quarantined")
                log.warning("quarantined corrupt file %s on vnode %s",
                            path, vnode_id)
        except Exception:
            log.exception("quarantine of %s failed", path)
        self._drop_vnode_cache_entries(owner, vnode_id)
        self._mark_vnode_broken(vnode_id)
        self._stepdown_quarantined(vnode_id)

    def on_scrub_corruption(self, owner: str, vnode_id: int,
                            paths: list[str]) -> None:
        """Scrubber bridge (storage/scrub.py Scrubber on_corruption): the
        sweep already quarantined the files; finish the read-side story —
        evict cached batches and route scans away until repair."""
        self._drop_vnode_cache_entries(owner, vnode_id)
        self._mark_vnode_broken(vnode_id)
        self._stepdown_quarantined(vnode_id)

    def _stepdown_quarantined(self, vnode_id: int) -> None:
        """If the quarantined replica leads its raft group, step it down:
        file_snapshot() refuses to serve while quarantine evidence exists
        (a quarantined state machine diverged from its applied log), so a
        leader that later needed the snapshot fallback could never catch a
        follower up. A healthy peer should lead until repair. Advisory —
        the refusal alone already guarantees safety."""
        if self._replica_mgr is None:
            return
        try:
            hit = self.meta.find_vnode(vnode_id)
            if hit is not None:
                owner, _bucket, rs, _v = hit
                if self._replica_mgr.stepdown_local(owner, rs, vnode_id):
                    log.warning("stepped down quarantined raft leader "
                                "vnode %s", vnode_id)
        except Exception:
            log.exception("stepdown of quarantined vnode %s failed",
                          vnode_id)

    def anti_entropy_sweep(self) -> dict:
        """Cross-replica repair loop: for every multi-replica set, compare
        content checksums (checksum_group); rebuild each minority-divergent
        replica (bit rot, quarantined files, missed writes) from a majority
        peer via the vnode snapshot machinery, re-verify convergence, and
        clear its BROKEN mark (reference compaction/check.rs checksum admin
        + raft snapshot install, composed into an anti-entropy pass)."""
        report = {"checked": 0, "repaired": [], "failed": []}
        for owner in sorted(getattr(self.meta, "databases", {})):
            tenant, _, db = owner.partition(".")
            try:
                buckets = self.meta.buckets_for(tenant, db)
            except Exception:
                continue
            for bucket in buckets:
                for rs in bucket.shard_group:
                    if len(rs.vnodes) < 2:
                        continue
                    report["checked"] += 1
                    try:
                        self._repair_replica_set(owner, rs, report)
                    except Exception:
                        log.exception("anti-entropy on replica set %s "
                                      "failed", rs.id)
        return report

    def _replica_checksum(self, owner: str, vnode_id: int, node: int) -> str:
        if node == self.node_id or not self.distributed:
            v = self.engine.vnode(owner, vnode_id)
            return v.checksum() if v is not None else ""
        try:
            return self._rpc(node, "vnode_checksum",
                             {"owner": owner, "vnode_id": vnode_id}) \
                .get("checksum", "")
        except Exception:
            return "<unreachable>"

    def _repair_replica_set(self, owner: str, rs, report: dict) -> None:
        from collections import Counter

        from ..storage import scrub

        group = self.checksum_group(rs.id)
        usable = [(vid, nid, cs) for vid, nid, cs in group
                  if cs and cs != "<unreachable>"]
        if len(usable) < 2:
            return
        majority, votes = Counter(
            cs for _, _, cs in usable).most_common(1)[0]
        if votes * 2 <= len(usable):
            return  # no majority: cannot tell who holds the truth
        donors = [(vid, nid) for vid, nid, cs in usable if cs == majority]
        for vid, nid in ((v, n) for v, n, cs in usable if cs != majority):
            ok = False
            for d_vid, d_nid in donors:
                try:
                    data = self._fetch_vnode_snapshot(owner, d_vid, d_nid)
                    if data is None:
                        continue
                    self._install_vnode_snapshot(owner, vid, nid, data)
                    # converged = the repaired replica now matches its
                    # donor's CURRENT checksum (the donor may have taken
                    # writes since the group was sampled)
                    cs2 = self._replica_checksum(owner, vid, nid)
                    ok = bool(cs2) and cs2 != "<unreachable>" \
                        and cs2 == self._replica_checksum(owner, d_vid, d_nid)
                except Exception:
                    log.exception("repair of vnode %s from %s failed",
                                  vid, d_vid)
                    ok = False
                if ok:
                    break
            if not ok and (nid == self.node_id or not self.distributed):
                # no healthy peer could seed this replica: the cold tier
                # is the replica of last resort — rebuild sidecars from
                # the object store and re-vote
                if self._recover_cold(owner, vid):
                    cs2 = self._replica_checksum(owner, vid, nid)
                    ok = bool(cs2) and cs2 == majority
            if ok:
                scrub.count("repairs_ok")
                self._drop_vnode_cache_entries(owner, vid)
                self._clear_vnode_broken(vid)
                report["repaired"].append(vid)
                log.info("anti-entropy repaired vnode %s of %s", vid, owner)
            else:
                scrub.count("repairs_failed")
                report["failed"].append(vid)

    def copy_vnode_to_set(self, rs_id: int, to_node: int) -> int:
        """REPLICA ADD ON <rs> NODE <n>: seed a new replica from the set's
        current leader vnode."""
        hit = self.meta.find_replica_set(rs_id)
        if hit is None:
            raise CoordinatorError(f"unknown replica set {rs_id}")
        _owner, rs = hit
        return self.copy_vnode(rs.leader_vnode_id, to_node)

    def _fetch_vnode_snapshot(self, owner: str, vnode_id: int,
                              node: int) -> bytes | None:
        from .replica import VnodeStateMachine

        if node == self.node_id or not self.distributed:
            v = self.engine.vnode(owner, vnode_id)
            return VnodeStateMachine(v).snapshot() if v is not None else None
        return self._rpc(node, "vnode_snapshot",
                         {"owner": owner, "vnode_id": vnode_id}).get("data")

    def _install_vnode_snapshot(self, owner: str, vnode_id: int, node: int,
                                data: bytes):
        from .replica import VnodeStateMachine

        if node == self.node_id or not self.distributed:
            v = self.engine.open_vnode(owner, vnode_id)
            VnodeStateMachine(v).install_snapshot(data, 0, 0)
        else:
            self._rpc(node, "vnode_install",
                      {"owner": owner, "vnode_id": vnode_id, "data": data})

    # ------------------------------------------------------------ disaster
    # recovery: BACKUP / RESTORE fan-out (storage/backup.py owns the
    # archive-store mechanics; the coordinator supplies cluster routing)
    def backup_database(self, tenant: str, db: str,
                        incremental: bool = False) -> dict:
        """BACKUP DATABASE: cut every leader placement (remote ones via
        the backup_cut RPC) into one consistent, meta-recorded backup."""
        from ..storage import backup

        owner = f"{tenant}.{db}"

        def fetch_cut(vnode_id: int, node_id: int):
            if node_id == self.node_id or not self.distributed:
                return None       # engine.vnode already said "not here"
            reply = self._rpc(node_id, "backup_cut",
                              {"owner": owner, "vnode_id": vnode_id},
                              timeout=60.0)
            return reply.get("cut")

        return backup.create_backup(self.meta, self.engine, tenant, db,
                                    incremental=incremental,
                                    fetch_cut=fetch_cut)

    def restore_database(self, tenant: str, db: str,
                         backup_id: str | None = None,
                         to_ts: int | None = None,
                         new_name: str | None = None) -> dict:
        """RESTORE DATABASE [TO TIMESTAMP] [AS]: manifest → per-placement
        install, routed to whichever node owns each target vnode."""
        from ..storage import backup

        return backup.restore_backup(
            self.meta, self.engine, tenant, db, backup_id=backup_id,
            to_ts=to_ts, new_name=new_name,
            install=self._install_restored_vnode)

    def _install_restored_vnode(self, owner: str, vnode_id: int, vn: dict,
                                snap: dict, entries: list) -> None:
        from ..storage import backup

        hit = self.meta.find_vnode(vnode_id)
        node = hit[3].node_id if hit is not None else self.node_id
        if node == self.node_id or not self.distributed:
            backup.install_vnode(self.engine, owner, vnode_id, snap,
                                 entries)
        else:
            self._rpc(node, "restore_vnode",
                      {"owner": owner, "vnode_id": vnode_id, "snap": snap,
                       "entries": entries}, timeout=60.0)
        # the restored vnode's bytes changed under every cached scan
        self._drop_vnode_cache_entries(owner, vnode_id)

    def _peer_nodes(self, tenant: str, db: str) -> list[int]:
        """Other nodes hosting vnodes of this database."""
        if not self.distributed:
            return []
        nodes = set()
        for bucket in self.meta.buckets_for(tenant, db):
            for rs in bucket.shard_group:
                for v in rs.vnodes:
                    if v.node_id != self.node_id:
                        nodes.add(v.node_id)
        return sorted(nodes)

    def delete_from_table(self, tenant: str, db: str, table: str,
                          tag_domains: ColumnDomains, min_ts: int, max_ts: int):
        """Replicated sets delete through the raft log (the entry carries
        the tag predicate, resolved at apply time on every replica, so a
        down follower replays it on rejoin); single-replica vnodes delete
        directly, and an unreachable owner fails the statement — a silent
        skip would resurrect rows later."""
        owner = f"{tenant}.{db}"
        if not self.distributed:
            self.delete_local(owner, table, tag_domains, min_ts, max_ts)
            return
        import msgpack

        from ..storage.wal import WalEntryType
        from .net import RpcError, RpcUnavailable

        payload = msgpack.packb(
            {"table": table, "doms": tag_domains.to_wire(),
             "min_ts": min_ts, "max_ts": max_ts}, use_bin_type=True)
        failed = []
        for bucket in self.meta.buckets_for(tenant, db):
            for rs in bucket.shard_group:
                if len(rs.vnodes) > 1:
                    self._write_replicated(
                        owner, rs, WalEntryType.DELETE_TIME_RANGE, payload,
                        sync=False)
                    continue
                for v in rs.vnodes:
                    if v.node_id == self.node_id:
                        self.delete_vnode_local(owner, v.id, table,
                                                tag_domains, min_ts, max_ts)
                    else:
                        try:
                            self._rpc(v.node_id, "delete_vnode_range", {
                                "owner": owner, "vnode_id": v.id,
                                "table": table,
                                "doms": tag_domains.to_wire(),
                                "min_ts": min_ts, "max_ts": max_ts})
                        except (RpcUnavailable, RpcError) as e:
                            failed.append((v.node_id, e))
        if failed:
            raise CoordinatorError(
                f"delete failed on nodes {[n for n, _ in failed]}: "
                f"{failed[0][1]}")

    def delete_vnode_local(self, owner: str, vnode_id: int, table: str,
                           doms: ColumnDomains, min_ts: int, max_ts: int):
        v = self.engine.vnode(owner, vnode_id)
        if v is None:
            return
        sids = None
        if not doms.is_all:
            sids = v.index.get_series_ids_by_domains(table, doms)
            if len(sids) == 0:
                return
        v.delete_time_range(table, sids, min_ts, max_ts)

    def delete_local(self, owner: str, table: str,
                     tag_domains: ColumnDomains, min_ts: int, max_ts: int):
        for v in self.engine.local_vnodes(owner):
            sids = None
            if not tag_domains.is_all:
                sids = v.index.get_series_ids_by_domains(table, tag_domains)
                if len(sids) == 0:
                    continue
            v.delete_time_range(table, sids, min_ts, max_ts)

    def tag_values(self, tenant: str, db: str, table: str, tag_key: str) -> list[str]:
        """Index fan-out; an unreachable owner fails the query — a silent
        skip would return partial values as if complete — and so does a
        node whose member of a replicated set cannot confirm the read
        (_confirm_members)."""
        out = set(self.tag_values_local(f"{tenant}.{db}", table, tag_key))
        from .net import RpcError, RpcUnavailable

        for nid in self._peer_nodes(tenant, db):
            try:
                r = self._rpc(nid, "tag_values", {
                    "owner": f"{tenant}.{db}", "table": table,
                    "tag_key": tag_key})
                out.update(r.get("values", []))
            except (RpcUnavailable, RpcError) as e:
                raise CoordinatorError(
                    f"tag scan failed on node {nid}: {e}") from e
        return sorted(out)

    def _confirm_members(self, owner: str, vnodes) -> None:
        """Before a read of the local `vnodes`' indexes: each that is a
        member of a replicated set confirms the read through its read
        index, leader's or follower's alike (confirm_read; the members in
        parallel), so that it has applied what its group committed before
        the read arrived. CoordinatorError, the leader-read error, where
        one cannot: the node's answer would be the member's past state.
        A single-replica vnode is read as it is."""
        from ..utils import executor

        vids = []
        for v in vnodes:
            hit = self.meta.find_vnode(v.vnode_id)
            if hit is not None and len(hit[2].vnodes) > 1:
                vids.append(v.vnode_id)
        if not vids:
            return
        replies = executor.run_all(
            "scan", lambda vid: self.confirm_read(owner, vid, follower=True),
            vids)
        refused = [(vid, r.get("hint"))
                   for vid, r in zip(vids, replies) if r is not None]
        if refused:
            raise CoordinatorError(
                f"no raft leader of the replica set of vnode "
                f"{refused[0][0]} of {owner} confirmed an index read on "
                f"node {self.node_id} (refused by vnodes, hints: "
                f"{refused})")

    def tag_values_local(self, owner: str, table: str, tag_key: str) -> list[str]:
        out = set()
        vnodes = self.engine.local_vnodes(owner)
        self._confirm_members(owner, vnodes)
        for v in vnodes:
            out.update(v.index.tag_values(table, tag_key))
        return sorted(out)

    def series_keys(self, tenant: str, db: str, table: str,
                    tag_domains: ColumnDomains | None = None) -> list:
        doms = tag_domains or ColumnDomains.all()
        keys = {}
        for k in self.series_keys_local(f"{tenant}.{db}", table, doms):
            keys[(k.table, k.tags)] = k
        from ..models.series import SeriesKey
        from .net import RpcError, RpcUnavailable

        for nid in self._peer_nodes(tenant, db):
            try:
                r = self._rpc(nid, "series_keys", {
                    "owner": f"{tenant}.{db}", "table": table,
                    "doms": doms.to_wire()})
                for raw in r.get("keys", []):
                    k = SeriesKey.decode(raw)
                    keys[(k.table, k.tags)] = k
            except (RpcUnavailable, RpcError) as e:
                raise CoordinatorError(
                    f"series scan failed on node {nid}: {e}") from e
        return [keys[k] for k in sorted(keys)]

    def series_keys_local(self, owner: str, table: str,
                          doms: ColumnDomains) -> list:
        keys = {}
        vnodes = self.engine.local_vnodes(owner)
        self._confirm_members(owner, vnodes)
        for v in vnodes:
            for sid in v.index.get_series_ids_by_domains(table, doms):
                k = v.index.get_series_key(int(sid))
                if k is not None:
                    keys[(k.table, k.tags)] = k
        return [keys[k] for k in sorted(keys)]


def _batch_nbytes(b: ScanBatch) -> int:
    """Host footprint of a cached ScanBatch (cache byte accounting).
    Dictionary-encoded string columns count codes + a per-unique-value
    estimate; exactness doesn't matter, monotonicity does."""
    n = int(b.ts.nbytes) + int(b.sid_ordinal.nbytes) \
        + int(b.series_ids.nbytes)
    for _name, (_vt, vals, valid) in b.fields.items():
        codes = getattr(vals, "codes", None)
        if codes is not None:   # DictArray
            n += int(codes.nbytes)
            n += sum(len(str(x)) + 49 for x in vals.values)
        else:
            n += int(vals.nbytes)
        n += int(valid.nbytes)
    return n
