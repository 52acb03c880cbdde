"""Per-query stage profiling — the always-on instrumentation plane.

Every `stage()` / `count()` call lands in the *active query's*
:class:`QueryProfile` (a contextvar installed at ingress by the SQL
executor, by `EXPLAIN ANALYZE`, or by bench.py). With no profile in
scope `count()` is a single contextvar read. `stage()` is the one way
to time a piece of work: besides the profile, it records a span of the
same name on the process timeline (below), profile or not, as a child
of the context span; `waited()` records a wait handed from one thread
to another the same way. Both cost a few microseconds, cheap
enough to leave on at the grain they are used (a request, a vnode, a
flush, a compaction; never a page, a row or a kernel launch). Profiles
propagate:

  * across the shared scan/decode pools (utils/executor.py re-runs each
    task inside the submitting thread's contextvars.Context), and
  * across RPC hops (parallel/net.py adds a `_profile` marker to the
    payload; the remote handler runs inside its own node-local profile
    and returns it in the reply, where the caller folds it into the
    active profile's `subprofiles`, keyed by node/vnode/method).

Consumers: `EXPLAIN ANALYZE` renders the merged per-stage/per-node
breakdown, HTTP exposes an opt-in summary header plus
`GET /debug/profile?qid=` over the bounded `PROFILES` ring, finished
profiles attach to their root trace span as tags, and the slow-query
log writes threshold-exceeding profiles into usage_schema.

Stage catalog — every *literal* name passed to stage()/count() must
appear in STAGE_CATALOG (enforced by the `stage-catalog` lint rule in
cnosdb_tpu/analysis); dynamically-built names must use a prefix from
DYNAMIC_STAGE_PREFIXES. Keys ending in `_ms` are durations, `_bytes`
byte totals; everything else is a plain count.
"""
from __future__ import annotations

import contextvars
import itertools
import secrets
import threading
import time
from collections import deque
from . import lockwatch

# The documented profile schema. A name missing here is invisible to
# every dashboard/bench consumer, so the lint plane refuses it.
STAGE_CATALOG: dict[str, str] = {
    "scan_hit": "coordinator scan-snapshot cache hits",
    "scan_miss": "coordinator scan-snapshot cache misses (full decode)",
    "delta_hit": "stale cache entries refreshed by decoding only the "
                 "new TSM files / memcache rows since their token",
    "delta_rows": "rows decoded by delta scans (a full rescan's worth "
                  "means tokens are being invalidated)",
    "decode_ms": "TSM read+decode (cache-miss and delta scans)",
    "device_decode_ms": "batched device codec kernels within a scan "
                        "(the accelerator half of decode_ms)",
    "device_decode_engagements": "pages decoded by the device-decode "
                                 "lane instead of a host lane",
    "upload_ms": "host→device column uploads",
    "upload_bytes": "bytes moved host→device by those uploads",
    "kernel_ms": "fused segment-aggregate kernels",
    "merge_ms": "cross-vnode partial merge / device delta-merge",
    "finalize_ms": "vectorized finalizers + output rendering",
    "factorize_ms": "group-key factorization (values → dense codes)",
    "group_count": "output group cardinality per query",
    "group_spill": "group-by accumulator epochs spilled to disk by the "
                   "memory broker's GroupSpiller (sql/executor.py)",
    "distinct_path.sort": "count(DISTINCT) via host sorted pair codes",
    "distinct_path.device": "count(DISTINCT) via the torch sort and "
                            "segment ops on the card (ops/kernels.py)",
    "distinct_path.fallback": "count(DISTINCT) via the scalar set fold",
    "pallas_engagements": "aggregations that ran through K1, the "
                          "hand-written CUDA windowed segment kernel "
                          "(ops/csrc/segment_window.cu)",
    "kernel_cache.hit": "segment-geometry/program cache hits on the "
                        "device batch (compile/derive skipped)",
    "kernel_cache.miss": "segment-geometry/program cache misses "
                         "(derived data rebuilt and uploaded again)",
    "matview.refresh_ms": "materialized-rollup delta refresh (scan the "
                          "[hwm, watermark) slice + fold + persist)",
    "matview.delta_rows": "raw rows folded into rollup partials by delta "
                          "refreshes (full-history's worth means the "
                          "watermark is not advancing)",
    "matview.hit": "aggregate queries rewritten to read sealed buckets "
                   "from a materialized rollup",
    "matview.miss": "rewrite-eligible aggregate queries no registered "
                    "view subsumed (raw scan)",
    "matview.seed_groups": "accumulator groups seeded from sealed view "
                           "buckets by rewritten queries",
    "ngram_pages_skipped": "string pages pruned before decode by trigram "
                           "signatures (ops/strkernels)",
    "compressed_ms": "compressed-domain lane: page classification + "
                     "closed-form jobs (storage/compressed_domain)",
    "compressed.pages_answered": "pages whose aggregate contribution "
                                 "came from stats/closed forms — never "
                                 "decoded into rows",
    "compressed.pages_skipped": "pages proven predicate-false from "
                                "encoded form — zero bytes touched",
    "compressed.pages_masked": "pages filtered in code space (dict/"
                               "bitpack masks) — only survivors gather",
    "compressed.bytes_avoided": "page bytes the compressed-domain lane "
                                "kept out of every decode lane",
    "compressed.bytes_materialized": "page bytes that DID enter a decode "
                                     "lane (the ≥5× drop the lane exists "
                                     "to produce on selective scans)",
    "topk.host": "ORDER BY+LIMIT answered by np.partition select-then-"
                 "gather instead of a full sort",
    "topk.device": "ORDER BY+LIMIT thresholds computed by torch.topk on "
                   "the card",
    "topk.declined": "ORDER BY+LIMIT shapes outside the top-k fast path "
                     "(nulls/NaN/object keys, k≥n) — full sort",
    "cold.fetch_ms": "ranged object-store GETs for cold-tier pages "
                     "(storage/tiering.py fetch_pages)",
    "cold.range_gets": "coalesced byte-range requests issued to the "
                       "object store by cold scans",
    "cold.pages_fetched": "cold pages whose bytes were downloaded "
                          "(cache misses after pruning)",
    "cold.bytes_downloaded": "bytes fetched from the object store by "
                             "cold scans (vs. bytes the pages span)",
    "cold.pages_pruned": "cold pages eliminated locally by sidecar zone "
                         "maps/constraints — zero bytes downloaded",
    "chaos.checks": "consistency-checker verdicts evaluated by the "
                    "nemesis plane (chaos/checker.py)",
    "chaos.crash_sites": "crash-point sweep runs executed — one per "
                         "(fault point, nth crossing) pair",
    "chaos.mttr_ms": "crash→first-successful-read recovery time measured "
                     "by chaos workload verify",
    "serving.plan_hit": "SELECTs answered from a cached analyzed plan "
                        "(parse+analyze+plan all skipped)",
    "serving.plan_rebind": "template fingerprint hits re-bound with new "
                           "literal params (parse+analyze skipped, "
                           "plan_select re-run)",
    "serving.plan_miss": "fingerprintable SELECTs that paid a full "
                         "parse+analyze+plan (then seeded the cache)",
    "serving.result_hit": "SELECTs answered from the ScanToken-validated "
                          "result cache (engine untouched)",
    "serving.result_miss": "result-cache probes whose entry was absent "
                           "or token-stale",
    "serving.result_bypass": "executed SELECTs whose result was not "
                             "cacheable (system/relational path, remote "
                             "vnodes, oversized result)",
    "serving.fused": "point queries executed inside a fused micro-batch "
                     "(shared scan + stacked filter masks)",
    "serving.solo": "batchable point queries that ran alone (no gate "
                    "pressure, or the window closed empty)",
    "serving.fused_scan_ms": "shared scan wall time paid once per fused "
                             "batch (booked to the leader's profile)",
    "serving.remote_fp": "scan_vnode RPCs carrying a serving-plane "
                         "fingerprint (cluster-wide cache attribution)",
    "serving.fused_hedges": "hedged scan attempts fired during a fused "
                            "micro-batch's shared scan (booked to the "
                            "leader; process-wide delta, so concurrent "
                            "queries' hedges can bleed in)",
    "mesh.plan_ms": "mesh exec lane: global segment/label layout + "
                    "shard-major staging (ops/mesh_exec._build_prep)",
    "mesh.upload_ms": "mesh exec lane: sharded host→device uploads "
                      "(NamedSharding over the shard axis)",
    "mesh.collective_ms": "mesh exec lane: collective merge programs — "
                          "per-shard partials folded over the mesh in "
                          "batch order (distributed_agg.mesh_merge_"
                          "kernel) + the replicated-result fetch",
    "mesh.assemble_ms": "mesh exec lane: merged partials → the legacy "
                        "vec-merge AggResult shape",
    "mesh.plan_cache_hit": "mesh prep cache hits — sharded operands "
                           "reused from the lead batch (warm repeats "
                           "skip layout + upload)",
    "mesh.plan_cache_miss": "mesh prep cache misses (layout + sharded "
                            "upload rebuilt)",
    "mesh.rows": "rows aggregated through the mesh lane per query",
    "mesh.shards": "mesh devices participating in the collective merge",
    "hedge.fired": "hedged scan attempts launched at a next-ranked "
                   "replica after the adaptive p95 trigger elapsed",
    "hedge.won": "scans answered by a hedge attempt instead of the "
                 "primary (the tail the plane exists to cut)",
    "hedge.cancelled": "losing hedge/primary attempts cancelled through "
                       "the cancel_scan(qid) fan-out after a winner",
    "hedge.suppressed": "hedge triggers that elapsed without firing "
                        "(limiter / no budget / no alternate — proves "
                        "hedging stays tail-only)",
    # the write path and the waits (spans on the timeline; the query's
    # own land in its profile too)
    "write.body_ms": "reading a write request's body, awaited on the "
                     "HTTP event loop (server/http.py handle_write)",
    "write.parse_ms": "line-protocol parse of one write request, on the "
                      "HTTP event loop (server/http.py handle_write)",
    "write.queue_ms": "a write request's wait in the HTTP executor's "
                      "queue: hand-off to the first line on a worker",
    "write.apply_ms": "Coordinator.write_points: memory admission, bucket "
                      "split, schema, the replica sets' writes",
    "write.lock_wait_ms": "a write's wait for its vnode's lock (tag "
                          "`holder`: what held it, storage/vnode.py "
                          "VnodeStorage.locked)",
    "write.wal_ms": "a vnode write's WAL record: encode, append, sync "
                    "when asked",
    "write.memcache_ms": "a vnode write's index and memory-cache insert",
    "write.resume_ms": "a write's wait for the HTTP event loop to resume "
                       "its handler once the worker is done",
    "flush_ms": "one vnode flush of its memory caches to an L0 file (tags "
                "`trigger` inline / reclaim / explicit, rows, bytes)",
    "compact_ms": "one compaction round of a vnode (tags bytes read and "
                  "written)",
    "body_ms": "reading a query request's body, awaited on the HTTP "
               "event loop (server/http.py handle_sql)",
    "queue_ms": "a query's wait in the HTTP executor's queue: hand-off to "
                "the first line on a worker",
    "admission_ms": "a query's wait at the admission gate "
                    "(server/admission.py)",
    "lock_wait_ms": "a scan's wait for a vnode's lock (tag `holder`: what "
                    "held it, storage/vnode.py VnodeStorage.locked)",
    "resume_ms": "a query's wait for the HTTP event loop to resume its "
                 "handler once the worker is done",
    "http.render_ms": "rendering a query's answer (CSV, JSON or table), "
                      "on the HTTP event loop",
}

# Prefixes for names composed at runtime (skipped by the literal lint
# check but still part of the documented schema):
#   rpc_<method>_ms — server-side wall time of one RPC handler dispatch
#   string_path.<path> — string predicates per strkernels lane
#     (per_unique / ngram_skip / host_fallback)
DYNAMIC_STAGE_PREFIXES = ("rpc_", "string_path.")

_profile: contextvars.ContextVar = contextvars.ContextVar(
    "cnos_query_profile", default=None)

# Error counters are ALWAYS on and process-global (unlike stages): a
# swallowed RPC handler exception with no counter is invisible in
# production. Keyed "area.method" (e.g. "rpc.write_replica"); surfaced
# via /metrics.
_err_lock = lockwatch.Lock("stages.errors")
_errors: dict[str, int] = {}


class QueryProfile:
    """Stage timings/counters + device telemetry for ONE query.

    Thread-safe: scan/decode pool workers and RPC reply threads all
    accumulate into the submitting query's profile concurrently. The
    lock is a plain leaf mutex (never held across any other acquire).
    """

    __slots__ = ("qid", "sql", "trace_id", "node_id", "started_at",
                 "wall_ms", "error", "ms", "counts", "device",
                 "subprofiles", "_lock")

    def __init__(self, qid: str | None = None, node_id=None,
                 sql: str | None = None):
        self.qid = qid
        self.sql = sql
        self.trace_id: str | None = None
        self.node_id = node_id
        self.started_at = time.time()
        self.wall_ms: float | None = None
        self.error: str | None = None
        self.ms: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.device: dict = {}
        # remote per-node sub-profiles: [{node, addr, method, vnode,
        # ms, counts}, ...] — appended by net.rpc_call as replies land
        self.subprofiles: list[dict] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------- accumulation
    def add_ms(self, name: str, dt_ms: float) -> None:
        with self._lock:
            self.ms[name] = self.ms.get(name, 0.0) + dt_ms

    def add_count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n

    def merge_remote(self, entry: dict) -> None:
        """Fold one remote node's wire sub-profile in (keyed by
        node/vnode/method — the coordinator-side merge keeps them
        separate so EXPLAIN ANALYZE can attribute per node)."""
        with self._lock:
            self.subprofiles.append(entry)

    def merge_child(self, child: "QueryProfile") -> None:
        """Fold a nested profile (e.g. EXPLAIN ANALYZE's inner query)
        into this one so its stages aren't lost to the outer scope."""
        with child._lock:
            ms = dict(child.ms)
            counts = dict(child.counts)
            subs = list(child.subprofiles)
        with self._lock:
            for k, v in ms.items():
                self.ms[k] = self.ms.get(k, 0.0) + v
            for k, v in counts.items():
                self.counts[k] = self.counts.get(k, 0) + v
            self.subprofiles.extend(subs)

    # ---------------------------------------------------------- rendering
    def snapshot(self) -> dict:
        """Local stage map, bench wire shape: rounded `*_ms` floats
        merged with integer counters, sorted by key (the format BENCH_r*
        `stages_warm`/`stages_cold` fields have always used)."""
        with self._lock:
            out = {k: round(v, 2) for k, v in sorted(self.ms.items())}
            out.update(sorted(self.counts.items()))
            return out

    def to_wire(self) -> dict:
        """Compact reply-envelope form for the RPC plane."""
        with self._lock:
            return {"node": self.node_id,
                    "ms": {k: round(v, 3) for k, v in self.ms.items()},
                    "counts": dict(self.counts)}

    def node_stages(self) -> dict[str, dict]:
        """Merged per-node view: node label → {stage: value}. Local
        stages land under this profile's node id; each remote
        sub-profile folds into its originating node's cell."""
        local = str(self.node_id) if self.node_id is not None else "local"
        with self._lock:
            out: dict[str, dict] = {local: {}}
            for k, v in self.ms.items():
                out[local][k] = round(out[local].get(k, 0.0) + v, 3)
            for k, v in self.counts.items():
                out[local][k] = out[local].get(k, 0) + v
            for sub in self.subprofiles:
                node = sub.get("node")
                label = str(node) if node is not None \
                    else str(sub.get("addr", "remote"))
                cell = out.setdefault(label, {})
                for k, v in (sub.get("ms") or {}).items():
                    cell[k] = round(cell.get(k, 0.0) + v, 3)
                for k, v in (sub.get("counts") or {}).items():
                    cell[k] = cell.get(k, 0) + v
            return out

    def stage_totals(self) -> dict:
        """Cluster-wide totals: every node's stages summed per name."""
        totals: dict = {}
        for cell in self.node_stages().values():
            for k, v in cell.items():
                totals[k] = round(totals.get(k, 0) + v, 3)
        return totals

    def to_dict(self) -> dict:
        with self._lock:
            return {"qid": self.qid, "sql": self.sql,
                    "trace_id": self.trace_id, "node_id": self.node_id,
                    "started_at": self.started_at, "wall_ms": self.wall_ms,
                    "error": self.error,
                    "ms": {k: round(v, 3) for k, v in sorted(self.ms.items())},
                    "counts": dict(sorted(self.counts.items())),
                    "device": dict(self.device),
                    "subprofiles": [dict(s) for s in self.subprofiles]}

    # ---------------------------------------------------------- lifecycle
    def finish(self, wall_ms: float | None = None,
               error: str | None = None) -> "QueryProfile":
        """Stamp wall time + device telemetry. Captures only from
        modules that are ALREADY imported — finishing a profile must
        never drag the jax stack in on a cold text-only query."""
        import sys

        if wall_ms is not None:
            self.wall_ms = round(wall_ms, 3)
        if error is not None:
            self.error = error
        pk = sys.modules.get("cnosdb_tpu_torch.ops.pallas_kernels")
        if pk is None and "cnosdb_tpu_torch.ops.kernels" in sys.modules:
            # the jax kernel stack is already resident (this query ran
            # aggregates), so the pallas module itself is a cheap import
            try:
                from ..ops import pallas_kernels as pk
            except Exception:  # telemetry stamp must never fail the query
                pk = None
        if pk is not None:
            try:
                self.device["pallas_enabled"] = pk.enabled()
                self.device["pallas_disabled_reason"] = pk.disabled_reason()
            except Exception:  # telemetry stamp must never fail the query
                pass
        dd = sys.modules.get("cnosdb_tpu_torch.ops.device_decode")
        if dd is not None:
            try:
                self.device["device_decode_enabled"] = dd.enabled()
                self.device["device_decode_disabled_reason"] = \
                    dd.disabled_reason()
            except Exception:  # telemetry stamp must never fail the query
                pass
        return self


def current_profile() -> QueryProfile | None:
    return _profile.get()


class profile_scope:
    """Install `profile` as the active query profile for the block
    (None clears the scope — e.g. background work inside a request
    that must not bill to it)."""

    __slots__ = ("profile", "_token")

    def __init__(self, profile: QueryProfile | None):
        self.profile = profile
        self._token = None

    def __enter__(self):
        self._token = _profile.set(self.profile)
        return self.profile

    def __exit__(self, *exc):
        if self._token is not None:
            _profile.reset(self._token)
        return False


class ProfileRing:
    """Bounded ring of recently finished profiles (dict snapshots),
    queryable by qid — the trace collector's shape, applied to
    profiles so `GET /debug/profile?qid=` works after the fact."""

    def __init__(self, capacity: int = 256):
        self._ring: deque = deque(maxlen=capacity)
        self._lock = lockwatch.Lock("stages.profile_ring")

    def record(self, profile: QueryProfile) -> None:
        with self._lock:
            self._ring.append(profile.to_dict())

    def get(self, qid: str) -> dict | None:
        with self._lock:
            for d in reversed(self._ring):
                if d.get("qid") == str(qid):
                    return d
        return None

    def recent(self, limit: int = 50) -> list[dict]:
        with self._lock:
            out = list(self._ring)[-limit:]
        return [{"qid": d.get("qid"), "sql": d.get("sql"),
                 "trace_id": d.get("trace_id"), "wall_ms": d.get("wall_ms"),
                 "started_at": d.get("started_at"), "error": d.get("error")}
                for d in out]


PROFILES = ProfileRing()


# ---------------------------------------------------------------- timeline
# The process timeline: every `stage()` is also a span here, profile or
# not, in one bounded ring, always on. A finished span is one tuple
# (`FIELDS`) appended to a deque, which needs no lock; dicts are built
# only when the ring is read. Each span keeps its thread and the CPU
# time that thread spent inside it, so that a wait and a piece of work
# can be told apart inside one span. Spans are timed on the monotonic
# clock (`now_ns()`), so a step of the system clock moves no duration,
# and each also keeps its start on `epoch_ns()`, torch.profiler's clock:
# the distance between the two clocks moves (by a millisecond within
# seconds on an H100 host), so no one offset maps the first onto the
# second. server/trace.py propagates and exports the spans.
_current_span: contextvars.ContextVar = contextvars.ContextVar(
    "cnos_current_span", default=None)

# ids: numbers of a process counter, written with a per-process random
# prefix when read (16 hex digits, unique across the nodes of a cluster
# without reading os.urandom a span)
_ID_PREFIX = secrets.token_hex(4)
_ids = itertools.count(1)

# what a finished span is in the ring
FIELDS = ("seq", "name", "trace_id", "span_id", "parent_id", "thread",
          "start_ns", "end_ns", "cpu_ns", "tags", "epoch_ns")


def now_ns() -> int:
    """The timeline's clock: `time.monotonic_ns()`, the clock of
    `time.monotonic()`."""
    return time.monotonic_ns()


def epoch_ns() -> int:
    """Now in ns since the epoch, the clock torch.profiler stamps a trace
    on (an event of an exported trace sits at `baseTimeNanoseconds` +
    `ts` x 1,000 ns), and OTLP's."""
    return time.time_ns()


def monotonic_s(ns: int) -> float:
    """A timeline instant on `time.monotonic()`'s clock, in seconds."""
    return ns / 1e9


def _id_str(x) -> str | None:
    """An id as the wire and the readers see it: a local id is a number
    of the process counter, a propagated one the string it came as."""
    if x is None or isinstance(x, str):
        return x
    return f"{_ID_PREFIX}{x:08x}"


class Span:
    """One timed piece of work. Its ids are kept raw (see `_id_str`) and
    formatted when read; with a query profile (`profile`), it adds its
    ms to the profile under its name as it ends."""

    __slots__ = ("_trace", "_id", "_parent", "name", "tags", "start_ns",
                 "duration_ns", "epoch_ns", "thread", "cpu_ns", "_collector",
                 "_token", "_profile")

    def __init__(self, trace, span_id, parent, name: str,
                 collector: "TraceCollector", profile=None):
        self._trace = trace
        self._id = span_id
        self._parent = parent
        self.name = name
        self.tags: dict | None = None
        self.start_ns = 0
        self.duration_ns = 0
        self.epoch_ns = 0
        self.thread = 0
        self.cpu_ns = 0
        self._collector = collector
        self._token = None
        self._profile = profile

    @property
    def trace_id(self) -> str:
        return _id_str(self._trace)

    @property
    def span_id(self) -> str:
        return _id_str(self._id)

    @property
    def parent_id(self) -> str | None:
        return _id_str(self._parent)

    def set_tag(self, key: str, value):
        if self.tags is None:
            self.tags = {}
        self.tags[key] = value
        return self

    def __enter__(self):
        self._token = _current_span.set(self)
        self.thread = threading.get_ident()
        self.epoch_ns = epoch_ns()
        self.start_ns = time.monotonic_ns()
        self.cpu_ns = time.thread_time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.cpu_ns = time.thread_time_ns() - self.cpu_ns
        self.duration_ns = time.monotonic_ns() - self.start_ns
        if exc is not None:
            self.set_tag("error", str(exc))
        if self._token is not None:
            _current_span.reset(self._token)
        if self._profile is not None:
            self._profile.add_ms(self.name, self.duration_ns / 1e6)
        self._collector.record(self)
        return False


def _as_dict(rec: tuple) -> dict:
    """A span of the ring as its readers outside the process see it: ids
    formatted, `start_ns` since the epoch (`epoch_ns`)."""
    (_seq, name, trace_id, span_id, parent_id, thread, start, end, cpu,
     tags, epoch) = rec
    return {"trace_id": _id_str(trace_id), "span_id": _id_str(span_id),
            "parent_id": _id_str(parent_id), "name": name,
            "tags": dict(tags or {}), "start_ns": epoch,
            "duration_ns": end - start, "thread": thread, "cpu_ns": cpu}


class TraceCollector:
    """Bounded ring of finished spans (reference keeps them in minitrace's
    collector until OTLP flush; embedded deployments query them back).

    The default capacity holds a minute of a loaded node's spans and its
    warm-up: the benchmark's live cell records a few hundred a second.
    `dropped` counts the spans that fell off the ring."""

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._seq = itertools.count()
        self.sinks: list = []   # extra consumers (OTLP exporter)

    def record(self, span: Span):
        self.add(span.name, span._trace, span._id, span._parent, span.thread,
                 span.start_ns, span.start_ns + span.duration_ns,
                 span.cpu_ns, span.tags, span.epoch_ns)

    def add(self, name: str, trace_id, span_id, parent_id, thread: int,
            start_ns: int, end_ns: int, cpu_ns: int = 0,
            tags: dict | None = None, epoch: int | None = None):
        """Append one finished span (see FIELDS; ids raw, `_id_str`). A
        span given no `epoch` start is put on that clock by the clocks'
        distance now: right for a span that has just ended."""
        if epoch is None:
            epoch = start_ns + epoch_ns() - now_ns()
        rec = (next(self._seq), name, trace_id, span_id, parent_id, thread,
               start_ns, end_ns, cpu_ns, tags, epoch)
        self._ring.append(rec)
        for sink in self.sinks:
            try:
                sink(_as_dict(rec))
            except Exception:
                pass   # a broken exporter must never fail the traced work

    @property
    def dropped(self) -> int:
        """Spans recorded and no longer in the ring."""
        ring = self._ring
        try:
            return ring[-1][0] + 1 - len(ring)
        except IndexError:
            return 0

    def records(self) -> list[tuple]:
        """Every span in the ring, oldest first (tuples, see FIELDS)."""
        return list(self._ring)

    def window(self, lo_ns: int, hi_ns: int) -> list[tuple] | None:
        """The spans that ended in [lo_ns, hi_ns], or None when the ring
        dropped spans that may have ended there (spans enter the ring as
        they end, so the oldest one kept bounds what was dropped)."""
        recs = self.records()
        if recs and recs[0][0] > 0 and recs[0][7] >= lo_ns:
            return None
        return [r for r in recs if lo_ns <= r[7] <= hi_ns]

    def spans(self, trace_id: str | None = None,
              limit: int = 500) -> list[dict]:
        recs = self.records()
        if trace_id is not None:
            recs = [r for r in recs if _id_str(r[2]) == trace_id]
        return [_as_dict(r) for r in recs[-limit:]]

    def span(self, name: str, trace_id: str | None = None,
             parent_id: str | None = None, profile=None) -> Span:
        """Start a child of the context span, or a root with the given (or
        a fresh) trace id — `Span::from_context` in the reference."""
        cur = _current_span.get()
        if trace_id is None and cur is not None:
            trace_id = cur._trace
            parent_id = cur._id
        if trace_id is None:
            trace_id = next(_ids)
        return Span(trace_id, next(_ids), parent_id, name, self, profile)

    def waited(self, name: str, start_ns: int) -> int:
        """Record a wait that began at `start_ns`, on this thread or on
        another (a hand-off between threads), and ends now, on this
        thread, as a child of the context span. It used no CPU of its
        own. → its end (ns)."""
        cur = _current_span.get()
        end = time.monotonic_ns()
        if cur is None:
            self.add(name, next(_ids), next(_ids), None,
                     threading.get_ident(), start_ns, end)
        else:
            self.add(name, cur._trace, next(_ids), cur._id,
                     threading.get_ident(), start_ns, end)
        return end


GLOBAL_COLLECTOR = TraceCollector()


def current_span() -> Span | None:
    """The context-active span, if any (profile plane attaches per-stage
    timings to the root span it finds here)."""
    return _current_span.get()


# --------------------------------------------------------------- recording
def stage(name: str) -> Span:
    """Time a block (`with stages.stage(name) as span:`) as `name`: a span
    on the process timeline, child of the context span (`span` takes its
    tags), and the block's ms in the active query profile when there is
    one."""
    return GLOBAL_COLLECTOR.span(name, profile=_profile.get())


def waited(name: str, start_ns: int) -> None:
    """Record a wait that began at `start_ns` (`now_ns()`, taken on this
    thread or the one that handed the work over) and ends now: a span on
    the timeline, and its ms in the active query profile."""
    end = GLOBAL_COLLECTOR.waited(name, start_ns)
    prof = _profile.get()
    if prof is not None:
        prof.add_ms(name, (end - start_ns) / 1e6)


def count(name: str, n: int = 1) -> None:
    prof = _profile.get()
    if prof is not None:
        prof.add_count(name, n)


def count_error(name: str, n: int = 1) -> None:
    """Always-on process-global failure counter (never profile-scoped)."""
    with _err_lock:
        _errors[name] = _errors.get(name, 0) + n


def errors_snapshot() -> dict[str, int]:
    with _err_lock:
        return dict(sorted(_errors.items()))


def reset() -> None:
    """Clear the process-global error counters (test isolation)."""
    with _err_lock:
        _errors.clear()
