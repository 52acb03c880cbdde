"""HTTP service: the primary user-facing API.

Role-parity with the reference's HttpService (main/src/http/
http_service.rs): /api/v1/write (line protocol), /api/v1/sql, /api/v1/ping,
/api/v1/opentsdb/write, /metrics (Prometheus text), with basic auth and
per-request db / precision / pretty parameters, csv|json result encoding
via the Accept header (main/src/http/response.rs, result_format.rs).
"""
from __future__ import annotations

import asyncio
import base64
import contextvars
import json
import sys
import time

import numpy as np
from aiohttp import web

from .. import __version__
from ..errors import CnosError, DeadlineExceeded, ParserError, QueryError
from ..models.schema import Precision
from ..parallel.coordinator import Coordinator
from ..parallel.meta import MetaStore, DEFAULT_TENANT
from ..protocol.line_protocol import parse_lines
from ..sql.executor import QueryExecutor, ResultSet, Session
from ..storage.engine import TsKv
from ..utils import deadline as deadline_mod
from ..utils import stages
from .admission import AdmissionGate
from .metrics import MetricsRegistry

# per-request deadline override (milliseconds of budget from ingress);
# absent → the config [query] read_timeout_ms / write_timeout_ms defaults
DEADLINE_HEADER = "X-CnosDB-Deadline-Ms"
# opt-in per-query profiling: any truthy value on the request installs a
# QueryProfile at ingress; the response then carries a compact JSON
# summary header, and the full profile is at /debug/profile?qid=
PROFILE_HEADER = "X-CnosDB-Profile"
PROFILE_SUMMARY_HEADER = "X-CnosDB-Profile-Summary"


class HttpServer:
    def __init__(self, meta: MetaStore, coord: Coordinator,
                 executor: QueryExecutor, auth_enabled: bool = False,
                 query_cfg=None):
        from ..config import QueryConfig

        self.meta = meta
        self.coord = coord
        self.executor = executor
        self.auth_enabled = auth_enabled
        self.metrics = MetricsRegistry()
        qc = query_cfg or QueryConfig()
        self.read_timeout_ms = int(qc.read_timeout_ms)
        self.write_timeout_ms = int(qc.write_timeout_ms)
        # slow-query log: [query] slow_query_threshold_ms (0 = off);
        # enforced in the executor so KILLed/expired queries still log
        executor.slow_query_threshold_ms = \
            int(getattr(qc, "slow_query_threshold_ms", 0) or 0)
        # gray-failure plane: push [query] hedge knobs into the
        # process-global health scorer (the coordinator reads the module
        # globals at hedge time, so late configure() is fine)
        from ..parallel import health as _health

        _health.configure(qc)
        self.gate = AdmissionGate(qc.max_concurrent_queries,
                                  qc.max_queued_queries)
        # memory-governance plane: push [query] memory_* knobs into the
        # broker and hand it the gate so ladder step 2 can shed QUEUED
        # queries (server/memory.py)
        from . import memory as _memory

        _memory.configure(qc)
        _memory.set_admission_gate(self.gate)
        # the serving plane's micro-batcher keys its fuse-or-solo decision
        # off this gate's pressure (queued > 0 / running at the cap)
        sv = getattr(executor, "serving", None)
        if sv is not None:
            sv.attach_gate(self.gate)
        from ..parallel.limiter import TenantLimiters

        self.limiters = TenantLimiters(meta)
        self.app = web.Application(client_max_size=512 * 1024 * 1024)
        self.app.add_routes([
            web.post("/api/v1/write", self.handle_write),
            web.post("/api/v1/sql", self.handle_sql),
            web.get("/api/v1/ping", self.handle_ping),
            web.post("/api/v1/opentsdb/write", self.handle_opentsdb_write),
            web.post("/api/v1/prom/write", self.handle_prom_write),
            web.post("/api/v1/prom/read", self.handle_prom_read),
            web.post("/api/v1/es/_bulk", self.handle_es_bulk),
            # OTLP trace ingest + jaeger query API (reference
            # http_service.rs:1673-2407, otlp_to_jaeger.rs)
            web.post("/api/v1/traces", self.handle_otlp_traces),
            web.post("/v1/traces", self.handle_otlp_traces),
            web.get("/api/services", self.handle_jaeger_services),
            web.get("/api/services/{service}/operations",
                    self.handle_jaeger_operations),
            web.get("/api/traces", self.handle_jaeger_traces),
            web.get("/api/traces/{trace_id}", self.handle_jaeger_trace),
            web.get("/metrics", self.handle_metrics),
            web.get("/debug/health", self.handle_health),
            web.get("/debug/traces", self.handle_traces),
            web.get("/debug/profile", self.handle_profile),
            web.get("/debug/backtrace", self.handle_backtrace),
            web.get("/debug/pprof", self.handle_pprof),
            web.get("/debug/scrub", self.handle_scrub),
            web.get("/debug/backup", self.handle_backup),
            web.get("/debug/matview", self.handle_matview),
            web.get("/debug/lockgraph", self.handle_lockgraph),
            web.get("/debug/memory", self.handle_memory),
        ])
        # background integrity scrubber (storage/scrub.py), attached by
        # run_server when cfg.storage.scrub_interval > 0
        self.scrubber = None

    # ------------------------------------------------------------- helpers
    def _auth(self, request) -> tuple[str, str]:
        """→ (user, tenant); raises 401 on failure."""
        hdr = request.headers.get("Authorization", "")
        user, password = "root", ""
        if hdr.startswith("Basic "):
            try:
                dec = base64.b64decode(hdr[6:]).decode()
                user, _, password = dec.partition(":")
            except Exception:
                raise web.HTTPUnauthorized(text="bad authorization header")
        elif self.auth_enabled:
            raise web.HTTPUnauthorized(text="authorization required")
        if self.auth_enabled:
            if self.meta.check_user(user, password) is None:
                raise web.HTTPUnauthorized(text="invalid user or password")
        tenant = request.query.get("tenant", DEFAULT_TENANT)
        if self.auth_enabled and not self.meta.user_can_access(user, tenant):
            raise web.HTTPForbidden(
                text=f"user {user!r} is not a member of tenant {tenant!r}")
        return user, tenant

    def _session(self, request) -> Session:
        user, tenant = self._auth(request)
        db = request.query.get("db", "public")
        return Session(tenant=tenant, database=db, user=user)

    def _request_deadline(self, request, default_ms: int) -> deadline_mod.Deadline:
        """Per-request lifecycle context, created once at ingress. The
        client may shrink (or extend) the config default via the
        X-CnosDB-Deadline-Ms header; 0 or a negative value means
        unbounded (kill/disconnect cancellation still applies)."""
        raw = request.headers.get(DEADLINE_HEADER)
        ms = default_ms
        if raw is not None:
            try:
                ms = int(float(raw))
            except ValueError:
                raise web.HTTPBadRequest(
                    text=f"bad {DEADLINE_HEADER} header: {raw!r}")
        return deadline_mod.Deadline(ms / 1000.0 if ms > 0 else None)

    def _authorize_read(self, session: Session):
        if not self.auth_enabled:
            return
        if not self.meta.check_db_privilege(session.user, session.tenant,
                                            session.database, "read"):
            raise web.HTTPForbidden(
                text=f"user {session.user!r} lacks read privilege on "
                     f"{session.tenant}.{session.database}")

    def _authorize_write(self, session: Session):
        """RBAC write gate for the ingest endpoints — line-protocol /
        OpenTSDB / prom / ES writes must clear the same bar as SQL INSERT
        (reference http_service.rs privilege checks per route)."""
        if not self.auth_enabled:
            return
        if not self.meta.check_db_privilege(session.user, session.tenant,
                                            session.database, "write"):
            raise web.HTTPForbidden(
                text=f"user {session.user!r} lacks write privilege on "
                     f"{session.tenant}.{session.database}")

    # ------------------------------------------------------------- handlers
    async def handle_ping(self, request):
        return web.json_response({"version": __version__, "status": "healthy"})

    async def handle_write(self, request):
        from .trace import from_headers

        with from_headers(request.headers, "http:write") as span:
            resp = await self._write(request, span)
            span.set_tag("status", resp.status)
            return resp

    async def _write(self, request, span):
        """handle_write inside its root span: the body's read and the
        parse on the event loop, the apply on an executor worker, each a
        stage, and the waits between them: the executor's queue, and the
        loop's turn to resume the handler once the worker is done."""
        session = self._session(request)
        self._authorize_write(session)
        precision = request.query.get("precision", "ns")
        try:
            prec = Precision.parse(precision)
        except Exception:
            return _err_response(400, ParserError(f"bad precision {precision!r}"))
        with stages.stage("write.body_ms"):
            body = await request.text()
        dl = self._request_deadline(request, self.write_timeout_ms)
        done = []

        def run():
            stages.waited("write.queue_ms", handed)
            try:
                with deadline_mod.scope(dl):
                    self.coord.write_points(session.tenant,
                                            session.database, batch)
            finally:
                done.append(stages.now_ns())

        try:
            with stages.stage("write.parse_ms"):
                batch = parse_lines(body, prec)
            span.set_tag("rows", batch.n_rows())
            self.limiters.check_write(session.tenant, batch.n_rows())
            loop = asyncio.get_running_loop()
            handed = stages.now_ns()
            # the worker runs in a copy of this context: its stages are
            # children of the request's span
            try:
                await loop.run_in_executor(
                    None, contextvars.copy_context().run, run)
            finally:
                if done:
                    stages.waited("write.resume_ms", done[0])
        except asyncio.CancelledError:
            dl.cancel("client disconnected")
            raise
        except CnosError as e:
            self.metrics.incr("cnosdb_http_write_errors_total")
            if isinstance(e, DeadlineExceeded):
                self.metrics.incr("cnosdb_requests_deadline_exceeded_total")
            from ..errors import MemoryExceeded, WriteBackpressure

            # memory-ladder outcomes get their own counters: 503-with-
            # Retry-After (flushes draining, retry helps) vs 413 (the
            # write itself is too big / node fail-closed over hard)
            if isinstance(e, WriteBackpressure):
                self.metrics.incr("cnosdb_requests_backpressured_total")
            elif isinstance(e, MemoryExceeded):
                self.metrics.incr("cnosdb_requests_memory_exceeded_total")
            return _err_response(_status_for(e), e)
        self.metrics.incr("cnosdb_http_writes_total")
        self.metrics.incr("cnosdb_http_points_written_total", batch.n_rows())
        self._record_http_usage(request, session, "http_data_in",
                                len(body))
        self._record_http_usage(request, session, "http_writes", 1)
        return web.Response(status=200)

    def _record_http_usage(self, request, session, table: str, value: int):
        """usage_schema HTTP-plane counters (reference http reporters):
        cumulative per (tenant, db, api, user), 1s-throttled."""
        try:
            self.coord.record_usage(
                table,
                {"tenant": session.tenant, "database": session.database,
                 "node_id": str(self.coord.node_id),
                 "api": request.path, "host": request.host,
                 "user": session.user},
                value, throttle=True, cumulative=True)
        except Exception:
            pass

    async def handle_sql(self, request):
        from .trace import from_headers

        session = self._session(request)
        # opt-in per-query profile summary: X-CnosDB-Profile: 1 installs
        # the profile at ingress so the response can carry its totals
        # (the full profile stays fetchable at /debug/profile?qid=)
        want_profile = request.headers.get(PROFILE_HEADER, "") \
            not in ("", "0", "false")
        prof = stages.QueryProfile() if want_profile else None
        with from_headers(request.headers, "http:sql") as span:
            with stages.profile_scope(prof), stages.stage("body_ms"):
                sql = (await request.text()).strip()
            if not sql:
                resp = _err_response(400, QueryError("empty sql"))
            else:
                span.set_tag("sql", sql[:200]) \
                    .set_tag("tenant", session.tenant)
                resp = await self._sql(request, session, sql, prof)
            span.set_tag("status", resp.status)
            return resp

    async def _sql(self, request, session, sql: str, prof):
        """handle_sql inside its root span, after the body's read: the
        executor queue, the admission gate and the query on a worker, the
        loop's turn to resume the handler, and the rendering on the event
        loop, each a stage of the query's profile `prof` (None unless the
        request asked for it)."""
        accept = request.headers.get("Accept", "application/csv")
        dl = self._request_deadline(request, self.read_timeout_ms)
        done = []

        def run():
            # on a worker of the loop's default executor, which every
            # HTTP request shares (min(32, CPUs + 4) threads): blocking
            # in the admission gate holds a worker, not the event loop
            # profile_scope(None) is a harmless clear, so no conditional
            with deadline_mod.scope(dl), stages.profile_scope(prof):
                stages.waited("queue_ms", handed)
                with stages.stage("admission_ms"):
                    self.gate.acquire(dl)   # AdmissionRejected → 503
                try:
                    return self.executor.execute_sql(sql, session)
                except CnosError:
                    if dl.qid and dl.remote_nodes:
                        # deadline expiry / kill / disconnect unwound the
                        # query while remote vnodes may still be working:
                        # best-effort cancel fan-out frees their workers
                        try:
                            self.coord.cancel_remote_scans(dl)
                        except Exception:
                            pass
                    raise
                finally:
                    self.gate.release()
                    done.append(stages.now_ns())

        t0 = time.monotonic()
        try:
            self.limiters.check_query(session.tenant)
            loop = asyncio.get_running_loop()
            handed = stages.now_ns()
            # the worker runs in a copy of this context: the query's
            # spans are children of the request's span
            try:
                results = await loop.run_in_executor(
                    None, contextvars.copy_context().run, run)
            finally:
                if done:
                    with stages.profile_scope(prof):
                        stages.waited("resume_ms", done[0])
        except asyncio.CancelledError:
            # aiohttp cancels the handler when the client disconnects;
            # flip the cancel flag so the (uninterruptible) worker thread
            # unwinds at its next checkpoint and fans cancels out itself
            dl.cancel("client disconnected")
            raise
        except CnosError as e:
            self.metrics.incr("cnosdb_http_sql_errors_total")
            if isinstance(e, DeadlineExceeded):
                self.metrics.incr("cnosdb_requests_deadline_exceeded_total")
            from ..errors import MemoryExceeded

            if isinstance(e, MemoryExceeded):
                self.metrics.incr("cnosdb_requests_memory_exceeded_total")
            return _err_response(_status_for(e), e)
        self.metrics.incr("cnosdb_http_queries_total")
        # reference query_sql_process_ms: end-to-end SQL latency histogram
        self.metrics.observe("cnosdb_query_sql_process_ms",
                             (time.monotonic() - t0) * 1e3)
        self._record_http_usage(request, session, "http_queries", 1)
        self._record_http_usage(request, session, "http_data_in", len(sql))
        rs = results[-1] if results else ResultSet.empty()
        # rendered into the profile before its summary is read
        with stages.profile_scope(prof), stages.stage("http.render_ms"):
            if "json" in accept:
                resp = web.Response(text=format_json(rs),
                                    content_type="application/json")
            elif "table" in accept:
                resp = web.Response(text=format_table(rs),
                                    content_type="text/plain")
            else:
                resp = web.Response(text=format_csv(rs),
                                    content_type="text/csv")
        if prof is not None:
            import json as _json

            summary = {"qid": prof.qid, "wall_ms": prof.wall_ms,
                       "stages": prof.stage_totals()}
            resp.headers[PROFILE_SUMMARY_HEADER] = _json.dumps(
                summary, separators=(",", ":"))[:4096]
        # gzip negotiation (reference http_service gzip layer)
        if "gzip" in request.headers.get("Accept-Encoding", ""):
            resp.enable_compression()
        return resp

    def _require_admin(self, request):
        """Debug surfaces expose cross-tenant internals (query text, stack
        frames): admin-only when auth is on."""
        if not self.auth_enabled:
            return
        user, _tenant = self._auth(request)
        u = self.meta.users.get(user)
        if u is None or not u.get("admin"):
            raise web.HTTPForbidden(text="debug endpoints are admin-only")

    @staticmethod
    def _query_number(request, name, default, lo, hi):
        try:
            v = float(request.query.get(name, default))
        except ValueError:
            raise web.HTTPBadRequest(text=f"bad {name!r} parameter")
        return min(max(v, lo), hi)

    async def handle_traces(self, request):
        """Collected spans (reference stores traces queryably via its
        jaeger-query API; embedded form returns them directly)."""
        self._require_admin(request)
        from .trace import GLOBAL_COLLECTOR

        tid = request.query.get("trace_id")
        limit = int(self._query_number(request, "limit", 500, 1, 10_000))
        return web.json_response(GLOBAL_COLLECTOR.spans(tid, limit))

    async def handle_profile(self, request):
        """Recent per-query profiles (bounded ring, like traces):
        `?qid=<n>` returns one full profile — stage timings, per-node
        sub-profiles, device telemetry; without qid, summaries of the
        most recent queries."""
        self._require_admin(request)
        qid = request.query.get("qid")
        if qid:
            d = stages.PROFILES.get(qid)
            if d is None:
                raise web.HTTPNotFound(text=f"no profile for qid {qid!r}")
            return web.json_response(d)
        limit = int(self._query_number(request, "limit", 50, 1, 256))
        return web.json_response(stages.PROFILES.recent(limit))

    async def handle_backtrace(self, request):
        """Live thread stacks (reference /debug/backtrace,
        http_service.rs:332)."""
        self._require_admin(request)
        import traceback

        frames = sys._current_frames()
        out = []
        import threading as _th

        names = {t.ident: t.name for t in _th.enumerate()}
        for tid, frame in frames.items():
            out.append(f"--- thread {tid} ({names.get(tid, '?')}):\n"
                       + "".join(traceback.format_stack(frame)))
        return web.Response(text="\n".join(out), content_type="text/plain")

    _pprof_lock = asyncio.Lock()

    async def handle_pprof(self, request):
        """Whole-process sampling CPU profile for ?seconds=N (reference
        /debug/pprof flamegraph, http_service.rs:1045). A sampler over
        sys._current_frames() sees EVERY thread — executor query threads
        and RPC handlers included — unlike cProfile, which instruments
        only the calling thread."""
        self._require_admin(request)
        import traceback

        seconds = self._query_number(request, "seconds", 2, 0.1, 30.0)
        if self._pprof_lock.locked():
            raise web.HTTPConflict(text="a profile is already running")
        async with self._pprof_lock:
            counts: dict[str, int] = {}
            deadline = asyncio.get_running_loop().time() + seconds
            n_samples = 0
            while asyncio.get_running_loop().time() < deadline:
                for tid, frame in sys._current_frames().items():
                    stack = traceback.extract_stack(frame, limit=12)
                    key = ";".join(f"{f.name}@{f.filename.rsplit('/', 1)[-1]}"
                                   f":{f.lineno}" for f in stack[-6:])
                    counts[key] = counts.get(key, 0) + 1
                n_samples += 1
                await asyncio.sleep(0.01)
        lines = [f"# {n_samples} samples over {seconds}s "
                 f"(collapsed stacks, hottest first)"]
        for key, c in sorted(counts.items(), key=lambda kv: -kv[1])[:80]:
            lines.append(f"{c:6d}  {key}")
        return web.Response(text="\n".join(lines), content_type="text/plain")

    async def handle_scrub(self, request):
        """Trigger one synchronous integrity sweep over every local vnode
        (CRC-verify TSM files, index checkpoints, sealed WAL segments;
        corrupt files are quarantined). `?repair=1` additionally runs the
        coordinator's anti-entropy pass so minority-divergent replicas are
        rebuilt from healthy peers before the response returns."""
        self._require_admin(request)
        from ..storage import scrub

        repair = request.query.get("repair", "0") not in ("0", "", "false")

        def run():
            if self.scrubber is not None:
                res = self.scrubber.sweep_once()
            else:
                res = scrub.scrub_engine(
                    self.coord.engine,
                    on_corruption=self.coord.on_scrub_corruption)
            out = {"scrub": res}
            if repair:
                out["repair"] = self.coord.anti_entropy_sweep()
            out["counters"] = scrub.counters_snapshot()
            return out

        loop = asyncio.get_running_loop()
        return web.json_response(await loop.run_in_executor(None, run))

    async def handle_backup(self, request):
        """Disaster-recovery plane status: archive config, per-vnode
        archiver watermarks + lag, counters, and the meta backup catalog.
        `?catchup=1` forces a synchronous seal + archive pass (the manual
        RPO-flush lever; BACKUP DATABASE does this per cut anyway)."""
        self._require_admin(request)
        from ..storage import backup

        catchup = request.query.get("catchup", "0") not in \
            ("0", "", "false")

        def run():
            out = {"enabled": backup.archive_enabled(),
                   "archivers": [], "catalog": {}}
            if not out["enabled"]:
                return out
            if catchup:
                for a in backup.archivers():
                    a.wal.seal_active()
                    a.catch_up()
            for a in backup.archivers():
                out["archivers"].append(
                    {"owner": a.owner, "vnode_id": a.vnode_id,
                     "watermark": a.watermark(),
                     "lag_seconds": a.lag_seconds()})
            out["lag_seconds"] = backup.archive_lag_seconds()
            out["counters"] = {f"{op}.{outcome}": n for (op, outcome), n
                               in backup.backup_snapshot().items()}
            for owner, entries in getattr(self.meta, "backups",
                                          {}).items():
                out["catalog"][owner] = [e["id"] for e in entries]
            return out

        loop = asyncio.get_running_loop()
        return web.json_response(await loop.run_in_executor(None, run))

    async def handle_matview(self, request):
        """Materialized-rollup admin surface: per-vnode watermarks and
        group counts for `?name=`, every registered view without it.
        `?refresh=1` forces a synchronous delta refresh first (with an
        optional deterministic `?now_ns=`), `?verify=1` compares the
        incremental state against a from-scratch recompute — the
        crash/replay chaos oracle."""
        self._require_admin(request)
        me = self.executor.matview_engine()
        name = request.query.get("name")
        refresh = request.query.get("refresh", "0") not in ("0", "", "false")
        verify = request.query.get("verify", "0") not in ("0", "", "false")
        now_ns = request.query.get("now_ns")

        def run():
            me.sync_from_meta()
            if name is None:
                return {"views": sorted(me.views)}
            out = {"name": name}
            if refresh:
                out["refreshed_vnodes"] = me.refresh(
                    name, now_ns=int(now_ns) if now_ns else None)
            out["status"] = me.status(name)
            if verify:
                out["verify"] = me.verify(name)
            return out

        loop = asyncio.get_running_loop()
        try:
            return web.json_response(await loop.run_in_executor(None, run))
        except QueryError as e:
            raise web.HTTPNotFound(text=str(e))

    async def handle_opentsdb_write(self, request):
        """OpenTSDB telnet-style put lines over HTTP (reference
        tcp_service + opentsdb parser)."""
        session = self._session(request)
        self._authorize_write(session)
        body = await request.text()
        from ..protocol.opentsdb import parse_opentsdb, parse_opentsdb_json

        try:
            # the reference serves telnet put lines AND the OpenTSDB
            # JSON body shape; sniff the leading character
            lead = body.lstrip()[:1]
            batch = (parse_opentsdb_json(body) if lead in ("[", "{")
                     else parse_opentsdb(body))
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(
                None, lambda: self.coord.write_points(
                    session.tenant, session.database, batch))
        except CnosError as e:
            return _err_response(_status_for(e), e)
        return web.Response(status=200)

    async def handle_prom_write(self, request):
        """Prometheus remote write: snappy + prompb (reference
        prom/remote_server.rs remote_write)."""
        session = self._session(request)
        self._authorize_write(session)
        from ..protocol.prometheus import parse_remote_write, snappy_available

        if not snappy_available():
            return _err_response(501, QueryError("snappy library unavailable"))
        body = await request.read()
        try:
            batch = parse_remote_write(body)
        except CnosError as e:
            return _err_response(_status_for(e), e)
        except Exception as e:
            # malformed prompb must be 4xx: prometheus retries 5xx forever
            return _err_response(400, ParserError(f"bad remote-write body: {e}"))
        try:
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(
                None, lambda: self.coord.write_points(
                    session.tenant, session.database, batch))
        except CnosError as e:
            return _err_response(_status_for(e), e)
        self.metrics.incr("cnosdb_prom_write_points_total", batch.n_rows())
        return web.Response(status=204)

    async def handle_prom_read(self, request):
        """Prometheus remote read (reference prom/remote_server.rs:478
        remote_read → SQL over the same storage): decode prompb
        ReadRequest, scan per query, stream back a ReadResponse."""
        session = self._session(request)
        self._authorize_read(session)  # same bar as SQL SELECT
        from ..protocol.prometheus import (
            parse_read_request, encode_read_response, snappy_available,
        )

        if not snappy_available():
            return _err_response(501, QueryError("snappy library unavailable"))
        body = await request.read()
        try:
            queries = parse_read_request(body)
        except CnosError as e:
            return _err_response(_status_for(e), e)
        except Exception as e:
            return _err_response(400, ParserError(f"bad remote-read body: {e}"))
        import re as _re

        loop = asyncio.get_running_loop()
        try:
            per_query = await loop.run_in_executor(
                None, lambda: [self._prom_read_query(session, q)
                               for q in queries])
        except _re.error as e:
            # malformed matcher regex must be 4xx — prometheus retries 5xx
            return _err_response(400, ParserError(f"bad matcher regex: {e}"))
        except CnosError as e:
            return _err_response(_status_for(e), e)
        raw = encode_read_response(per_query)
        return web.Response(body=raw,
                            content_type="application/x-protobuf",
                            headers={"Content-Encoding": "snappy"})

    def _prom_read_query(self, session: Session, q: dict) -> list:
        """One prompb Query → [(labels, [(ts_ms, value)])]."""
        import re as _re

        from ..models.predicate import (
            ColumnDomains, SetDomain, TimeRange, TimeRanges,
        )
        from ..protocol.prometheus import (
            MATCH_EQ, MATCH_NEQ, MATCH_NRE, MATCH_RE,
        )

        metric = None
        eq_tags: dict[str, str] = {}
        # post predicates see the ABSENT label as "" (prometheus semantics:
        # a missing label equals the empty string)
        post = []
        for mtype, name, value in q["matchers"]:
            if name == "__name__":
                if mtype == MATCH_EQ:
                    metric = value
                elif mtype == MATCH_RE:
                    metric = None  # regex metric: unsupported → no result
                continue
            if mtype == MATCH_EQ:
                if value == "":
                    post.append((name, lambda v: (v or "") == ""))
                else:
                    eq_tags[name] = value
            elif mtype == MATCH_NEQ:
                post.append((name, lambda v, x=value: (v or "") != x))
            elif mtype == MATCH_RE:
                rx = _re.compile(value)
                post.append((name, lambda v, r=rx:
                             r.fullmatch(v or "") is not None))
            elif mtype == MATCH_NRE:
                rx = _re.compile(value)
                post.append((name, lambda v, r=rx:
                             r.fullmatch(v or "") is None))
        if metric is None:
            return []
        doms = ColumnDomains({k: SetDomain([v]) for k, v in eq_tags.items()}) \
            if eq_tags else ColumnDomains.all()
        trs = TimeRanges([TimeRange(q["start_ms"] * 1_000_000,
                                    q["end_ms"] * 1_000_000)])
        from ..errors import TableNotFound

        try:
            batches = self.coord.scan_table(
                session.tenant, session.database, metric,
                time_ranges=trs, tag_domains=doms, field_names=["value"])
        except TableNotFound:
            return []   # unknown metric = no data; real errors propagate
        series: dict[tuple, list] = {}
        labels_of: dict[tuple, dict] = {}
        for b in batches:
            if "value" not in b.fields:
                continue
            _vt, vals, valid = b.fields["value"]
            for i in range(b.n_rows):
                if not valid[i]:
                    continue
                key = b.series_keys[b.sid_ordinal[i]]
                if key is None:
                    continue
                tags = key.tag_dict()
                if any(not pred(tags.get(name)) for name, pred in post):
                    continue
                sk = tuple(sorted(tags.items()))
                series.setdefault(sk, []).append(
                    (int(b.ts[i]) // 1_000_000, float(vals[i])))
                labels_of.setdefault(sk, {"__name__": metric, **tags})
        out = []
        for sk in sorted(series):
            samples = sorted(series[sk])
            out.append((labels_of[sk], samples))
        return out

    async def handle_es_bulk(self, request):
        """ES-style log ingest (reference `_bulk` json_protocol API)."""
        session = self._session(request)
        self._authorize_write(session)
        table = request.query.get("table", "logs")
        tag_keys = tuple(t for t in request.query.get("tags", "").split(",") if t)
        from ..protocol.es_bulk import parse_es_bulk

        body = await request.text()
        try:
            batch = parse_es_bulk(body, table, tag_keys)
        except CnosError as e:
            return _err_response(_status_for(e), e)
        except Exception as e:
            # valid-JSON-but-wrong-shape lines must be 4xx, not 500
            return _err_response(400, ParserError(f"bad bulk body: {e}"))
        try:
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(
                None, lambda: self.coord.write_points(
                    session.tenant, session.database, batch))
        except CnosError as e:
            self.metrics.incr("cnosdb_es_bulk_errors_total")
            return _err_response(_status_for(e), e)
        self.metrics.incr("cnosdb_es_bulk_writes_total")
        self.metrics.incr("cnosdb_es_bulk_points_written_total", batch.n_rows())
        return web.json_response({"errors": False, "items": batch.n_rows()})

    # --------------------------------------------------- traces (OTLP in)
    async def handle_otlp_traces(self, request):
        """OTLP/HTTP trace export → the `trace_spans` measurement: spans
        become rows queryable by SQL AND by the jaeger API below."""
        from ..models.points import WriteBatch
        from ..models.schema import ValueType
        from .otlp import TRACE_TABLE, parse_otlp_json

        session = self._session(request)
        self._authorize_write(session)
        ctype = request.headers.get("Content-Type", "")
        if "protobuf" in ctype:
            return web.Response(
                status=415,
                text="OTLP/HTTP protobuf encoding not supported; send the "
                     "OTLP JSON encoding (otlphttp exporter: encoding=json)")
        body = await request.read()
        try:
            rows = parse_otlp_json(body)
        except Exception as e:
            return web.Response(status=400, text=f"bad OTLP JSON: {e}")
        if rows:
            wb = WriteBatch.from_rows(
                TRACE_TABLE, rows,
                tag_names=["service_name", "span_id"],
                field_types={
                    "trace_id": ValueType.STRING,
                    "parent_span_id": ValueType.STRING,
                    "operation_name": ValueType.STRING,
                    "span_kind": ValueType.STRING,
                    "duration_ns": ValueType.INTEGER,
                    "status_code": ValueType.INTEGER,
                    "attributes": ValueType.STRING,
                })
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(
                None, lambda: self.coord.write_points(
                    session.tenant, session.database, wb))
        return web.json_response({"partialSuccess": {}})

    # --------------------------------------------------- jaeger query API
    def _trace_rows(self, session, where: str, limit: int | None = None):
        from .otlp import TRACE_TABLE

        sql = (f"SELECT time, service_name, span_id, trace_id, "
               f"parent_span_id, operation_name, span_kind, duration_ns, "
               f"status_code, attributes FROM {TRACE_TABLE}")
        if where:
            sql += f" WHERE {where}"
        sql += " ORDER BY time DESC"
        if limit:
            sql += f" LIMIT {int(limit)}"
        rs = self.executor.execute_one(sql, session)
        return [dict(zip(rs.names, row)) for row in rs.rows()]

    async def handle_jaeger_services(self, request):
        from .otlp import TRACE_TABLE

        session = self._session(request)
        self._authorize_read(session)

        def run():
            try:
                rs = self.executor.execute_one(
                    f"SELECT DISTINCT service_name FROM {TRACE_TABLE} "
                    f"ORDER BY service_name", session)
                return [str(v) for v in rs.columns[0]]
            except CnosError:
                return []   # no traces ingested yet
        loop = asyncio.get_running_loop()
        data = await loop.run_in_executor(None, run)
        return web.json_response({"data": data, "total": len(data)})

    async def handle_jaeger_operations(self, request):
        from .otlp import TRACE_TABLE

        session = self._session(request)
        self._authorize_read(session)
        svc = request.match_info["service"].replace("'", "''")

        def run():
            try:
                rs = self.executor.execute_one(
                    f"SELECT DISTINCT operation_name FROM {TRACE_TABLE} "
                    f"WHERE service_name = '{svc}' ORDER BY operation_name",
                    session)
                return [str(v) for v in rs.columns[0]]
            except CnosError:
                return []
        loop = asyncio.get_running_loop()
        data = await loop.run_in_executor(None, run)
        return web.json_response({"data": data, "total": len(data)})

    async def handle_jaeger_traces(self, request):
        from .otlp import spans_to_jaeger_traces

        session = self._session(request)
        self._authorize_read(session)
        svc = request.query.get("service", "").replace("'", "''")
        op = request.query.get("operation", "").replace("'", "''")
        try:
            limit = int(request.query.get("limit", 20))
            start_us = int(request.query["start"]) \
                if "start" in request.query else None
            end_us = int(request.query["end"]) \
                if "end" in request.query else None
        except ValueError as e:
            return web.Response(status=400,
                                text=f"bad numeric query parameter: {e}")

        def run():
            try:
                where = []
                if svc:
                    where.append(f"service_name = '{svc}'")
                if op:
                    where.append(f"operation_name = '{op}'")
                if start_us is not None:   # µs, jaeger convention
                    where.append(f"time >= {start_us * 1000}")
                if end_us is not None:
                    where.append(f"time <= {end_us * 1000}")
                probe = self._trace_rows(session, " AND ".join(where),
                                         limit=limit * 50)
                ids: list[str] = []
                for r in probe:
                    if r["trace_id"] not in ids:
                        ids.append(r["trace_id"])
                    if len(ids) >= limit:
                        break
                if not ids:
                    return []
                idlist = ", ".join(
                    "'" + i.replace("'", "''") + "'" for i in ids)
                rows = self._trace_rows(session, f"trace_id IN ({idlist})")
                return spans_to_jaeger_traces(rows)
            except CnosError:
                return []
        loop = asyncio.get_running_loop()
        data = await loop.run_in_executor(None, run)
        return web.json_response({"data": data, "total": len(data)})

    async def handle_jaeger_trace(self, request):
        from .otlp import spans_to_jaeger_traces

        session = self._session(request)
        self._authorize_read(session)
        tid = request.match_info["trace_id"].replace("'", "''")

        def run():
            try:
                rows = self._trace_rows(session, f"trace_id = '{tid}'")
                return spans_to_jaeger_traces(rows)
            except CnosError:
                return []
        loop = asyncio.get_running_loop()
        data = await loop.run_in_executor(None, run)
        if not data:
            return web.json_response(
                {"data": [], "errors": [{"code": 404,
                                         "msg": "trace not found"}]},
                status=404)
        return web.json_response({"data": data, "total": len(data)})

    async def handle_lockgraph(self, request):
        """Runtime lock-order watchdog state (utils/lockwatch.py): the
        observed (held → acquired) graph, any order cycles (potential
        deadlocks), longest-held locks, and locks held across an RPC hop.
        Reports `enabled: false` with empty tables unless the process was
        started with CNOSDB_LOCKWATCH=1 (chaos/cluster suites do this)."""
        self._require_admin(request)
        from ..utils import lockwatch

        return web.json_response(lockwatch.report())

    async def handle_memory(self, request):
        """Memory-governance plane (server/memory.py): broker budget +
        watermarks, live per-pool bytes, per-(pool, action) ladder
        counters and the recent reclaim/shed/spill event ring. Reports
        `enabled: false` when the node runs with CNOSDB_MEMORY=0."""
        self._require_admin(request)
        from . import memory as _memory

        return web.json_response(_memory.debug_snapshot())

    async def handle_health(self, request):
        """Gray-failure tolerance plane (parallel/health.py): per-node
        health scores (state, err/burn EWMAs, per-method-class latency
        quantiles), the coordinator's circuit-breaker table, slow-start
        ramps in progress, and the hedge/breaker transition counters.
        All zeros/empty until this node has coordinated remote work."""
        self._require_admin(request)
        from ..parallel import health

        hedge, breaker = health.counters_snapshot()
        now = time.monotonic()
        cb = {}
        for node_id, st in list(self.coord._cb.items()):
            open_for = st[1] - now
            cb[str(node_id)] = {
                "consecutive_failures": st[0],
                "state": "open" if open_for > 0 else "closed",
                "open_remaining_s": round(max(0.0, open_for), 3),
            }
        # raft-member introspection: a gray failure often looks like "the
        # follower silently stopped applying" — surface every local
        # member's role/term/log/commit/applied so that is one curl away
        raft = {}
        mgr = self.coord._replica_mgr
        if mgr is not None:
            for (gid, vid), node in list(mgr.transport.nodes.items()):
                raft[f"{gid}#{vid}"] = {
                    "role": node.role, "term": node.term,
                    "leader_id": node.leader_id, "alive": node.alive,
                    "last_index": node.log.last_index(),
                    "commit": node.commit_index,
                    "applied": node.last_applied,
                    "elections": node.election_stats(),
                }
        # this node's view of meta's placement: each replica set's static
        # leader and its vnodes' status (BROKEN = data-suspect until the
        # repair), read from the node's own catalog replica
        sets: dict = {}
        meta = self.coord.meta
        with meta.lock:
            for owner, buckets in meta.buckets.items():
                sets[owner] = [{
                    "id": rs.id, "leader_vnode_id": rs.leader_vnode_id,
                    "leader_node_id": rs.leader_node_id,
                    "vnodes": [{"id": v.id, "node_id": v.node_id,
                                "status": v.status.name}
                               for v in rs.vnodes]}
                    for b in buckets for rs in b.shard_group]
        return web.json_response({
            "hedging_enabled": health.enabled(),
            "hedge_delay_ms_floor": health.HEDGE_DELAY_FLOOR_MS,
            "hedge_max_inflight": health.HEDGE_MAX_INFLIGHT,
            "hedge_inflight": self.coord._hedge_limiter.inflight(),
            "raft_members": raft,
            "replica_sets": sets,
            "nodes": health.SCORER.snapshot(),
            "breakers": cb,
            "slow_start": health.SLOW_START.ramping(),
            "counters": {
                "hedge": {f"{o}:{r}" if r else o: n
                          for (o, r), n in sorted(hedge.items())},
                "breaker": {f"{node}:{state}": n
                            for (node, state), n in sorted(breaker.items())},
                # reads of replicated sets, through their raft leaders:
                # redirects a member gave, and waits for a leader while
                # a group elected
                "leader_read": dict(sorted(
                    health.leader_read_counters().items())),
                # the reads this node served as a group's leader: each
                # confirmed through the read index, or refused
                "read_index": dict(sorted(
                    health.read_index_counters().items())),
            },
        })

    async def handle_metrics(self, request):
        from ..utils import executor, stages

        # fold the always-on failure counters (RPC handler errors etc.) in
        # as gauges at render time — set_gauge is idempotent, so repeated
        # scrapes see the current cumulative totals
        for name, n in stages.errors_snapshot().items():
            area, _, what = name.partition(".")
            self.metrics.set_gauge("cnosdb_errors_total", n,
                                   area=area, kind=what or area)
        # shared scan/decode pool health: live task counts + pool widths
        for name, n in executor.active_counts().items():
            self.metrics.set_gauge("cnosdb_scan_executor_active", n,
                                   pool=name)
        for name, n in executor.pool_sizes().items():
            self.metrics.set_gauge("cnosdb_scan_executor_threads", n,
                                   pool=name)
        entries, nbytes = self.coord.scan_cache_stats()
        self.metrics.set_gauge("cnosdb_scan_cache_entries", entries)
        self.metrics.set_gauge("cnosdb_scan_cache_bytes", nbytes)
        # request-lifecycle plane: admission gate counters + queue gauges
        # (cnosdb_requests_deadline_exceeded_total is a true counter,
        # incremented where the 504 is returned)
        g = self.gate.stats()
        self.metrics.set_gauge("cnosdb_requests_admitted_total",
                               g["admitted_total"])
        self.metrics.set_gauge("cnosdb_requests_queued_total",
                               g["queued_total"])
        self.metrics.set_gauge("cnosdb_requests_shed_total", g["shed_total"])
        self.metrics.set_gauge("cnosdb_requests_running", g["running"])
        self.metrics.set_gauge("cnosdb_requests_queue_depth", g["queued"])
        self.metrics.set_gauge("cnosdb_requests_queue_wait_ms",
                               g["queue_wait_ms_avg"], stat="avg")
        self.metrics.set_gauge("cnosdb_requests_queue_wait_ms",
                               g["queue_wait_ms_max"], stat="max")
        # cancellation fan-out + shed-before-decode observability
        for name, n in deadline_mod.counters_snapshot().items():
            self.metrics.set_gauge("cnosdb_deadline_total", n, kind=name)
        # integrity plane: scrub progress + corruption/quarantine/repair
        # totals (storage/scrub.py counters are always on)
        from ..storage import scrub

        for name, n in scrub.counters_snapshot().items():
            self.metrics.set_gauge("cnosdb_integrity_total", n, kind=name)
        # decode plane: pages that missed the native pagedec fast lane,
        # by reason — a hot reason here is a concrete decode regression.
        # These are monotonic process totals: set_counter (not set_gauge)
        # so PromQL rate()/increase() work on them
        from ..storage import scan as _scan

        for name, n in _scan.decode_fallback_snapshot().items():
            self.metrics.set_counter("cnosdb_decode_fallback_total", n,
                                     reason=name)
        # aggregation plane: factorize/distinct path totals
        from ..ops import group_agg as _group_agg

        for name, n in _group_agg.counters_snapshot().items():
            self.metrics.set_gauge("cnosdb_group_agg_total", n, kind=name)
        # memory-governance plane: per-(pool, action) ladder totals +
        # live pool bytes (see /debug/memory for the full snapshot)
        from . import memory as _memory

        if _memory.enabled():
            for (pool, action), n in _memory.counters_snapshot().items():
                self.metrics.set_counter("cnosdb_memory_total", n,
                                         pool=pool, action=action)
            for pool, b in _memory.BROKER.usage().items():
                self.metrics.set_gauge("cnosdb_memory_pool_bytes", b,
                                       pool=pool)
            self.metrics.set_gauge("cnosdb_memory_budget_bytes",
                                   _memory.BROKER.total())
        # invariant plane: lock-order watchdog counters (all zero unless
        # the node runs with CNOSDB_LOCKWATCH=1; order_cycles > 0 means a
        # potential deadlock was observed — see /debug/lockgraph)
        from ..utils import lockwatch

        for name, n in lockwatch.counters_snapshot().items():
            self.metrics.set_gauge("cnosdb_lockwatch_total", n, kind=name)
        # warm-agg memo + materialized rollups: only when the jax exec /
        # matview modules are already resident — a metrics scrape must
        # never be the thing that drags the kernel stack in
        import sys as _sys

        _tx = _sys.modules.get("cnosdb_tpu_torch.ops.tpu_exec")
        if _tx is not None:
            self.metrics.set_gauge("cnosdb_agg_memo_bytes",
                                   _tx.memo_bytes())
            for name, n in _tx.memo_counters_snapshot().items():
                self.metrics.set_gauge("cnosdb_agg_memo_total", n,
                                       kind=name)
        # device-decode plane: per-(lane, reason) page outcomes — only
        # when the lane module is resident (same no-jax-on-scrape rule)
        _dd = _sys.modules.get("cnosdb_tpu_torch.ops.device_decode")
        if _dd is not None:
            for (lane, reason), n in _dd.outcomes_snapshot().items():
                self.metrics.set_counter("cnosdb_device_decode_total", n,
                                         lane=lane, reason=reason)
        # string/search plane: per-(path, reason) predicate outcomes
        _sk = _sys.modules.get("cnosdb_tpu_torch.ops.strkernels")
        if _sk is not None:
            for (path, reason), n in _sk.outcomes_snapshot().items():
                self.metrics.set_counter("cnosdb_string_filter_total", n,
                                         path=path, reason=reason)
        # compressed-domain lane: per-(lane, reason) page outcomes —
        # answered/skipped/masked/materialized and why
        _cd = _sys.modules.get("cnosdb_tpu_torch.storage.compressed_domain")
        if _cd is not None:
            for (lane, reason), n in _cd.outcomes_snapshot().items():
                self.metrics.set_counter("cnosdb_compressed_domain_total",
                                         n, lane=lane, reason=reason)
        # mesh exec lane: per-(lane, reason) engage/decline outcomes —
        # ("merge", "collective") counting is the zero-host-msgpack-hop
        # witness for on-mesh partial merges
        _mx = _sys.modules.get("cnosdb_tpu_torch.parallel.mesh")
        if _mx is not None:
            for (lane, reason), n in _mx.outcomes_snapshot().items():
                self.metrics.set_counter("cnosdb_mesh_total", n,
                                         lane=lane, reason=reason)
        _mv = _sys.modules.get("cnosdb_tpu_torch.sql.matview")
        if _mv is not None:
            for name, n in _mv.counters_snapshot().items():
                self.metrics.set_gauge("cnosdb_matview_total", n,
                                       kind=name)
        # cold-tier plane: per-(lane, reason) tier/fetch/prune/cache
        # outcomes plus the block cache's live size — only when the
        # tiering module is resident (nothing cold has happened otherwise)
        _ct = _sys.modules.get("cnosdb_tpu_torch.storage.tiering")
        if _ct is not None:
            for (lane, reason), n in _ct.cold_tier_snapshot().items():
                self.metrics.set_counter("cnosdb_cold_tier_total", n,
                                         lane=lane, reason=reason)
            bc = _ct.block_cache_stats()
            self.metrics.set_gauge("cnosdb_cold_block_cache_bytes",
                                   bc["bytes"])
            self.metrics.set_gauge("cnosdb_cold_block_cache_entries",
                                   bc["entries"])
        # serving plane: per-(layer, outcome) cache/batch counters plus
        # live cache sizes — only when the plane is resident
        # (CNOSDB_SERVING=0 never imports it)
        _sv = _sys.modules.get("cnosdb_tpu_torch.server.serving")
        if _sv is not None:
            for (layer, outcome), n in _sv.counters_snapshot().items():
                self.metrics.set_counter("cnosdb_serving_total", n,
                                         layer=layer, outcome=outcome)
            for cache, (entries, nbytes) in _sv.cache_stats().items():
                self.metrics.set_gauge(f"cnosdb_serving_{cache}_entries",
                                       entries)
                if cache == "result_cache":
                    self.metrics.set_gauge(
                        f"cnosdb_serving_{cache}_bytes", nbytes)
            for width, n in _sv.width_histogram().items():
                self.metrics.set_counter("cnosdb_serving_batch_width_total",
                                         n, width=str(width))
        # disaster-recovery plane: per-(op, outcome) archive/backup/
        # restore counters plus the RPO gauge (age of the oldest sealed-
        # but-unarchived WAL segment) — resident only once configured
        _bk = _sys.modules.get("cnosdb_tpu_torch.storage.backup")
        if _bk is not None and _bk.archive_enabled():
            for (op, outcome), n in _bk.backup_snapshot().items():
                self.metrics.set_counter("cnosdb_backup_total", n,
                                         op=op, outcome=outcome)
            self.metrics.set_gauge("cnosdb_backup_archive_lag_seconds",
                                   _bk.archive_lag_seconds())
        # gray-failure plane: hedge outcomes (fired/won/lost/cancelled/
        # suppressed, with suppression reason) and breaker state
        # transitions per node. True counters so rate() catches a node
        # flapping open/closed or a hedge storm.
        from ..parallel import health as _health

        _hedge, _breaker = _health.counters_snapshot()
        for (outcome, reason), n in _hedge.items():
            self.metrics.set_counter("cnosdb_hedge_total", n,
                                     outcome=outcome, reason=reason or "-")
        for (node, state), n in _breaker.items():
            self.metrics.set_counter("cnosdb_breaker_total", n,
                                     node=node, state=state)
        # nemesis plane: checker verdicts + recovery timings — resident
        # only when a chaos suite has run in this process
        _ch = _sys.modules.get("cnosdb_tpu_torch.chaos")
        if _ch is not None:
            for (check, verdict), n in _ch.chaos_snapshot().items():
                self.metrics.set_counter("cnosdb_chaos_total", n,
                                         check=check, verdict=verdict)
            for kind, secs in _ch.recovery_snapshot().items():
                self.metrics.set_gauge("cnosdb_chaos_recovery_seconds",
                                       secs, kind=kind)
        return web.Response(text=self.metrics.prometheus_text(),
                            content_type="text/plain")

    # ------------------------------------------------------------- lifecycle
    async def start(self, host: str = "0.0.0.0", port: int = 8902,
                    ssl_context=None):
        runner = web.AppRunner(self.app)
        await runner.setup()
        site = web.TCPSite(runner, host, port, ssl_context=ssl_context)
        await site.start()
        return runner

    async def start_tcp_opentsdb(self, host: str = "0.0.0.0",
                                 port: int = 8905):
        """OpenTSDB telnet `put` listener (reference main/src/tcp/
        tcp_service.rs:36-106): newline-delimited put lines per
        connection, written through the normal coordinator path."""
        from ..protocol.opentsdb import parse_opentsdb

        async def on_conn(reader, writer):
            loop = asyncio.get_running_loop()
            try:
                while True:
                    line = await reader.readline()
                    if not line:
                        break
                    text = line.decode(errors="replace").strip()
                    if not text:
                        continue
                    if text.lower() == "quit":
                        break
                    try:
                        batch = parse_opentsdb(text)
                        await loop.run_in_executor(
                            None, lambda b=batch: self.coord.write_points(
                                DEFAULT_TENANT, "public", b))
                        self.metrics.incr("cnosdb_tcp_opentsdb_points_total",
                                          batch.n_rows())
                    except CnosError as e:
                        writer.write(f"error: {e}\n".encode())
                        await writer.drain()
            finally:
                writer.close()

        return await asyncio.start_server(on_conn, host, port)


# ---------------------------------------------------------------------------
# result formatting (reference main/src/http/result_format.rs)
# ---------------------------------------------------------------------------
def _cell(v):
    if v is None:
        return ""
    from ..sql.tsfuncs import IntervalNs, format_interval_ns, \
        render_composite

    if isinstance(v, IntervalNs):
        return format_interval_ns(int(v))
    if isinstance(v, dict):
        return render_composite(v)   # gauge/window struct Display
    if isinstance(v, (bytes, bytearray)):
        return v.hex()   # WKB and other binary render as lowercase hex
    if isinstance(v, (float, np.floating)) and np.isnan(v):
        return "NaN"   # NaN is a VALUE; NULL is the empty cell
    if isinstance(v, (float, np.floating)) and v == 0.0:
        return repr(0.0)   # normalize -0.0 (arrow renders 0.0)
    if isinstance(v, np.float32):
        return str(v)     # shortest f32 repr ('1.5707964', '6e-06') —
        # the reference's Float32 results (log/atan2 over ints) render
        # at f32 precision
    if isinstance(v, np.floating):
        return repr(float(v))
    if isinstance(v, (np.integer,)):
        return str(int(v))
    if isinstance(v, np.bool_):
        return "true" if v else "false"
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def format_csv(rs: ResultSet) -> str:
    lines = [",".join(rs.names)]
    for row in rs.rows():
        lines.append(",".join(_csv_escape(_cell(v)) for v in row))
    return "\n".join(lines) + "\n"


def _csv_escape(s: str) -> str:
    if "," in s or '"' in s or "\n" in s:
        return '"' + s.replace('"', '""') + '"'
    return s


def _json_value(v):
    if v is None:
        return None
    if isinstance(v, (np.floating, float)):
        f = float(v)
        return None if np.isnan(f) else f
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, (np.bool_, bool)):
        return bool(v)
    return str(v) if not isinstance(v, (int, str)) else v


def format_json(rs: ResultSet) -> str:
    out = [
        {n: _json_value(v) for n, v in zip(rs.names, row)}
        for row in rs.rows()
    ]
    return json.dumps(out)


def format_table(rs: ResultSet) -> str:
    rows = [[_cell(v) for v in row] for row in rs.rows()]
    widths = [max(len(n), *(len(r[i]) for r in rows)) if rows else len(n)
              for i, n in enumerate(rs.names)]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    def fmt_row(cells):
        return "| " + " | ".join(c.ljust(w) for c, w in zip(cells, widths)) + " |"
    lines = [sep, fmt_row(rs.names), sep]
    for r in rows:
        lines.append(fmt_row(r))
    lines.append(sep)
    return "\n".join(lines) + "\n"


def _status_for(e: CnosError) -> int:
    from ..errors import (
        AdmissionRejected, AuthError, DatabaseNotFound, LimiterError,
        MemoryExceeded, ParserError, PlanError, TableNotFound,
    )

    if isinstance(e, AuthError):
        return 403
    if isinstance(e, LimiterError):
        return 429          # per-tenant budget — THIS tenant backs off
    if isinstance(e, AdmissionRejected):
        return 503          # node saturated for everyone — shed load
    if isinstance(e, MemoryExceeded):
        return 413          # request over its byte budget — not retryable
    if isinstance(e, DeadlineExceeded):
        return 504          # request outlived its budget
    if isinstance(e, (ParserError, PlanError, DatabaseNotFound, TableNotFound)):
        return 422
    return 500


def _err_response(status: int, e: CnosError):
    headers = {}
    if status in (429, 503):
        # both shed classes are retryable; tell clients when
        headers["Retry-After"] = str(
            max(1, int(round(float(getattr(e, "retry_after", 1.0))))))
    return web.json_response(
        {"error_code": getattr(e, "code", "000000"), "error_message": str(e)},
        status=status, headers=headers)


def build_server(data_dir: str, auth_enabled: bool = False,
                 wal_sync: bool = False, query_cfg=None):
    """Wire meta + engine + coordinator + executor (reference
    server.rs ServiceBuilder::build_query_storage)."""
    import os

    from ..parallel.replica import open_local_members

    meta = MetaStore(os.path.join(data_dir, "meta", "meta.json"))
    engine = TsKv(os.path.join(data_dir, "db"), wal_sync=wal_sync)
    # coordinator BEFORE open_existing: its init hydrates the engine's
    # schema view from the catalog, which WAL replay needs to re-key
    # replayed fields by column id across a pre-crash RENAME/DROP
    coord = Coordinator(meta, engine)
    engine.open_existing()
    # replicated vnodes left their unflushed raft entries to raft: start
    # their members now, not on the first write
    open_local_members(coord)
    executor = QueryExecutor(meta, coord)
    executor.restore_streams()  # persisted streams resume at their watermark
    executor.restore_matviews()  # rollups resume flush-driven maintenance
    return HttpServer(meta, coord, executor, auth_enabled=auth_enabled,
                      query_cfg=query_cfg)


def build_cluster_node(data_dir: str, meta_addr: str, node_id: int,
                       rpc_host: str = "127.0.0.1", rpc_port: int = 0,
                       auth_enabled: bool = False, wal_sync: bool = False,
                       query_cfg=None):
    """Wire a cluster data/query node: MetaClient cache + node RPC service
    + local engine + distributed coordinator (reference server.rs
    build_query_storage in cluster deployment: AdminMeta::new +
    add_data_node + grpc TSKVService)."""
    import os

    from ..parallel.meta_service import MetaClient
    from ..parallel.net import wait_rpc_ready
    from ..parallel.node_service import DataNodeService
    from ..parallel.replica import open_local_members

    wait_rpc_ready(meta_addr, timeout=30.0)
    meta = MetaClient(meta_addr, node_id=node_id)
    engine = TsKv(os.path.join(data_dir, "db"), wal_sync=wal_sync)
    coord = Coordinator(meta, engine, node_id=node_id)
    engine.open_existing()
    node_svc = DataNodeService(coord, host=rpc_host, port=rpc_port).start()
    meta.register_node(node_id, grpc_addr=node_svc.addr)
    meta.start_heartbeat()
    # replicated vnodes left their unflushed raft entries to raft: start
    # their members now, not on a peer's first message
    open_local_members(coord)
    executor = QueryExecutor(meta, coord)
    executor.restore_matviews()  # rollups resume flush-driven maintenance
    server = HttpServer(meta, coord, executor, auth_enabled=auth_enabled,
                        query_cfg=query_cfg)
    server.node_service = node_svc
    return server


def run_server(args) -> int:
    import asyncio
    import time as _time

    from ..config import Config

    # Config.load with no path still applies CNOSDB_* env overrides
    cfg = Config.load(getattr(args, "config", None))
    from ..utils import executor
    executor.configure(cfg.query)
    mode = getattr(args, "mode", "singleton")
    if mode == "meta":
        return run_meta_server(args)
    if getattr(args, "meta", None):
        server = build_cluster_node(
            args.data_dir, args.meta, getattr(args, "node_id", 1) or 1,
            rpc_port=getattr(args, "rpc_port", 0) or 0,
            auth_enabled=cfg.query.auth_enabled, wal_sync=cfg.wal.sync,
            query_cfg=cfg.query)
        print(f"node rpc on {server.node_service.addr}")
    else:
        server = build_server(args.data_dir,
                              auth_enabled=cfg.query.auth_enabled,
                              wal_sync=cfg.wal.sync,
                              query_cfg=cfg.query)
    flight_port = cfg.service.flight_rpc_listen_port

    if cfg.storage.scrub_interval > 0:
        from ..storage.scrub import Scrubber

        server.scrubber = Scrubber(
            server.coord.engine, cfg.storage.scrub_interval,
            mb_per_sec=cfg.storage.scrub_mb_per_sec,
            on_corruption=server.coord.on_scrub_corruption)
        server.scrubber.start()
        print(f"integrity scrubber every {cfg.storage.scrub_interval}s "
              f"at {cfg.storage.scrub_mb_per_sec} MB/s")

    if cfg.storage.tiering_uri:
        from ..storage import tiering

        tiering.configure(cfg.storage.tiering_uri)
        if cfg.storage.tiering_interval > 0:
            server.tiering_job = tiering.TieringJob(
                server.coord.engine, cfg.storage.tiering_interval,
                cfg.storage.tiering_cold_after_s)
            server.tiering_job.start()
            print(f"cold tiering → {cfg.storage.tiering_uri} every "
                  f"{cfg.storage.tiering_interval}s "
                  f"(cold after {cfg.storage.tiering_cold_after_s}s)")
        else:
            print(f"cold tier configured → {cfg.storage.tiering_uri} "
                  f"(no background sweep)")

    if cfg.storage.wal_archive_uri:
        from ..config import ConfigError
        from ..storage import backup

        arch_opts = None
        if cfg.storage.wal_archive_options:
            try:
                arch_opts = json.loads(cfg.storage.wal_archive_options)
            except ValueError as e:
                raise ConfigError(
                    f"bad [storage] wal_archive_options JSON: {e}")
        backup.configure_archive(cfg.storage.wal_archive_uri, arch_opts)
        # vnodes opened before this point (engine boot replay) missed the
        # __init__ attach hook: wire them now so fence + catch_up cover
        # every WAL in the process
        for v in list(server.coord.engine.vnodes.values()):
            backup.attach_vnode(v)
        print(f"WAL archive → {cfg.storage.wal_archive_uri} "
              f"(continuous archiving + BACKUP/RESTORE enabled)")

    if cfg.trace.otlp_endpoint:
        from .trace import GLOBAL_COLLECTOR, OtlpExporter

        OtlpExporter(cfg.trace.otlp_endpoint, GLOBAL_COLLECTOR,
                     batch_size=cfg.trace.batch_size,
                     flush_interval_s=cfg.trace.flush_interval_s)
        print(f"otlp export → {cfg.trace.otlp_endpoint}/v1/traces")

    async def ttl_job():
        """Bucket TTL expiry (reference meta_admin.rs:848 + ResourceManager):
        drop vnodes of expired buckets. Also reclaims the DROP recycle
        bin once entries outlive the recovery window."""
        trash_retention_s = 24 * 3600.0
        while True:
            await asyncio.sleep(60)
            now = int(_time.time() * 1e9)
            for owner in list(server.meta.databases):
                tenant, db = owner.split(".", 1)
                try:
                    for bucket in server.meta.expire_buckets(tenant, db, now):
                        for rs in bucket.shard_group:
                            for v in rs.vnodes:
                                # tier-then-expire: expired vnodes also
                                # release their cold-tier objects
                                server.coord.engine.drop_vnode(
                                    owner, v.id, purge_cold=True)
                except Exception:
                    pass
            try:
                server.meta.purge_trash(older_than_s=trash_retention_s)
            except Exception:
                pass

    ssl_context = None
    if cfg.security.enabled:
        import ssl as _ssl

        ssl_context = _ssl.SSLContext(_ssl.PROTOCOL_TLS_SERVER)
        ssl_context.load_cert_chain(cfg.security.tls_cert_path,
                                    cfg.security.tls_key_path)

    async def main():
        await server.start(port=args.http_port, ssl_context=ssl_context)
        if cfg.query.auth_enabled:
            # the telnet put protocol carries no credentials; exposing it
            # on an authenticated server would bypass RBAC entirely
            print("opentsdb tcp disabled: auth_enabled (telnet has no auth)")
        else:
            try:
                main._tcp = await server.start_tcp_opentsdb(
                    port=cfg.service.tcp_listen_port)
                print(f"opentsdb tcp on :{cfg.service.tcp_listen_port}")
            except Exception as e:
                print(f"opentsdb tcp disabled: {e}")
        try:
            from .flight import start_flight_server

            start_flight_server(server.executor, flight_port,
                                auth_enabled=cfg.query.auth_enabled)
            print(f"flight sql on :{flight_port}")
        except Exception as e:
            print(f"flight sql disabled: {e}")
        # hold a strong reference: the loop keeps only weak refs to tasks
        main._ttl_task = asyncio.get_running_loop().create_task(ttl_job())
        print(f"cnosdb-tpu listening on :{args.http_port} "
              f"(data dir {args.data_dir}, mode {getattr(args, 'mode', 'singleton')})")
        while True:
            await asyncio.sleep(3600)

    try:
        asyncio.run(main())
    except KeyboardInterrupt:
        if server.scrubber is not None:
            server.scrubber.stop()
        server.coord.close()
    return 0


def run_meta_server(args) -> int:
    """Standalone meta service process (reference cnosdb-meta binary,
    meta/src/bin/main.rs + service/http.rs). With --meta-peers it joins a
    replicated meta raft group."""
    import os
    import time as _time

    from ..parallel.meta_service import MetaService

    store = MetaStore(os.path.join(args.data_dir, "meta", "meta.json"),
                      register_self=False)
    peers = {}
    for spec in (getattr(args, "meta_peers", None) or "").split(","):
        if "@" in spec:
            nid, _, addr = spec.partition("@")
            peers[int(nid)] = addr
    # loopback by default: the msgpack RPC surface carries no auth, so
    # exposing it beyond the host is an explicit operator decision
    svc = MetaService(store, host=getattr(args, "meta_host", None)
                      or "127.0.0.1",
                      port=getattr(args, "meta_port", 8901) or 8901,
                      node_id=getattr(args, "node_id", None) if peers else None,
                      peers=peers or None,
                      raft_dir=os.path.join(args.data_dir, "meta", "raft"))
    svc.start()
    print(f"cnosdb-tpu meta listening on {svc.addr} "
          f"(data dir {args.data_dir}"
          + (f", raft member {args.node_id} of {sorted(peers)}" if peers
             else "") + ")")
    try:
        while True:
            _time.sleep(3600)
    except KeyboardInterrupt:
        svc.stop()
    return 0
