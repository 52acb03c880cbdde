"""Cross-process RPC plane: msgpack over HTTP.

This is the rebuild's counterpart of the reference's tonic/gRPC node-to-node
plane (common/protos/proto/kv_service.proto TSKVService + raft_service.proto,
replication/src/network_grpc.rs, meta/src/service/http.rs): a thread-per-
request HTTP server carrying msgpack request/reply bodies, and a client with
per-thread persistent connections. HTTP instead of gRPC because the callers
are synchronous engine/raft threads (thread-per-request matches the raft
tick/propose model the way tonic's tasks match tokio), and msgpack because
the payloads are already msgpack throughout the storage layer; Arrow IPC
rides inside scan replies as opaque bytes (reference serialize.rs:30
TonicRecordBatchEncoder ↔ BatchBytesResponse).

Wire form: POST /rpc/<method> with a msgpack body → 200 + msgpack reply,
or 500 + msgpack {"_err": class, "_msg": str} re-raised client-side.
"""
from __future__ import annotations

import hmac
import http.client
import logging
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from socket import timeout as socket_timeout

import msgpack

from .. import faults
from . import health
from ..errors import CnosError, DeadlineExceeded
from ..utils import deadline as deadline_mod
from ..utils import stages
from ..utils.backoff import Backoff
from ..utils import lockwatch

log = logging.getLogger("cnosdb.rpc")

faults.register_point("rpc.send", __name__, scope="cluster",
                      desc="client connect/send to a peer")
faults.register_point("rpc.response", __name__, scope="cluster",
                      desc="reply lost in flight after the server applied")
faults.register_point("rpc.server", __name__, scope="cluster",
                      desc="server-side dispatch of an inbound method")
faults.register_point("rpc.reply", __name__, scope="cluster",
                      desc="server reply serialization/drop")

# Intra-cluster shared secret (CNOSDB_CLUSTER_SECRET): when set, every RPC
# must carry it — the plane exposes destructive admin and file-installing
# methods (vnode_install, meta_restore, raft_msg), so any deployment that
# binds beyond loopback MUST either set this or isolate the network. Read
# at call time so harness-spawned processes inherit it from their env.
SECRET_HEADER = "x-cnosdb-cluster-secret"


def cluster_secret() -> str | None:
    return os.environ.get("CNOSDB_CLUSTER_SECRET") or None


class RpcError(CnosError):
    pass


class RpcUnauthorized(RpcError):
    """Missing/wrong cluster secret."""


class RpcUnavailable(RpcError):
    """Peer unreachable (connection refused / reset / timeout)."""


class RpcThrottled(RpcUnavailable):
    """Call refused locally by the breaker's slow-start ramp — the peer
    was never contacted, so this is NOT evidence of a broken replica
    (failover paths must not mark vnodes broken on it)."""


def pack(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def unpack(raw: bytes):
    return msgpack.unpackb(raw, raw=False, strict_map_key=False)


class RpcServer:
    """Serves `handlers[method](payload) -> reply` at POST /rpc/<method>.

    `node_id` (when the owner has one, e.g. DataNodeService) labels the
    per-request sub-profiles this server returns to profiling callers."""

    def __init__(self, host: str, port: int, handlers: dict,
                 node_id: int | None = None):
        self.node_id = node_id
        self.handlers = dict(handlers)
        if faults.CTL_ARMED:
            # runtime fault control for chaos harnesses — only exposed when
            # the process was launched with CNOSDB_FAULTS in its environment
            self.handlers.setdefault("_faults", faults.control)
            # memory-broker control (memory_pressure nemesis squeezes /
            # restores the budget at runtime) rides the same arming knob
            from ..server import memory as _memory

            self.handlers.setdefault("_memory", _memory.control)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # small replies otherwise stall ~40ms on Nagle + delayed-ACK
            # — a latency floor that buries every probe/cancel RPC and
            # poisons the health scorer's latency baselines
            disable_nagle_algorithm = True

            def log_message(self, *a):  # quiet
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n) if n else b""
                method = self.path.rsplit("/", 1)[-1]
                secret = cluster_secret()
                if secret is not None and not hmac.compare_digest(
                        self.headers.get(SECRET_HEADER, ""), secret):
                    self._reply(403, pack({"_err": "RpcUnauthorized",
                                           "_msg": "cluster secret required"}))
                    return
                fn = outer.handlers.get(method)
                if fn is None:
                    self._reply(404, pack({"_err": "NoSuchMethod", "_msg": method}))
                    return
                from ..server.trace import from_headers

                try:
                    if faults.ENABLED:
                        # fail/delay/crash before dispatch (server-side fault)
                        faults.fire("rpc.server", method=method)
                    payload = unpack(body) if body else {}
                    # per-query profiling envelope: a profiling caller
                    # marks the payload; the handler then runs inside a
                    # node-local QueryProfile whose stage timings ride
                    # back in the reply for the coordinator to merge
                    want_profile = bool(
                        isinstance(payload, dict)
                        and payload.pop("_profile", False))
                    # request-lifecycle envelope: the caller's remaining
                    # deadline (wall-clock epoch ms) and query id ride in
                    # the payload; install them as this handler thread's
                    # context so nested work (scans, decode pool, further
                    # RPC hops) inherits the shrinking budget
                    dl = None
                    if isinstance(payload, dict) and (
                            "_deadline_ms" in payload or "_qid" in payload):
                        dl = deadline_mod.from_wire(
                            payload.pop("_deadline_ms", None),
                            qid=payload.pop("_qid", None))
                        if dl.expired() or (dl.qid and
                                            deadline_mod.CANCELS
                                            .is_cancelled(dl.qid)):
                            # reject already-dead work on dequeue instead
                            # of executing it (it sat in a queue/delay
                            # longer than the caller was willing to wait)
                            deadline_mod.bump("expired_rejected")
                            stages.count_error(f"rpc.{method}.expired")
                            self._reply(500, pack(
                                {"_err": "DeadlineExceeded",
                                 "_msg": f"{method}: work expired before "
                                         f"dispatch"}))
                            return
                    prof = stages.QueryProfile(node_id=outer.node_id) \
                        if want_profile else None
                    with stages.profile_scope(prof), \
                            from_headers(self.headers, f"rpc:{method}"):
                        with stages.stage(f"rpc_{method}_ms"):
                            if dl is not None and dl.qid:
                                deadline_mod.CANCELS.register(dl.qid, dl)
                                try:
                                    with deadline_mod.scope(dl):
                                        reply = fn(payload)
                                finally:
                                    deadline_mod.CANCELS.unregister(
                                        dl.qid, dl)
                            elif dl is not None:
                                with deadline_mod.scope(dl):
                                    reply = fn(payload)
                            else:
                                reply = fn(payload)
                    if prof is not None and isinstance(reply, dict):
                        # reply envelope: this handler's node-local
                        # sub-profile rides home for the caller to merge
                        reply = dict(reply)
                        reply["_profile"] = prof.to_wire()
                    if faults.ENABLED and faults.fire("rpc.reply",
                                                      method=method):
                        # injected lost ack: the handler HAS applied the
                        # mutation; drop the reply so the client sees a
                        # response-phase failure (net.py retry policy must
                        # not re-execute it)
                        self.close_connection = True
                        return
                    self._reply(200, pack(reply))
                except Exception as e:  # propagate to caller, keep serving
                    stages.count_error(f"rpc.{method}")
                    log.debug("rpc handler %s failed", method, exc_info=True)
                    self._reply(500, pack({"_err": type(e).__name__,
                                           "_msg": str(e)}))

            def _reply(self, status: int, raw: bytes):
                try:
                    self.send_response(status)
                    self.send_header("Content-Type", "application/msgpack")
                    self.send_header("Content-Length", str(len(raw)))
                    self.end_headers()
                    self.wfile.write(raw)
                except (BrokenPipeError, ConnectionResetError):
                    pass

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.addr = f"{host}:{self.port}"
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class _ConnPool:
    """Shared keep-alive connection pool keyed by peer address.

    Shared (not thread-local) because raft broadcast/election paths spawn
    short-lived sender threads — a per-thread cache would open a brand-new
    TCP connection for every raft message."""

    MAX_IDLE_PER_ADDR = 8
    # idle keep-alives older than this are closed instead of reused: a
    # peer restart leaves dead sockets behind, and every one of them
    # burns a connect-error + retry on its next use; age-evicting keeps
    # the stale-keep-alive race to the recently-active window
    MAX_IDLE_AGE_S = float(os.environ.get("CNOSDB_RPC_IDLE_MAX_AGE_S", "30"))

    def __init__(self):
        self.lock = lockwatch.Lock("net.conn_pool")
        # addr → [(conn, idle_since_monotonic), ...]; LIFO so the
        # freshest (least likely stale) connection is reused first
        self.idle: dict[str, list] = {}

    def get(self, addr: str, timeout: float):
        """→ (conn, reused) — reused connections may be stale keep-alives."""
        now = time.monotonic()
        stale, conn = [], None
        with self.lock:
            conns = self.idle.get(addr)
            while conns:
                c, t = conns.pop()
                if now - t > self.MAX_IDLE_AGE_S:
                    stale.append(c)
                    continue
                conn = c
                break
        for c in stale:   # close outside the pool lock
            c.close()
        if conn is not None:
            return conn, True
        host, _, port = addr.rpartition(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
        try:
            # connect eagerly so TCP_NODELAY applies to the FIRST request
            # too; the ~40ms Nagle/delayed-ACK stall on small payloads
            # would otherwise dwarf every probe/cancel RPC
            conn.connect()
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass   # unreachable peers surface on send, same as before
        return conn, False

    def put(self, addr: str, conn):
        with self.lock:
            conns = self.idle.setdefault(addr, [])
            if len(conns) < self.MAX_IDLE_PER_ADDR:
                conns.append((conn, time.monotonic()))
                return
        conn.close()


_pool = _ConnPool()


def rpc_call(addr: str, method: str, payload: dict | None = None,
             timeout: float = 10.0):
    """One RPC to `addr` ("host:port") over a pooled keep-alive connection.

    Retry policy: ONLY a non-timeout failure on a REUSED connection is
    retried (the classic stale keep-alive race, where the request cannot
    have been processed). A timeout or a fresh-connection failure is NOT
    retried — the server may have fully applied a non-idempotent mutation
    whose reply was lost, and re-executing it would double-apply.

    Deadline integration: when the calling thread carries a request
    deadline (utils/deadline.py), the remaining budget caps the socket
    timeout for this hop, the payload gains `_deadline_ms`/`_qid` so the
    peer can reject expired work and register for cancel fan-out, and an
    already-expired/cancelled context refuses to send at all."""
    # lock-order watchdog: an RPC issued with any mutex held means one
    # slow peer can stall every thread queued on that mutex
    lockwatch.note_blocking(f"rpc:{method}")
    dl = deadline_mod.current()
    if dl is not None:
        # raises DeadlineExceeded / cancelled QueryError when no budget
        # remains — do not open a socket for work that cannot finish
        timeout = dl.cap(timeout)
        wire = dl.to_wire_ms()
        if wire is not None or dl.qid is not None:
            payload = dict(payload or {})
            if wire is not None:
                payload["_deadline_ms"] = wire
            if dl.qid is not None:
                payload["_qid"] = dl.qid
    prof = stages.current_profile()
    if prof is not None:
        # profiling envelope: ask the peer to run this dispatch inside a
        # node-local profile and return it in the reply
        payload = dict(payload or {})
        payload["_profile"] = True
    body = pack(payload or {})
    from ..server.trace import TRACE_HEADER, current_trace_header

    hdrs = {"Content-Type": "application/msgpack"}
    secret = cluster_secret()
    if secret is not None:
        hdrs[SECRET_HEADER] = secret
    tid = current_trace_header()
    if tid:
        hdrs[TRACE_HEADER] = tid

    # gray-failure signal: EVERY completion of this call (success, typed
    # rejection, unreachable, deadline) feeds the process-global health
    # scorer; burn = fraction of the capped budget the hop consumed, only
    # meaningful when a deadline bounded the hop
    t0 = time.perf_counter()
    bounded = dl is not None and dl.remaining() is not None

    def _obs(outcome: str) -> None:
        elapsed = time.perf_counter() - t0
        burn = (elapsed / timeout) if bounded and timeout > 0 else None
        health.SCORER.observe(addr, method, elapsed, outcome, burn=burn)

    if faults.ENABLED:
        try:
            # simulated network partition toward (addr, method): checked
            # once per call, before any bytes move — the peer never sees it
            faults.fire("rpc.send", addr=addr, method=method)
        except faults.FaultInjected as e:
            _obs(health.UNREACHABLE)
            raise RpcUnavailable(f"{method}@{addr}: {e}") from e
    for attempt in range(_ConnPool.MAX_IDLE_PER_ADDR + 1):
        conn, reused = _pool.get(addr, timeout)
        conn.timeout = timeout
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
        try:
            conn.request("POST", f"/rpc/{method}", body, hdrs)
        except (ConnectionError, http.client.HTTPException, OSError,
                TimeoutError) as e:
            # send-phase failure: retry ONLY the stale-keep-alive case
            # (reused conn, non-timeout) — bounded by the pool size so a
            # flapping peer refilling the pool cannot loop us forever
            conn.close()
            if reused and not isinstance(e, (TimeoutError, socket_timeout)):
                continue
            _obs(health.UNREACHABLE)
            raise RpcUnavailable(f"{method}@{addr}: {e}") from e
        try:
            if faults.ENABLED:
                # reply lost in the network AFTER the server applied the
                # request — FaultInjected is an OSError, so it takes the
                # never-retry response-phase path below like a real loss
                faults.fire("rpc.response", addr=addr, method=method)
            resp = conn.getresponse()
            raw = resp.read()
            reply = unpack(raw) if raw else {}
        except (ConnectionError, http.client.HTTPException, OSError,
                TimeoutError) as e:
            # response-phase failure: the server may have fully processed a
            # non-idempotent mutation whose reply was lost — NEVER retry
            conn.close()
            _obs(health.UNREACHABLE)
            raise RpcUnavailable(f"{method}@{addr}: {e}") from e
        if resp.status == 200:
            _pool.put(addr, conn)
        else:
            # an errored exchange may leave the stream mid-frame (chunked
            # error bodies, aborted handlers): never pool it — the reuse
            # would surface as an unrelated stale-keep-alive failure later
            conn.close()
        if prof is not None and isinstance(reply, dict) \
                and "_profile" in reply:
            sub = reply.pop("_profile")
            if isinstance(sub, dict):
                # key the sub-profile by node/vnode/method so the
                # coordinator-side merge can attribute per node
                sub.setdefault("addr", addr)
                sub["method"] = method
                if isinstance(payload, dict) \
                        and payload.get("vnode_id") is not None:
                    sub["vnode"] = payload["vnode_id"]
                prof.merge_remote(sub)
        if resp.status == 403:
            # typed: auth misconfiguration is permanent — retry loops that
            # catch RpcError/RpcUnavailable must be able to fail fast
            _obs(health.REJECTED)
            raise RpcUnauthorized(f"{method}@{addr}: {reply.get('_msg')}")
        if resp.status != 200:
            if reply.get("_err") == "DeadlineExceeded":
                # typed: failover loops must unwind, not try the next
                # replica with a budget that is already gone
                _obs(health.DEADLINE)
                raise DeadlineExceeded(f"{method}@{addr}: {reply.get('_msg')}")
            _obs(health.REJECTED)
            raise RpcError(f"{method}@{addr}: "
                           f"{reply.get('_err')}: {reply.get('_msg')}")
        _obs(health.OK)
        return reply
    _obs(health.UNREACHABLE)
    raise RpcUnavailable(f"{method}@{addr}: pooled connections exhausted")


def wait_rpc_ready(addr: str, method: str = "ping", timeout: float = 10.0):
    """Poll until a peer answers (process start-up races in harnesses).

    Jittered exponential backoff instead of a fixed 50 ms spin: N nodes
    waiting on the same meta service otherwise hammer it in lockstep.
    A caller-carried request deadline caps the whole poll budget — a
    short-deadline request must not wait out the full 10 s default."""
    timeout = deadline_mod.cap_current(timeout)
    start = time.monotonic()
    deadline = start + timeout
    bo = Backoff(initial=0.02, cap=0.5)
    while True:
        try:
            return rpc_call(addr, method, {}, timeout=2.0)
        except RpcError as e:
            if time.monotonic() > deadline or not bo.sleep(deadline):
                elapsed = time.monotonic() - start
                raise RpcUnavailable(
                    f"{method}@{addr} not ready after {elapsed:.1f}s "
                    f"(last error: {e})") from e
