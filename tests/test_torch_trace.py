"""The port's process timeline (utils/stages.py, server/trace.py): spans
on the write path and on every wait, on the CPU; and, on a card, the
timeline's clock against torch.profiler's device trace.

The file imports neither jax nor cnosdb_tpu. Its card test:

    python -m pytest --noconftest -q -m cuda tests/test_torch_trace.py
"""
import asyncio
import json
import os
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

from cnosdb_tpu_torch.models.points import SeriesRows, WriteBatch
from cnosdb_tpu_torch.models.schema import ValueType
from cnosdb_tpu_torch.models.series import SeriesKey, Tag
from cnosdb_tpu_torch.storage import scan as scan_mod
from cnosdb_tpu_torch.storage.vnode import VnodeStorage
from cnosdb_tpu_torch.utils import stages

WRITE_CHILDREN = ("write.parse_ms", "write.queue_ms", "write.apply_ms",
                  "write.lock_wait_ms", "write.wal_ms")
QUERY_WAITS = ("queue_ms", "admission_ms", "lock_wait_ms", "http.render_ms",
               "body_ms", "resume_ms")


class Server:
    """A singleton node's HTTP service on a local port, its event loop
    on a thread of its own."""

    def __init__(self, data_dir: str):
        from cnosdb_tpu_torch.server.http import build_server

        self.server = build_server(data_dir)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.port = s.getsockname()[1]
        self.loop = asyncio.new_event_loop()
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)

            async def boot():
                self.runner = await self.server.start("127.0.0.1", self.port)
                started.set()

            self.loop.create_task(boot())
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(15)

    def post(self, path: str, body: str, headers: dict | None = None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}{path}", data=body.encode(),
            headers=headers or {}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers, resp.read().decode()

    def close(self):
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(),
                                         self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        assert not self.thread.is_alive()
        self.server.coord.close()


@pytest.fixture
def server(tmp_path, monkeypatch):
    monkeypatch.setenv("CNOSDB_TORCH_PLACEMENT", "cpu")
    srv = Server(str(tmp_path / "node"))
    try:
        yield srv
    finally:
        srv.close()


def _write_body(n_hosts: int, n_points: int, t0: int = 1_640_995_200) -> str:
    return "\n".join(
        f"cpu,hostname=h{h} usage_user={h + i * 0.5},usage_system={i} "
        f"{(t0 + i * 10) * 10**9}"
        for i in range(n_points) for h in range(n_hosts))


def _spans_of(trace_id: str) -> list[dict]:
    return stages.GLOBAL_COLLECTOR.spans(trace_id, limit=10_000)


def _newest(name: str) -> dict:
    return [s for s in stages.GLOBAL_COLLECTOR.spans(limit=10_000)
            if s["name"] == name][-1]


def test_one_http_write_is_a_root_with_its_stages_nested(server):
    status, _h, _b = server.post("/api/v1/write?db=public",
                                 _write_body(4, 25))
    assert status == 200
    root = _newest("http:write")
    assert root["parent_id"] is None
    assert root["tags"]["rows"] == 100 and root["tags"]["status"] == 200
    kids = _spans_of(root["trace_id"])
    names = {s["name"] for s in kids}
    assert set(WRITE_CHILDREN) <= names, names
    end = root["start_ns"] + root["duration_ns"]
    for s in kids:
        assert s["trace_id"] == root["trace_id"]
        assert root["start_ns"] <= s["start_ns"]
        assert s["start_ns"] + s["duration_ns"] <= end, s["name"]
        assert 0 <= s["cpu_ns"]
    # parse on the event loop, the apply on an executor worker (the
    # usage counters' own writes, after it, run on the loop)
    by = {s["name"]: s for s in kids if s["parent_id"] == root["span_id"]
          and s["name"] != "write.apply_ms"}
    applies = [s for s in kids if s["parent_id"] == root["span_id"]
               and s["name"] == "write.apply_ms"
               and s["thread"] != root["thread"]]
    assert len(applies) == 1
    by["write.apply_ms"] = applies[0]
    assert by["write.parse_ms"]["thread"] == root["thread"]
    assert by["write.queue_ms"]["thread"] == by["write.apply_ms"]["thread"]
    assert by["write.queue_ms"]["cpu_ns"] == 0
    # the queue wait ends where the apply begins, after the parse
    parse_end = by["write.parse_ms"]["start_ns"] + \
        by["write.parse_ms"]["duration_ns"]
    assert parse_end <= by["write.queue_ms"]["start_ns"]
    assert by["write.queue_ms"]["start_ns"] + \
        by["write.queue_ms"]["duration_ns"] <= by["write.apply_ms"]["start_ns"]


def test_a_profiled_query_carries_its_waits_in_the_summary(server):
    assert server.post("/api/v1/write?db=public", _write_body(3, 10))[0] == 200
    status, headers, body = server.post(
        "/api/v1/sql?db=public",
        "SELECT hostname, avg(usage_user) FROM cpu GROUP BY hostname",
        {"X-CnosDB-Profile": "1"})
    assert status == 200 and len(body.strip().splitlines()) == 4
    summary = json.loads(headers["X-CnosDB-Profile-Summary"])
    for name in QUERY_WAITS:
        assert name in summary["stages"], (name, summary["stages"])
        assert summary["stages"][name] >= 0.0
    root = _newest("http:sql")
    names = {s["name"] for s in _spans_of(root["trace_id"])}
    assert set(QUERY_WAITS) <= names, names


def _vnode(tmp_path, memcache_bytes: int) -> VnodeStorage:
    return VnodeStorage(1, str(tmp_path / "vnode"),
                        memcache_bytes=memcache_bytes)


def _batch(n_hosts: int, n_points: int, t0: int = 0) -> WriteBatch:
    wb = WriteBatch()
    ts = np.arange(t0, t0 + n_points, dtype=np.int64) * 10**9
    for h in range(n_hosts):
        wb.add_series("cpu", SeriesRows(
            SeriesKey("cpu", [Tag("hostname", f"h{h}")]), ts,
            {"v": (int(ValueType.FLOAT),
                   np.arange(n_points, dtype=np.float64) + h)}))
    return wb


def test_a_write_past_the_memory_cache_flushes_inline(tmp_path):
    v = _vnode(tmp_path, memcache_bytes=1024)
    try:
        with stages.GLOBAL_COLLECTOR.span("caller") as caller:
            v.write(_batch(4, 200))
        flush = _newest("flush_ms")
        assert flush["trace_id"] == caller.trace_id
        assert flush["tags"]["trigger"] == "inline"
        assert flush["tags"]["rows"] == 800
        assert flush["tags"]["bytes"] > 0
        assert len(v.summary.version.all_files()) == 1
        v.flush()
        assert _newest("flush_ms")["tags"]["trigger"] == "explicit"
    finally:
        v.close()


def test_a_scan_behind_a_flush_names_the_flush_as_holder(tmp_path,
                                                         monkeypatch):
    from cnosdb_tpu_torch.storage import vnode as vnode_mod

    v = _vnode(tmp_path, memcache_bytes=64 * 1024 * 1024)
    v.write(_batch(2, 50))
    entered, release = threading.Event(), threading.Event()
    real = vnode_mod.flush_memcache

    def slow_flush(*a, **k):
        entered.set()
        assert release.wait(30)
        return real(*a, **k)

    monkeypatch.setattr(vnode_mod, "flush_memcache", slow_flush)
    flusher = threading.Thread(target=v.flush)
    flusher.start()
    try:
        assert entered.wait(30)
        got = []
        scanner = threading.Thread(
            target=lambda: got.append(scan_mod.scan_vnode(v, "cpu")))
        scanner.start()
        time.sleep(0.2)
        release.set()
        scanner.join(30)
        flusher.join(30)
        assert not scanner.is_alive() and not flusher.is_alive()
        assert got and got[0].n_rows == 100
        waits = [s for s in stages.GLOBAL_COLLECTOR.spans(limit=10_000)
                 if s["name"] == "lock_wait_ms"
                 and (s["tags"] or {}).get("holder") == "flush_ms"]
        assert waits and max(w["duration_ns"] for w in waits) >= 0.15e9
        # a wait, not work: the waiter's CPU is a sliver of its span
        assert min(w["cpu_ns"] for w in waits) < 0.05e9
    finally:
        release.set()
        v.close()


def test_the_ring_counts_what_it_drops():
    c = stages.TraceCollector(capacity=4)
    for i in range(10):
        c.add(f"s{i}", "t", f"{i}", None, 1, i * 10, i * 10 + 5)
    assert c.dropped == 6
    assert [r[1] for r in c.records()] == ["s6", "s7", "s8", "s9"]
    # a window that reaches back past the oldest span kept: spans of it
    # may be gone
    assert c.window(0, 100) is None
    assert c.window(60, 100) is None
    # a window that starts after the oldest span kept ended: whole
    assert [r[1] for r in c.window(66, 100)] == ["s7", "s8", "s9"]
    fresh = stages.TraceCollector(capacity=4)
    assert fresh.dropped == 0 and fresh.window(0, 10) == []


def test_a_stage_without_a_profile_records_its_span_and_no_profile():
    other = stages.QueryProfile()
    assert stages.current_profile() is None
    with stages.stage("write.wal_ms") as span:
        span.set_tag("rows", 3)
    rec = _newest("write.wal_ms")
    assert rec["span_id"] == span.span_id and rec["tags"] == {"rows": 3}
    assert rec["parent_id"] is None
    assert other.ms == {} and other.counts == {}
    # with a profile in scope the same call lands in it too, as before
    prof = stages.QueryProfile()
    with stages.profile_scope(prof):
        with stages.stage("write.wal_ms"):
            pass
    assert set(prof.ms) == {"write.wal_ms"} and other.ms == {}


def test_waited_spans_a_hand_off_between_threads():
    t0 = stages.now_ns()
    prof = stages.QueryProfile()

    def worker():
        with stages.profile_scope(prof):
            time.sleep(0.01)
            stages.waited("queue_ms", t0)

    with stages.GLOBAL_COLLECTOR.span("root") as root:
        th = threading.Thread(target=worker)
        th.start()
        th.join(10)
    rec = _newest("queue_ms")
    assert rec["duration_ns"] >= 0.01e9 and rec["cpu_ns"] == 0
    assert rec["thread"] != root.thread
    assert prof.ms["queue_ms"] >= 10.0


def test_a_span_is_timed_on_monotonic_and_starts_on_the_epoch():
    mono, wall = time.monotonic(), time.time_ns()
    assert abs(stages.monotonic_s(stages.now_ns()) - mono) < 0.05
    with stages.stage("write.wal_ms") as span:
        pass
    assert abs(stages.monotonic_s(span.start_ns) - mono) < 0.05
    assert abs(span.epoch_ns - wall) < 0.05e9
    # what readers outside the process see starts on the epoch's clock
    rec = _newest("write.wal_ms")
    assert rec["span_id"] == span.span_id
    assert rec["start_ns"] == span.epoch_ns
    assert rec["duration_ns"] == span.duration_ns
    # a wait recorded after it ended is put on the epoch by the clocks'
    # distance when it ends
    t0 = stages.now_ns()
    stages.waited("queue_ms", t0)
    wait = _newest("queue_ms")
    assert abs(wait["start_ns"] - (t0 + time.time_ns() - time.monotonic_ns())) \
        < 0.05e9


def test_an_rpc_stage_is_a_child_of_the_callers_span():
    from cnosdb_tpu_torch.parallel.net import RpcServer, rpc_call

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = RpcServer("127.0.0.1", port, {"echo": lambda p: p}).start()
    try:
        with stages.GLOBAL_COLLECTOR.span("caller") as caller:
            assert rpc_call(f"127.0.0.1:{port}", "echo", {"x": 1}) == {"x": 1}
    finally:
        srv.stop()
    rpc = _newest("rpc:echo")
    assert rpc["trace_id"] == caller.trace_id
    assert rpc["parent_id"] == caller.span_id
    stage = _newest("rpc_echo_ms")
    assert stage["trace_id"] == caller.trace_id
    assert stage["parent_id"] == rpc["span_id"]


@pytest.mark.cuda
def test_a_kernel_lies_inside_its_span_on_the_device_trace(tmp_path):
    """The clock rule: a span opened around two kernel launches (a spin of
    about a millisecond, then an elementwise product) and their
    synchronise holds both kernels' intervals in torch.profiler's
    CUDA-only trace, once the trace's events are put at
    baseTimeNanoseconds + ts x 1,000. Were the trace's clock ahead of the
    timeline's by d, each span's first kernel would start more than d
    after the span, and were it behind, each span's last kernel would end
    more than -d before the span's end: the smallest of those leads and
    tails bound the misalignment."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.randn(1 << 22, device="cuda")
    torch.cuda.synchronize()
    spans = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            with stages.GLOBAL_COLLECTOR.span("clock.probe") as sp:
                torch.cuda._sleep(2_000_000)
                y = x.mul(2.0)
                torch.cuda.synchronize()
            spans.append((sp.epoch_ns, sp.epoch_ns + sp.duration_ns))
            time.sleep(0.01)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    kernels = sorted(
        (base + float(e["ts"]) * 1e3,
         base + (float(e["ts"]) + float(e["dur"])) * 1e3)
        for e in doc["traceEvents"]
        if e.get("cat") == "kernel" and e.get("ph") == "X")
    assert len(kernels) == 2 * len(spans), (len(kernels), spans)
    lead_us, tail_us = [], []
    for i, (s, e) in enumerate(spans):
        (spin_s, _spin_e), (_mul_s, mul_e) = kernels[2 * i], kernels[2 * i + 1]
        assert s < spin_s and mul_e < e, ((s, e), kernels[2 * i:2 * i + 2])
        lead_us.append((spin_s - s) / 1e3)
        tail_us.append((e - mul_e) / 1e3)
    print(f"# clock rule (baseTimeNanoseconds {base}): every kernel inside "
          f"its span; leads {sorted(lead_us)!r} us, tails "
          f"{sorted(tail_us)!r} us: the trace's clock is within "
          f"{min(lead_us)!r} us ahead and {min(tail_us)!r} us behind")
    assert float(y[0]) == float(x[0]) * 2.0
