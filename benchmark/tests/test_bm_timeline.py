"""The per-layer metrics that read the program's own timeline
(benchmark/timeline.py and its readers): a CPU rehearsal of the live cell
reports them, and a program without the timeline, or a window whose
spans the ring dropped, gives no number and no error."""
import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from benchmark import harness, timeline  # noqa: E402

CELL = "devops100-live"
# the readers of the timeline; host.unnamed_pct reads the last traced
# slice, which a rehearsal does not record
SPAN_METRICS = ("write.parse_ms", "write.queue_ms", "write.lock_wait_ms",
                "write.wal_ms", "write.flush_ms", "query.wait_ms",
                "service.loop_busy_pct")
SLICE_METRICS = ("host.unnamed_pct",)


def test_the_manifest_lists_the_timeline_metrics_in_the_live_cell():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in SPAN_METRICS + SLICE_METRICS:
        m = per_layer[name]
        assert m["workloads"] == [CELL] and m["moves"] == "ingest_rows_per_s"
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{name}.py"))


def test_a_traced_rehearsal_reports_every_span_metric():
    env = {**os.environ, "CNOSDB_TORCH_PLACEMENT": "cpu"}
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         "2147483659", "--seconds", "3", "--trace", "1", "--rehearse"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().split("\n")[-1])
    assert out["correct"] is True
    got = out["metrics"]
    for name in SPAN_METRICS:
        assert isinstance(got[name]["value"], float), (name, got.get(name))
        assert got[name]["value"] >= 0.0
    for name in SLICE_METRICS:
        assert name not in got
    q = got["write.queue_ms"]
    assert q["batches"] > 0 and q["root_ms"] > 0
    # the root span is its parts: body, parse, queue, apply, resume, and
    # a little bookkeeping on the loop
    parts = (got["write.parse_ms"]["value"] + q["value"] + q["apply_ms"]
             + q["body_ms"] + q["resume_ms"])
    assert 0.8 * q["root_ms"] <= parts <= q["root_ms"] * 1.001
    assert 0.0 < got["service.loop_busy_pct"]["value"] < 100.0
    w = got["query.wait_ms"]
    assert w["value"] == pytest.approx(
        w["queue_ms"] + w["admission_ms"] + w["lock_wait_ms"])
    # the parts of a query on the node lie within its clients' time
    node = sum(w[k] for k in ("queue_ms", "admission_ms", "body_ms",
                              "resume_ms", "http.render_ms", "wall_ms"))
    assert 0.0 < node <= w["client_ms"]


def _run(t0, t1, profiled=()):
    return harness.Run(CELL, {}, {}, t1 - t0, t0, t1, [], 0.0, None,
                       profiled)


def _readers():
    return {n: harness.metric_reader(n) for n in SPAN_METRICS + SLICE_METRICS}


def _records(coll, t_ns):
    """One batch: a root, its parse and a lock wait behind a flush, and
    one flush, on the collector `coll`, from `t_ns` on."""
    coll.add("http:write", "tA", "r", None, 1, t_ns, t_ns + 9_000_000)
    coll.add("write.parse_ms", "tA", "p", "r", 1, t_ns + 1_000_000,
             t_ns + 3_000_000)
    coll.add("write.lock_wait_ms", "tA", "w", "r", 2, t_ns + 4_000_000,
             t_ns + 6_000_000, 0, {"holder": "flush_ms"})
    coll.add("flush_ms", "tB", "f", None, 3, t_ns + 2_000_000,
             t_ns + 7_000_000, 4_000_000, {"trigger": "inline", "rows": 10})


def test_the_readers_read_a_window_of_the_timeline(monkeypatch):
    import time

    from cnosdb_tpu_torch.utils import stages

    coll = stages.TraceCollector(capacity=64)
    monkeypatch.setattr(stages, "GLOBAL_COLLECTOR", coll)
    t0 = time.monotonic()
    start = int(stages.now_ns() + 0.1e9)
    _records(coll, start)
    run = _run(t0, t0 + 1.0, [(t0 + 0.5, t0 + 0.9)])
    r = _readers()
    assert r["write.parse_ms"](run)["value"] == pytest.approx(2.0)
    lw = r["write.lock_wait_ms"](run)
    assert lw["value"] == pytest.approx(2.0)
    assert lw["holder.flush_ms"] == pytest.approx(2.0)
    fl = r["write.flush_ms"](run)
    assert fl["value"] == pytest.approx(5.0) and fl["rows"] == 10
    assert fl["trigger.inline"] == 1
    # the loop's thread (the root's) held only the parse: 2 ms of the
    # window's 0.6 s outside the slice
    busy = r["service.loop_busy_pct"](run)["value"]
    assert busy == pytest.approx(100 * 0.002 / 0.6, rel=1e-3)
    # no span in the slice: all of it unnamed
    assert r["host.unnamed_pct"](run)["value"] == pytest.approx(100.0)


def test_a_dropped_window_and_a_program_without_a_timeline_give_none(
        monkeypatch):
    import time

    from cnosdb_tpu_torch.utils import stages

    coll = stages.TraceCollector(capacity=2)
    monkeypatch.setattr(stages, "GLOBAL_COLLECTOR", coll)
    t0 = time.monotonic()
    _records(coll, int(stages.now_ns() + 0.1e9))
    assert coll.dropped == 2
    run = _run(t0, t0 + 1.0, [(t0 + 0.05, t0 + 0.9)])
    for name, read in _readers().items():
        assert read(run) is None, name
    # a program before the timeline: its stages module has no ring
    monkeypatch.delattr(stages, "GLOBAL_COLLECTOR")
    for name, read in _readers().items():
        if name != "query.wait_ms":
            assert read(run) is None, name


def test_outermost_and_union():
    spans = [{"span_id": "a", "parent_id": None, "name": "write.apply_ms"},
             {"span_id": "b", "parent_id": "a", "name": "write.wal_ms"},
             {"span_id": "c", "parent_id": "b", "name": "write.apply_ms"},
             {"span_id": "d", "parent_id": None, "name": "write.apply_ms"}]
    assert [s["span_id"] for s in
            timeline.outermost(spans, "write.apply_ms")] == ["a", "d"]
    assert timeline.union_s([(0, 1), (0.5, 2), (3, 4)]) == 3.0
    assert timeline.union_s([]) == 0.0
