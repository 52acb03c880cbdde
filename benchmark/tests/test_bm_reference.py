"""The plain reference against brute-force loops on tiny data."""
import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(HERE))
from benchmark import check, reference, tsbs  # noqa: E402


def mix_query(name):
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)["readers"]["query"]


def tiny(name="tsbs-devops-4000", scale=6, span_s=5 * 3600):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    return {**cfg, "scale": scale, "span_s": span_s}


def brute(cfg, q, p, hist):
    """Loop over every point: the groups and their aggregates."""
    ts = tsbs.timestamps(cfg)
    hosts = p["hosts"] or range(cfg["scale"])
    groups = {}
    for h in hosts:
        for i, t in enumerate(ts):
            if p["lo"] <= t < p["hi"]:
                key = (h if q["by_host"] else -1,
                       int(t) - int(t) % (q["bin_s"] * tsbs.NS))
                groups.setdefault(key, []).append(
                    [hist[f, h, i] for f in range(q["fields"])])
    out = {}
    for key, rows in groups.items():
        a = np.array(rows)
        out[key] = (a.mean(axis=0) if q["agg"] == "avg" else a.max(axis=0))
    return out


CPU_MAX_ALL = {"name": "cpu-max-all-8", "agg": "max", "fields": 10,
               "by_host": False, "hosts": 4, "bin_s": 3600}


@pytest.mark.parametrize("query", [mix_query("double-groupby-1"),
                                   CPU_MAX_ALL])
def test_reference_matches_a_loop(query):
    cfg = tiny()
    q = {**query, "window_s": 3 * 3600}
    hist = tsbs.history(cfg, 11)
    stream = tsbs.query_stream(cfg, q, 11, 0)
    for _ in range(3):
        p = next(stream)
        got = reference.answer(cfg, q, p, hist)
        want = brute(cfg, q, p, hist)
        keys = list(zip(got["host"].tolist(), got["t"].tolist()))
        assert sorted(keys) == sorted(want)
        for j, k in enumerate(keys):
            for fi, f in enumerate(tsbs.query_fields(cfg, q)):
                assert got[f][j] == pytest.approx(want[k][fi], rel=1e-12)


def test_history_is_a_clamped_walk_from_the_seed():
    cfg = tiny()
    a, b = tsbs.history(cfg, 2**31 + 5), tsbs.history(cfg, 2**31 + 5)
    assert np.array_equal(a, b)
    assert a.min() >= 0.0 and a.max() <= 100.0
    steps = np.diff(a, axis=2)
    assert 0.5 < steps.std() < 1.5
    assert not np.array_equal(a, tsbs.history(cfg, 2**31 + 6))


def test_batch_rows_and_totals_match_a_loop():
    cfg = tiny("tsbs-devops-100", scale=5)
    vals = tsbs.live_values(cfg, 3, 1, 20)
    times = tsbs.live_times(cfg, 7, 20)
    rows = reference.batch_rows(cfg, vals, times)
    k = 0
    for h in range(5):
        for s in range(4):
            assert rows["host"][k] == h and rows["t"][k] == times[s]
            for fi, f in enumerate(cfg["fields"]):
                assert rows[f][k] == vals[s, h, fi]
            k += 1
    tot = reference.host_totals(cfg, lambda b: vals, [7, 8], 20)
    assert tot["count"].tolist() == [8] * 5
    assert np.allclose(tot["sum"], 2 * vals.sum(axis=0), rtol=1e-12)


def test_line_protocol_round_trips_every_value():
    cfg = tiny("tsbs-devops-100", scale=3)
    tags = tsbs.host_tags(cfg, 4)
    vals = tsbs.live_values(cfg, 4, 0, 6)
    body = tsbs.batch_body(tsbs.template_rows(cfg, tags, vals),
                           tsbs.live_times(cfg, 2, 6), 3).decode()
    lines = body.strip().split("\n")
    assert len(lines) == 6
    for i, line in enumerate(lines):
        series, fields, ts = line.split(" ")
        assert series.startswith(f"cpu,hostname=host_{i % 3},region=")
        got = [float(kv.split("=")[1]) for kv in fields.split(",")]
        assert got == vals[i // 3, i % 3].tolist()
        assert int(ts) == tsbs.live_times(cfg, 2, 6)[i // 3]


def test_compare_counts_missing_extra_and_changed_groups():
    want = {"host": np.array([0, 0, 1]), "t": np.array([1, 2, 1]),
            "v": np.array([10.0, 20.0, 30.0])}
    same = check.compare(dict(want), want, ["v"])
    assert same == {"keys_wrong": 0, "gap": 0.0, "values_differ": 0}
    moved = {**want, "v": np.array([10.0, 20.0, 30.0 * (1 + 1e-9)])}
    assert check.compare(moved, want, ["v"])["gap"] == pytest.approx(1e-9)
    fewer = {k: v[:2] for k, v in want.items()}
    assert check.compare(fewer, want, ["v"])["keys_wrong"] == 1
    more = {k: np.r_[v, v[:1]] for k, v in want.items()}
    assert check.compare(more, want, ["v"])["keys_wrong"] == 1
