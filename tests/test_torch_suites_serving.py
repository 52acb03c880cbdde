"""The serving, straggler, overload and mesh suites of bench_suites.py
through both packages, on the CPU.

bench_suites_torch.py holds the port's copies: run_pointqps (the serving
plane's result cache and fused micro-batches), run_straggler (the hedge
lane), run_overload (the memory broker, write shedding and the group
spiller) and run_mesh (the mesh lane swept over 1, 2, 4 and 8 devices).
Here each runs in both packages:

- bench_suites.py's runners at their own sizes (pointqps and overload
  take no size; straggler and mesh take theirs from the environment), on
  directories of their own;
- the port's at small sizes: pointqps over 16 hosts (the first 16 of the
  reference's 64, drawn alike), 2 threads x 200 requests, 4 x 10 fused;
  overload over 32 hosts x 50 points; mesh over 20,000 rows on a pool of
  8 logical CPU shards (the reference has conftest's 8 virtual XLA
  devices); straggler with 6 iterations and a 40 ms delay.

The port's answers are held to the JAX package's on the same data
(points exactly, counts, min and max exactly, sums within rel 1e-12,
rows in the same order) and to the port's own oracles; each oracle
rejects a row fewer, a row more and a moved value. Overload and mesh run
with and without CNOSDB_TPU_FORCE_DEVICE_PATH=1 (X2's CPU twin, or the
numpy host kernels). No test asserts a time: the output's latency keys
are checked for presence only.
"""
import os
import shutil

import numpy as np
import pytest
import torch

import bench_suites
import bench_suites_torch as bst

ENV = {"CNOSDB_TORCH_PLACEMENT": "cpu"}
PQ = dict(n_hosts=16, threads=2, per_thread=200, fthreads=4, fper=10)
OV = dict(n_hosts=32, per=50)
MESH_ROWS, MESH_ITERS = 20_000, 2
STRAGGLER_ITERS, STRAGGLER_DELAY_MS = 6, 40.0
FORCE = ["host", "device"]      # CNOSDB_TPU_FORCE_DEVICE_PATH unset / 1


def _ref_parts(path):
    from cnosdb_tpu.parallel.coordinator import Coordinator
    from cnosdb_tpu.parallel.meta import MetaStore
    from cnosdb_tpu.sql.executor import QueryExecutor, Session
    from cnosdb_tpu.storage.engine import TsKv

    meta = MetaStore(str(path / "meta.json"))
    coord = Coordinator(meta, TsKv(str(path / "data")))
    return coord, QueryExecutor(meta, coord), Session(database="public")


def _port_parts(path):
    from cnosdb_tpu_torch.parallel.coordinator import Coordinator
    from cnosdb_tpu_torch.parallel.meta import MetaStore
    from cnosdb_tpu_torch.sql.executor import QueryExecutor, Session
    from cnosdb_tpu_torch.storage.engine import TsKv

    meta = MetaStore(str(path / "meta.json"))
    coord = Coordinator(meta, TsKv(str(path / "data")))
    return coord, QueryExecutor(meta, coord), Session(database="public")


def _tenant():
    from cnosdb_tpu_torch.parallel.meta import DEFAULT_TENANT

    return DEFAULT_TENANT


def _env(mp, force=None, **extra):
    for k, v in {**ENV, **extra}.items():
        mp.setenv(k, v)
    if force == "device":
        mp.setenv("CNOSDB_TPU_FORCE_DEVICE_PATH", "1")
    else:
        mp.delenv("CNOSDB_TPU_FORCE_DEVICE_PATH", raising=False)


def _same_rows(got, want, what):
    """Rows in the same order; floats within rel 1e-12, all else exact."""
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert len(g) == len(w), what
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-12, abs=0), (what, g, w)
            else:
                assert a == b, (what, g, w)


def _rows(rs):
    return list(zip(*[np.asarray(c).tolist() for c in rs.columns]))


def _changed(rs, col):
    """Answers that differ from `rs`: its last row dropped, its first row
    again at the end, and `col` of its first row moved."""
    from cnosdb_tpu_torch.sql.executor import ResultSet

    cols = [np.array(c, copy=True) for c in rs.columns]
    i = rs.names.index(col)
    v = cols[i][0]
    cols[i][0] = v + 1 if isinstance(v, (int, np.integer)) \
        else v + 1e-6 * (1 + abs(v))
    return [ResultSet(rs.names, [c[:-1] for c in rs.columns]),
            ResultSet(rs.names, [np.concatenate([c, c[:1]])
                                 for c in rs.columns]),
            ResultSet(rs.names, cols)]


# ---------------------------------------------------------------- pointqps
@pytest.fixture(scope="module")
def pointqps(tmp_path_factory):
    """(reference output, port output, reference parts, port parts)."""
    root = tmp_path_factory.mktemp("pointqps")
    with pytest.MonkeyPatch.context() as mp:
        _env(mp)
        mp.delenv("CNOSDB_SERVING", raising=False)
        r, p = _ref_parts(root / "ref"), _port_parts(root / "port")
        try:
            ref = bench_suites.run_pointqps(r[1], *_parts_args(r))
            port = bst.run_pointqps(p[1], p[0], _tenant(), "public", p[2],
                                    **PQ)
            yield ref, port, r, p
        finally:
            r[0].close()
            p[0].close()


def _parts_args(parts):
    """bench_suites' (executor, coord, tenant, db, session) after the
    executor."""
    coord, _ex, s = parts
    return coord, _tenant(), "public", s


def test_pointqps_output_has_the_reference_keys(pointqps):
    ref, port, _r, _p = pointqps
    assert set(ref) <= set(port), set(ref) - set(port)
    assert port["requests"] == PQ["threads"] * PQ["per_thread"]
    assert port["answers_checked"] == 2 * PQ["n_hosts"] + port["requests"] \
        + PQ["fthreads"] * PQ["fper"]
    for k in ("point_qps", "p50_ms", "p99_ms", "fused_qps"):
        assert port[k] > 0, k


def test_pointqps_fuses_and_hits_the_result_cache(pointqps):
    _ref, port, _r, _p = pointqps
    assert port["fused_queries"] > 0
    assert sum(port["fused_widths"].values()) > 0
    assert port["hit_ratio"] >= 0.9


@pytest.fixture(scope="module")
def pq_table():
    """The port's pointqps table as its oracle sees it (the first 16
    hosts of the reference's 64: the values are drawn host by host)."""
    rng = np.random.default_rng(47)
    ts = bst.BASE_TS + np.arange(64, dtype=np.int64) * 1_000_000_000
    return ts, bst.host_values(rng, PQ["n_hosts"], 64)


@pytest.mark.parametrize("h", range(PQ["n_hosts"]))
def test_pointqps_points_agree_with_the_jax_package(pointqps, pq_table, h):
    """Each host's points, plain and under a fused-phase literal, equal
    the JAX package's bit for bit and the written arrays."""
    _ref, _port, (_rc, rex, rs_), (_pc, pex, ps) = pointqps
    ts, vals = pq_table
    for cond, floor in (("", None), (f" AND value > -{h}.0", -float(h)),
                        (" AND value > 45.0", 45.0)):
        sql = f"SELECT time, value FROM pq WHERE host = 'host_{h}'" + cond
        got = pex.execute_one(sql, ps)
        want = rex.execute_one(sql, rs_)
        assert list(got.names) == list(want.names)
        for g, w in zip(got.columns, want.columns):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, sql
            assert g.tobytes() == w.tobytes(), sql
        bst.check_points(got, ts, vals[h], floor)


@pytest.mark.parametrize("floor", [None, 45.0])
def test_points_oracle_rejects_a_changed_answer(pointqps, pq_table, floor):
    _ref, _port, _r, (_pc, pex, ps) = pointqps
    ts, vals = pq_table
    sql = "SELECT time, value FROM pq WHERE host = 'host_3'" + (
        "" if floor is None else f" AND value > {floor}")
    rs = pex.execute_one(sql, ps)
    bst.check_points(rs, ts, vals[3], floor)
    for bad in _changed(rs, "value") + _changed(rs, "time"):
        with pytest.raises(AssertionError):
            bst.check_points(bad, ts, vals[3], floor)


def test_pointqps_raises_without_the_serving_plane(tmp_path):
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, CNOSDB_SERVING="0")
        coord, ex, s = _port_parts(tmp_path)
        try:
            with pytest.raises(RuntimeError, match="serving plane"):
                bst.run_pointqps(ex, coord, _tenant(), "public", s, **PQ)
        finally:
            coord.close()


# ---------------------------------------------------------------- overload
@pytest.fixture(scope="module")
def overload_ref(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        _env(mp)
        r = _ref_parts(tmp_path_factory.mktemp("overload_ref"))
        try:
            return bench_suites.run_overload(r[1], *_parts_args(r))
        finally:
            r[0].close()


@pytest.fixture(scope="module", params=FORCE)
def overload(request, tmp_path_factory):
    """(port output, reference parts, port parts): the port's run, its
    directory then copied and opened by the JAX package."""
    root = tmp_path_factory.mktemp(f"overload_{request.param}")
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, request.param)
        coord, ex, s = _port_parts(root / "port")
        try:
            out = bst.run_overload(ex, coord, _tenant(), "public", s, **OV)
        finally:
            coord.close()
        shutil.copytree(root / "port", root / "ref")
        r, p = _ref_parts(root / "ref"), _port_parts(root / "port")
        try:
            yield out, r, p
        finally:
            r[0].close()
            p[0].close()


@pytest.fixture(scope="module")
def ov_check():
    rng = np.random.default_rng(53)
    names = [f"host_{h:03d}" for h in range(OV["n_hosts"])]
    return bst.storm_oracle(names, bst.host_values(rng, OV["n_hosts"],
                                                   OV["per"]))


def test_overload_output_has_the_reference_keys(overload, overload_ref):
    out, _r, _p = overload
    assert set(overload_ref) <= set(out)
    assert list(out["phases"]) == list(overload_ref["phases"]) \
        == ["0.5x", "1x", "2x"]
    for name, ph in out["phases"].items():
        assert set(overload_ref["phases"][name]) - {"query_errors"} \
            <= set(ph), name
        assert ph["storms_checked"] == ph["query_ok"] > 0, name
    assert out["table_rows"] == OV["n_hosts"] * OV["per"]


def test_overload_spills_at_2x_and_changes_no_answer(overload):
    """The 2x phase spills and unspills; every storm row equals its
    host's row from the governance-off path, cold or warm."""
    out, _r, _p = overload
    assert out["phases"]["2x"]["spills"] >= 1
    assert out["phases"]["2x"]["unspills"] >= 1
    assert out["route_identical"], out["phases"]


@pytest.mark.parametrize("memory", ["on", "off"])
def test_overload_storms_agree_with_the_jax_package(overload, ov_check,
                                                   memory):
    _out, (_rc, rex, rs_), (_pc, pex, ps) = overload
    with pytest.MonkeyPatch.context() as mp:
        if memory == "off":
            mp.setenv("CNOSDB_MEMORY", "0")
        for u in (90_001, 90_002):          # cold, then warm
            sql = bst.storm_sql(u)
            got = pex.execute_one(sql, ps).rows()
            _same_rows(got, rex.execute_one(sql, rs_).rows(), sql)
            ov_check(got)


def test_storm_oracle_rejects_a_changed_answer(overload, ov_check):
    _out, _r, (_pc, pex, ps) = overload
    rows = pex.execute_one(bst.storm_sql(90_003), ps).rows()
    ov_check(rows)
    h, c, s, mn, mx = rows[0]
    for bad in (rows[:-1], rows + rows[:1],
                rows + [("host_999", c, s, mn, mx)],
                [(h, c, s * (1 + 1e-9), mn, mx)] + rows[1:],
                [(h, c + 1, s, mn, mx)] + rows[1:],
                [(h, c, s, mn - 1e-9, mx)] + rows[1:]):
        with pytest.raises(AssertionError):
            ov_check(bad)


def test_overload_raises_with_governance_off(tmp_path):
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, CNOSDB_MEMORY="0")
        coord, ex, s = _port_parts(tmp_path)
        try:
            with pytest.raises(RuntimeError, match="governance"):
                bst.run_overload(ex, coord, _tenant(), "public", s, **OV)
        finally:
            coord.close()


# ------------------------------------------- the spiller against the warm
def _spill_bed(ex):
    """tests/test_memory.py's bed: 400 rows over 7 hosts in 4 shards, a
    1e15 value every 17 rows among N(0.1, 0.05) ones, so any change in
    the order a float sum folds shows in its last bits."""
    from cnosdb_tpu_torch.sql.executor import Session

    ex.execute_one("CREATE DATABASE sp WITH SHARD 4")
    s = Session(database="sp")
    ex.execute_one("CREATE TABLE w (v DOUBLE, TAGS(h))", s)
    rng = np.random.default_rng(7)
    rows = []
    for i in range(400):
        v = 1e15 if i % 17 == 0 else float(rng.normal(0.1, 0.05))
        rows.append(f"({1_700_000_000_000_000_000 + i * 1_000_000}, "
                    f"'h{i % 7}', {v!r})")
    ex.execute_one("INSERT INTO w (time, h, v) VALUES " + ", ".join(rows),
                   s)
    return s


@pytest.mark.parametrize("force", FORCE)
def test_group_spill_equals_the_warm_answer_bit_for_bit(tmp_path, force):
    """The spill half of test_memory.py's test_group_spill_is_bit_identical,
    against the warm in-memory answer: with the group budget at 1 byte
    every epoch spills to disk, and the answer keeps every float's bits
    and the row order. (The first, cold answer may differ in the last
    bits of a sum: the cold scan folds in native/segagg.cpp, the warm one
    on the host-prep path; see ROADMAP Queue C, C14.)"""
    from cnosdb_tpu_torch.server import memory as memgov

    def q(u):
        return (f"SELECT h, count(DISTINCT v), sum(v), min(v), max(v) "
                f"FROM w WHERE h <> 'zz{u}' GROUP BY h")

    def bits(rows):
        return [tuple(repr(x) for x in r) for r in rows]

    with pytest.MonkeyPatch.context() as mp:
        _env(mp, force)
        mp.delenv("CNOSDB_MEMORY", raising=False)
        coord, ex, _s = _port_parts(tmp_path)
        try:
            s = _spill_bed(ex)
            ex.execute_one(q(0), s)                     # cold
            warm = ex.execute_one(q(1), s).rows()
            assert len(warm) == 7
            mp.setattr(memgov, "GROUP_BYTES", 1)
            c0 = memgov.counters_snapshot()
            spilled = ex.execute_one(q(2), s).rows()
            c1 = memgov.counters_snapshot()
        finally:
            coord.close()
    for action in ("spill", "unspill"):
        key = ("query_groups", action)
        assert c1.get(key, 0) - c0.get(key, 0) >= 1, action
    assert bits(spilled) == bits(warm)


# -------------------------------------------------------------------- mesh
MESH_ENV = {"CNOSDB_SERVING": "0", "CNOSDB_MESH": "1",
            "CNOSDB_MESH_MIN_ROWS": "0", "CNOSDB_MESH_MIN_DEVICES": "1"}


@pytest.fixture(scope="module", params=FORCE)
def mesh_runs(request, tmp_path_factory):
    """(reference output, port output, reference parts, port parts): each
    package's run_mesh on a directory of its own (the same seeded data),
    the executors kept open for the comparisons."""
    root = tmp_path_factory.mktemp(f"mesh_{request.param}")
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, request.param, CNOSDB_SERVING="0",
             CNOSDB_BENCH_MESH_ROWS=str(MESH_ROWS),
             CNOSDB_BENCH_MESH_ITERS=str(MESH_ITERS))
        mp.delenv("CNOSDB_MESH_DEVICES", raising=False)
        r, p = _ref_parts(root / "ref"), _port_parts(root / "port")
        try:
            ref = bench_suites.run_mesh(r[1], *_parts_args(r))
            port = bst.run_mesh(p[1], p[0], _tenant(), "public", p[2],
                                rows=MESH_ROWS, iters=MESH_ITERS,
                                devices=[torch.device("cpu")] * 8)
            yield ref, port, r, p
        finally:
            r[0].close()
            p[0].close()


@pytest.fixture(scope="module")
def mesh_check():
    per = max(64, MESH_ROWS // 32)
    return bst.mesh_oracle(*bst.mesh_table(32, per))


def test_mesh_sweep_merges_every_query_through_the_collective(mesh_runs):
    ref, port, _r, _p = mesh_runs
    assert set(ref) - {"speedup_note"} <= set(port)
    assert port["zero_host_merges"] and ref["zero_host_merges"]
    assert port["rows"] == ref["rows"] == MESH_ROWS
    assert port["devices_available"] == 8 and port["cards"] == 1
    assert "logical shards" in port["speedup_8x_of"]
    assert list(port["devices"]) == ["1", "2", "4", "8"]
    for d, r in port["devices"].items():
        assert r["outcomes"]["exec:engaged"] == MESH_ITERS, d
        assert r["outcomes"]["merge:collective"] == MESH_ITERS, d
        assert "merge:host" not in r["outcomes"], d
        assert r["bit_identical"] == ref["devices"][d]["bit_identical"], d
    assert port["bit_identical"] == ref["bit_identical"]


@pytest.mark.parametrize("lane", ["legacy", "1", "8"])
def test_mesh_answers_agree_with_the_jax_package(mesh_runs, mesh_check,
                                                 lane):
    _ref, _port, (_rc, rex, _rs), (_pc, pex, _ps) = mesh_runs
    from cnosdb_tpu.sql.executor import Session as RS
    from cnosdb_tpu_torch.ops import placement
    from cnosdb_tpu_torch.sql.executor import Session as PS

    with pytest.MonkeyPatch.context() as mp:
        for k, v in MESH_ENV.items():
            mp.setenv(k, v)
        if lane == "legacy":
            mp.setenv("CNOSDB_MESH", "0")
        else:
            mp.setenv("CNOSDB_MESH_DEVICES", lane)
        mp.setattr(placement, "mesh_devices",
                   lambda: [torch.device("cpu")] * 8)
        got = pex.execute_one(bst.MESH_SQL, PS(database="meshbench"))
        want = rex.execute_one(_reference_mesh_sql(),
                               RS(database="meshbench"))
    assert list(got.names) == list(want.names)
    _same_rows(_rows(got), _rows(want), lane)
    mesh_check(got)


def _reference_mesh_sql():
    """The query bench_suites.run_mesh assigns to `q`, read from its
    source."""
    import ast
    import inspect

    fn = ast.parse(inspect.getsource(bench_suites.run_mesh))
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and getattr(node.targets[0], "id", None) == "q":
            return ast.literal_eval(node.value)
    raise AssertionError("run_mesh assigns no q")


def test_mesh_query_is_the_reference_text():
    assert bst.MESH_SQL == _reference_mesh_sql()


@pytest.mark.parametrize("col", ["c", "sv", "mn", "mx", "t"])
def test_mesh_oracle_rejects_a_changed_answer(mesh_runs, mesh_check, col):
    _ref, _port, _r, (_pc, pex, _ps) = mesh_runs
    from cnosdb_tpu_torch.sql.executor import Session as PS

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CNOSDB_MESH", "0")
        rs = pex.execute_one(bst.MESH_SQL, PS(database="meshbench"))
    mesh_check(rs)
    for bad in _changed(rs, col):
        with pytest.raises((AssertionError, KeyError)):
            mesh_check(bad)


# --------------------------------------------------------------- straggler
@pytest.fixture(scope="module")
def straggler():
    from cnosdb_tpu_torch.parallel import health

    with pytest.MonkeyPatch.context() as mp:
        _env(mp, CNOSDB_BENCH_STRAGGLER_ITERS=str(STRAGGLER_ITERS),
             CNOSDB_BENCH_STRAGGLER_DELAY_MS=str(STRAGGLER_DELAY_MS))
        mp.delenv("CNOSDB_HEDGE", raising=False)
        ref = bench_suites.run_straggler()
        health.SCORER.reset()
        health.SLOW_START.reset()
        health.reset_counters()
        try:
            port = bst.run_straggler(iters=STRAGGLER_ITERS,
                                     delay_ms=STRAGGLER_DELAY_MS)
            hedge_env = os.environ.get("CNOSDB_HEDGE")
        finally:
            health.SCORER.reset()
            health.SLOW_START.reset()
            health.reset_counters()
    return ref, port, hedge_env


def test_straggler_keeps_parity_and_the_reference_keys(straggler):
    """run_straggler raises unless the hedged and the unhedged scan
    return the healthy scan's batch byte for byte; it ran to its end,
    gave every key of the reference's output and put CNOSDB_HEDGE back."""
    ref, port, hedge_env = straggler
    assert set(ref) <= set(port), set(ref) - set(port)
    assert port["iters"] == ref["iters"] == STRAGGLER_ITERS
    assert port["straggle_delay_ms"] == STRAGGLER_DELAY_MS
    for k in ("healthy_hedges", "adaptation_hedges", "hedged"):
        assert set(port[k]) == set(ref[k]), k
    assert hedge_env is None


def test_straggler_bed_scans_as_the_reference(tmp_path):
    """The port's bed returns the reference bed's rows: same table, same
    NULLs and NaNs, the delta on top of the sealed half."""
    from cnosdb_tpu.chaos.straggler import StragglerBed as RB
    from cnosdb_tpu_torch.chaos.straggler import StragglerBed as PB

    with pytest.MonkeyPatch.context() as mp:
        _env(mp)
        mp.delenv("CNOSDB_HEDGE", raising=False)
        beds = [RB(str(tmp_path / "ref"), rows=400),
                PB(str(tmp_path / "port"), rows=400)]
        try:
            ref, port = [b.scan_once(qid="parity") for b in beds]
        finally:
            for b in beds:
                b.close()
    assert port.n_rows == ref.n_rows == 400
    np.testing.assert_array_equal(np.asarray(port.ts), np.asarray(ref.ts))
    assert sorted(port.fields) == sorted(ref.fields)
    for name in ref.fields:
        assert int(port.fields[name][0]) == int(ref.fields[name][0]), name
        for part in (1, 2):                 # values, valid
            a = np.asarray(ref.fields[name][part])
            b = np.asarray(port.fields[name][part])
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


# ------------------------------------------- a scan overtaken by compaction
def _four_flushes(tmp_path):
    """A port engine without background compaction, four L0 files in each
    vnode of table w: 400 rows over 3 hosts."""
    from cnosdb_tpu_torch.parallel.coordinator import Coordinator
    from cnosdb_tpu_torch.parallel.meta import MetaStore
    from cnosdb_tpu_torch.sql.executor import QueryExecutor, Session
    from cnosdb_tpu_torch.storage.engine import TsKv

    meta = MetaStore(str(tmp_path / "meta.json"))
    engine = TsKv(str(tmp_path / "data"), background_compaction=False)
    coord = Coordinator(meta, engine)
    ex = QueryExecutor(meta, coord)
    s = Session(database="public")
    ex.execute_one("CREATE TABLE w (v DOUBLE, TAGS(h))", s)
    for k in range(4):
        ex.execute_one("INSERT INTO w (time, h, v) VALUES " + ", ".join(
            f"({1_700_000_000_000_000_000 + (k * 100 + i) * 10**9}, "
            f"'h{i % 3}', {float(i)})" for i in range(100)), s)
        engine.flush_all()
    return coord, ex, s


def test_a_scan_overtaken_by_a_compaction_scans_the_new_files(tmp_path):
    """A compaction that lands after a scan took its file set and before
    it opened a delta file's reader unlinks that file: the scan runs
    again over the compacted files (the overload suite's governed
    flushes let the background compactor do this to a storm's scan)."""
    from cnosdb_tpu_torch.storage import summary

    with pytest.MonkeyPatch.context() as mp:
        _env(mp, CNOSDB_SERVING="0")
        coord, ex, s = _four_flushes(tmp_path)
        try:
            vnodes = list(coord.engine.vnodes.values())
            assert all(len(v.summary.version.levels[0]) == 4 for v in vnodes)
            opened = summary.Version.reader
            fired = []

            def reader(self, fm):
                if not fired and fm.level == 0 \
                        and fm.file_id not in self._readers:
                    fired.append(fm.file_id)
                    for v in vnodes:        # lands before this open
                        v.compact_full()
                return opened(self, fm)

            mp.setattr(summary.Version, "reader", reader)
            rows = ex.execute_one("SELECT count(v), sum(v) FROM w", s).rows()
        finally:
            coord.close()
    assert fired, "no delta file was opened"
    assert all(not v.summary.version.levels[0] for v in vnodes)
    assert rows == [(400, 19800.0)]


def test_a_file_missing_from_an_unmoved_file_set_is_raised(tmp_path):
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, CNOSDB_SERVING="0")
        coord, ex, s = _four_flushes(tmp_path)
        try:
            v = next(v for (owner, _id), v in coord.engine.vnodes.items()
                     if owner.endswith(".public"))
            fm = next(iter(v.summary.version.levels[0].values()))
            v.summary.version.drop_reader(fm.file_id)
            os.unlink(v.summary.version.file_path(fm))
            with pytest.raises(FileNotFoundError):
                ex.execute_one("SELECT sum(v) FROM w WHERE v > 1", s)
        finally:
            coord.close()
