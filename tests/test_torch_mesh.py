"""The port's mesh execution lane against cnosdb_tpu's, on the CPU.

Three levels, each on the same seeded numpy inputs for both packages:

- the distributed aggregate (`distributed_aggregate_host`, the psum form)
  over an 8-shard mesh: cnosdb_tpu on the 8 virtual XLA host devices the
  conftest forces, the port on `make_mesh(8, device="cpu")` (8 logical
  shards on the CPU);
- the lane's merge program (`mesh_merge_kernel`) called directly, with and
  without staged run partials, with first/last;
- whole SQL queries through both packages' QueryExecutors over one data
  directory written by cnosdb_tpu, with the lane engaged (the port's
  device pool patched to 8 CPU entries), held against each other and
  against the port's own legacy path (CNOSDB_MESH=0), with the lane's
  engaged/collective counters asserted on every query.

Tolerances: merged partials and SQL answers are exact between the
packages (the port folds in the same global batch order, and its CPU
index_add_ accumulates in row order as XLA's CPU scatter does). The psum
form's f64 sums take rtol 1e-12, since its reduction order belongs to the
library on each side. Between the lane and the legacy path two queries
take rtol 1e-12: an f64 sum that drifts by a few ulps between the two
paths in cnosdb_tpu itself (ROADMAP Queue C).
"""
import shutil

import numpy as np
import pytest
import torch

BASE = 1_700_000_000_000_000_000
MINUTE = 60_000_000_000

# tests/test_mesh_parity.py's TAG_QUERIES, over its 2000-row table
TAG_QUERIES = [
    "SELECT host, count(*) AS c, sum(v) AS sv, min(v) AS mn, "
    "max(i) AS mx FROM m GROUP BY host",
    "SELECT host, region, first(v) AS f, last(v) AS l FROM m "
    "GROUP BY host, region",
    "SELECT date_bin(INTERVAL '1 hour', time) AS t, sum(v) AS sv, "
    "count(i) AS c FROM m GROUP BY t",
    "SELECT host, date_bin(INTERVAL '2 hour', time) AS t, sum(v) sv, "
    "first(i) f FROM m GROUP BY host, t",
    "SELECT count(*) AS c, sum(v) AS sv FROM m",
    "SELECT host, sum(v) sv FROM m WHERE v > 0 GROUP BY host",
    "SELECT host, avg(v) a FROM m GROUP BY host",
    "SELECT host, min(i) mn, max(v) mx, last(i) l FROM m "
    "WHERE region = 'r1' GROUP BY host",
    "SELECT host, sum(v) sv, first(v) f FROM m GROUP BY host",
]
# and its NULL/NaN/string-dictionary queries, over its 1200-row table
NULL_QUERIES = [
    "SELECT host, count(v) c, sum(v) sv, min(v) mn, max(v) mx "
    "FROM m GROUP BY host",
    "SELECT host, sum(w) sw, min(w) mn, max(w) mx FROM m "
    "GROUP BY host",
    "SELECT host, first(v) f, last(v) l, sum(i) si FROM m "
    "GROUP BY host",
    "SELECT s, sum(v) sv, count(*) c FROM m GROUP BY s ORDER BY s",
    "SELECT host, s, avg(v) a FROM m GROUP BY host, s "
    "ORDER BY host, s",
    "SELECT host, sum(v) sv FROM m WHERE i > 100 GROUP BY host",
    "SELECT host, sum(v) sv FROM m WHERE host = 'h3' GROUP BY host",
    "SELECT host, count(DISTINCT s) cd FROM m GROUP BY host",
    "SELECT host, sum(v) sv, first(w) fw FROM m "
    "WHERE v IS NOT NULL GROUP BY host",
]
# f64 sums on which cnosdb_tpu's own mesh lane and legacy path differ by
# a few ulps (tests/test_mesh_parity.py, red in the reference)
DRIFT = {("mesh", TAG_QUERIES[4]), ("meshn", NULL_QUERIES[6])}
SQL_CASES = [("mesh", q) for q in TAG_QUERIES] + \
    [("meshn", q) for q in NULL_QUERIES]


# ------------------------------------------------------------ meshes
@pytest.fixture(scope="module")
def meshes():
    import jax

    from cnosdb_tpu.parallel import mesh as jmesh
    from cnosdb_tpu_torch.parallel import mesh as tmesh

    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return {d: (jmesh.make_mesh(d), tmesh.make_mesh(d, device="cpu"))
            for d in (1, 4, 8)}


def _dist_both(meshes, *args, **kw):
    from cnosdb_tpu.parallel.distributed_agg import \
        distributed_aggregate_host as jdist
    from cnosdb_tpu_torch.parallel.distributed_agg import \
        distributed_aggregate_host as tdist

    jm, tm = meshes[8]
    return jdist(*args, jm, **kw), tdist(*args, tm, **kw)


def _assert_partials_equal(ref: dict, got: dict, sum_rtol=None):
    """Bit-equal (so -0.0 is not 0.0), except that a NaN matches any NaN:
    the sign of a propagated NaN is the library's, and no answer shows
    it. Rank keys are compared where the segment has a valid row: an
    empty segment's last_rank is a fill key (the dtype minimum, or
    I32_MIN where a masked row landed, and the port spreads masked rows
    over the segments), which the lane never reads."""
    assert sorted(got) == sorted(ref)
    live = np.asarray(ref["count"]) > 0
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        assert a.dtype == b.dtype, k
        if k.endswith("_rank"):
            a, b = a[live], b[live]
        if sum_rtol is not None and k == "sum" and a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=sum_rtol, err_msg=k)
            continue
        if a.dtype.kind == "f":
            nan = np.isnan(a)
            assert (np.isnan(b) == nan).all(), k
            a, b = a[~nan], b[~nan]
        assert a.tobytes() == b.tobytes(), k


def test_mesh_has_8_devices(meshes):
    from cnosdb_tpu_torch.parallel.mesh import SHARD_AXIS, mesh_size

    tm = meshes[8][1]
    assert mesh_size(tm) == 8
    assert tm.devices == [torch.device("cpu")] * 8
    assert tm.shape == {SHARD_AXIS: 8}


def test_distributed_matches_local(meshes, rng):
    n, nseg = 100_000, 37
    vals = rng.normal(size=n)
    valid = rng.random(n) > 0.1
    segs = rng.integers(0, nseg, n).astype(np.int32)
    rank = np.arange(n, dtype=np.int32)
    rng.shuffle(rank)
    ref, out = _dist_both(meshes, vals, valid, segs, rank, nseg,
                          want_first=True, want_last=True)
    _assert_partials_equal(ref, out, sum_rtol=1e-12)
    for s in range(0, nseg, 5):
        m = valid & (segs == s)
        assert out["count"][s] == m.sum()
        np.testing.assert_allclose(out["sum"][s], vals[m].sum(), rtol=1e-12)
        assert out["min"][s] == vals[m].min()
        assert out["max"][s] == vals[m].max()
        first_idx = np.nonzero(m)[0][np.argmin(rank[m])]
        last_idx = np.nonzero(m)[0][np.argmax(rank[m])]
        assert out["first"][s] == vals[first_idx]
        assert out["last"][s] == vals[last_idx]


def test_distributed_int64_exact(meshes, rng):
    n, nseg = 10_000, 4
    vals = rng.integers(-(2**40), 2**40, n)
    valid = np.ones(n, dtype=bool)
    segs = (np.arange(n) % nseg).astype(np.int32)
    rank = np.arange(n, dtype=np.int32)
    ref, out = _dist_both(meshes, vals, valid, segs, rank, nseg)
    _assert_partials_equal(ref, out)
    for s in range(nseg):
        m = segs == s
        assert out["sum"][s] == vals[m].sum()
        assert out["min"][s] == vals[m].min()


def test_empty_segment_handling(meshes):
    n, nseg = 64, 8
    vals = np.ones(n)
    valid = np.zeros(n, dtype=bool)  # everything filtered out
    segs = np.zeros(n, dtype=np.int32)
    rank = np.arange(n, dtype=np.int32)
    ref, out = _dist_both(meshes, vals, valid, segs, rank, nseg)
    _assert_partials_equal(ref, out)
    assert (out["count"] == 0).all()
    assert (out["sum"] == 0).all()


# ------------------------------------------------------------ merge program
MERGE_CASES = [
    # (shards, slots, dtype, staged runs, wants)
    (8, 2, "float64", False, ("count", "max", "min", "sum")),
    (8, 1, "float64", False, ("count", "first", "last", "sum")),
    (8, 2, "float64", True, ("count", "sum")),
    (4, 2, "float64", True, ("count", "first", "last", "max", "min", "sum")),
    (1, 8, "float64", True, ("count", "sum")),
    (4, 3, "int64", False, ("count", "first", "last", "max", "min", "sum")),
    (1, 8, "int64", False, ("count", "last", "sum")),
]


def _merge_inputs(seed, d, slots, dtype, runs, ns=64, rows=256):
    """Shard-major rows with slot-local segment ids, NaN/NULL values,
    globally unique ranks; with `runs`, staged run partials whose unused
    slots carry the dead segment slots·ns."""
    rng = np.random.default_rng(seed)
    total = d * rows
    if dtype == "float64":
        vals = rng.normal(size=total) * 1e3
        vals[rng.random(total) < 0.01] = np.nan
    else:
        vals = rng.integers(-(2**50), 2**50, total)
    valid = rng.random(total) > 0.15
    slot = rng.integers(0, slots, total)
    seg = (slot * ns + rng.integers(0, ns - 7, total)).astype(np.int32)
    rank = rng.permutation(total).astype(np.int32)
    if runs:
        run_pad = 40
        run_sums = rng.normal(size=d * run_pad) * 1e6
        run_segs = rng.integers(0, slots * ns + 1, d * run_pad) \
            .astype(np.int32)
    else:
        run_pad = 0
        run_sums = run_segs = np.zeros(d, dtype=np.int32)
    return [vals, valid, seg, rank, run_sums, run_segs], run_pad


@pytest.mark.parametrize("case", MERGE_CASES,
                         ids=lambda c: f"d{c[0]}s{c[1]}-{c[2]}-"
                         f"{'runs' if c[3] else 'flat'}-{len(c[4])}")
def test_mesh_merge_kernel_matches_jax(meshes, case):
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    from cnosdb_tpu.parallel.distributed_agg import mesh_merge_kernel as jk
    from cnosdb_tpu_torch.ops.device_cache import put_sharded
    from cnosdb_tpu_torch.parallel.distributed_agg import \
        mesh_merge_kernel as tk
    from cnosdb_tpu_torch.parallel.mesh import PartitionSpec as P

    d, slots, dtype, runs, wants = case
    ns = 64
    arrays, run_pad = _merge_inputs(d * 100 + slots, d, slots, dtype, runs,
                                    ns=ns)
    jm, tm = meshes[d]
    sh = NamedSharding(jm, JP("shard"))
    ref = jk(*[jax.device_put(a, sh) for a in arrays], mesh=jm, slots=slots,
             num_segments=ns, wants=wants, run_pad=run_pad)
    got = tk(*[put_sharded(a, tm, P("shard")) for a in arrays], mesh=tm,
             slots=slots, num_segments=ns, wants=wants, run_pad=run_pad)
    _assert_partials_equal({k: np.asarray(v) for k, v in ref.items()},
                           {k: v.numpy() for k, v in got.items()})


def test_mesh_merge_kernel_folds_in_batch_order(meshes):
    """The f64 fold adds per-(shard, slot) partials in global batch order,
    a left fold a library sum need not reproduce."""
    from cnosdb_tpu_torch.ops.device_cache import put_sharded
    from cnosdb_tpu_torch.parallel.distributed_agg import mesh_merge_kernel
    from cnosdb_tpu_torch.parallel.mesh import PartitionSpec as P

    d, slots, ns, rows = 4, 2, 64, 8
    tm = meshes[d][1]
    # one row per (shard, slot) in segment 0, magnitudes that make the
    # association visible
    vals = np.zeros(d * rows)
    seg = np.zeros(d * rows, dtype=np.int32)
    valid = np.zeros(d * rows, dtype=bool)
    batch_vals = [1e16, 1.0, -1e16, 1.0, 3.0, 1e-3, 7.0, -2.5]
    for b, v in enumerate(batch_vals):
        sh, slot = divmod(b, slots)
        vals[sh * rows + slot] = v
        seg[sh * rows + slot] = slot * ns
        valid[sh * rows + slot] = True
    rank = np.arange(d * rows, dtype=np.int32)
    dummy = np.zeros(d, dtype=np.int32)
    out = mesh_merge_kernel(
        *[put_sharded(a, tm, P("shard"))
          for a in (vals, valid, seg, rank, dummy, dummy)],
        mesh=tm, slots=slots, num_segments=ns, wants=("count", "sum"))
    acc = 0.0
    for v in batch_vals:
        acc = acc + v
    assert out["sum"][0].item() == acc
    assert out["count"][0].item() == len(batch_vals)
    assert out["count"].dtype == torch.int64


# ------------------------------------------------------------ mesh API
def test_make_mesh_never_widens_onto_the_cpu(monkeypatch):
    from cnosdb_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="CUDA devices"):
        make_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh().devices == [torch.device("cuda", 0),
                                   torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="requested 4 CUDA devices"):
        make_mesh(4)


def test_get_mesh_caps_and_caches(monkeypatch):
    from cnosdb_tpu_torch.ops import placement
    from cnosdb_tpu_torch.parallel import mesh

    pool = [torch.device("cpu")] * 8
    monkeypatch.setattr(placement, "mesh_devices", lambda: pool)
    monkeypatch.delenv("CNOSDB_MESH_DEVICES", raising=False)
    m8 = mesh.get_mesh()
    assert mesh.mesh_size(m8) == 8 and mesh.get_mesh() is m8
    monkeypatch.setenv("CNOSDB_MESH_DEVICES", "2")
    assert mesh.mesh_size(mesh.get_mesh()) == 2
    monkeypatch.setattr(placement, "mesh_devices", lambda: [])
    assert mesh.get_mesh() is None


def test_put_sharded_splits_rows_and_books_bytes():
    from cnosdb_tpu_torch.ops.device_cache import put_sharded
    from cnosdb_tpu_torch.parallel.mesh import PartitionSpec as P
    from cnosdb_tpu_torch.parallel.mesh import make_mesh
    from cnosdb_tpu_torch.utils import stages

    m = make_mesh(4, device="cpu")
    a = np.arange(16, dtype=np.int64)
    qp = stages.QueryProfile()
    with stages.profile_scope(qp):
        h = put_sharded(a, m, P("shard"))
    assert qp.snapshot().get("upload_bytes") == a.nbytes
    assert [s.tolist() for s in h.shards] == \
        [list(range(i, i + 4)) for i in range(0, 16, 4)]
    with pytest.raises(ValueError):
        put_sharded(a, m, P())
    with pytest.raises(ValueError):
        put_sharded(a[:15], m, P("shard"))


# ------------------------------------------------------------ SQL level
def _write_source(d):
    """tests/test_mesh_parity.py's two tables, written by cnosdb_tpu into
    4-shard databases (`mesh` and `meshn`)."""
    from cnosdb_tpu.parallel.coordinator import Coordinator
    from cnosdb_tpu.parallel.meta import MetaStore
    from cnosdb_tpu.sql.executor import QueryExecutor, Session
    from cnosdb_tpu.storage.engine import TsKv

    meta = MetaStore(str(d / "meta.json"))
    engine = TsKv(str(d / "data"))
    coord = Coordinator(meta, engine)
    try:
        ex = QueryExecutor(meta, coord)
        ex.execute_one("CREATE DATABASE mesh WITH SHARD 4 REPLICA 1")
        s = Session(database="mesh")
        ex.execute_one("CREATE TABLE m (v DOUBLE, i BIGINT, "
                       "TAGS(host, region))", s)
        rng = np.random.default_rng(7)
        rows = []
        for i in range(2000):
            rows.append((BASE + i * MINUTE, f"h{i % 16}", f"r{i % 3}",
                         float(rng.standard_normal()),
                         int(rng.integers(0, 100))))
        ex.execute_one("INSERT INTO m (time, host, region, v, i) VALUES "
                       + ", ".join(f"({t}, '{h}', '{r}', {v!r}, {iv})"
                                   for t, h, r, v, iv in rows), s)
        ex.execute_one("CREATE DATABASE meshn WITH SHARD 4 REPLICA 1")
        s = Session(database="meshn")
        ex.execute_one("CREATE TABLE m (v DOUBLE, i BIGINT, w DOUBLE, "
                       "s STRING, TAGS(host))", s)
        rng = np.random.default_rng(11)
        parts = []
        for i in range(1200):
            t = BASE + i * MINUTE
            v = "NULL" if i % 5 == 0 else repr(float(rng.standard_normal()))
            w = "(0.0/0.0)" if i % 7 == 0 else \
                repr(float(rng.standard_normal()))
            iv = "NULL" if i % 11 == 0 else str(int(rng.integers(-5, 5)))
            sv = "NULL" if i % 13 == 0 else f"'s{i % 3}'"
            parts.append(f"({t}, 'h{i % 8}', {v}, {iv}, {w}, {sv})")
        ex.execute_one("INSERT INTO m (time, host, v, i, w, s) VALUES "
                       + ", ".join(parts), s)
    finally:
        coord.close()
    return rows


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(reference executor, port executor), each over its own copy of the
    one data directory, with the lane engaged on both: thresholds opened,
    the serving cache off, and the port's device pool 8 CPU entries (the
    counterpart of the 8 virtual XLA devices). The compressed-domain lane
    is off: it would answer first/last from the flushed pages' metadata
    before the aggregate runs (test_mesh_parity's rows stay unflushed)."""
    root = tmp_path_factory.mktemp("mesh")
    rows = _write_source(root / "src")
    shutil.copytree(root / "src", root / "ref")
    shutil.copytree(root / "src", root / "port")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in (("CNOSDB_SERVING", "0"),
                     ("CNOSDB_MESH", "1"),
                     ("CNOSDB_MESH_MIN_ROWS", "0"),
                     ("CNOSDB_MESH_MIN_DEVICES", "2"),
                     ("CNOSDB_MESH_FIELDS", "1"),
                     ("CNOSDB_COMPRESSED_DOMAIN", "0"),
                     ("CNOSDB_TORCH_PLACEMENT", "cpu")):
            mp.setenv(k, v)
        mp.delenv("CNOSDB_MESH_DEVICES", raising=False)
        from cnosdb_tpu_torch.ops import placement

        mp.setattr(placement, "mesh_devices",
                   lambda: [torch.device("cpu")] * 8)
        from cnosdb_tpu.parallel.coordinator import Coordinator as RC
        from cnosdb_tpu.parallel.meta import MetaStore as RM
        from cnosdb_tpu.sql.executor import QueryExecutor as RQ
        from cnosdb_tpu.storage.engine import TsKv as RT
        from cnosdb_tpu_torch.parallel.coordinator import Coordinator as PC
        from cnosdb_tpu_torch.parallel.meta import MetaStore as PM
        from cnosdb_tpu_torch.sql.executor import QueryExecutor as PQ
        from cnosdb_tpu_torch.storage.engine import TsKv as PT

        rm = RM(str(root / "ref" / "meta.json"))
        rc = RC(rm, RT(str(root / "ref" / "data")))
        pm = PM(str(root / "port" / "meta.json"))
        pc = PC(pm, PT(str(root / "port" / "data")))
        try:
            yield RQ(rm, rc), PQ(pm, pc), rows
        finally:
            rc.close()
            pc.close()


def _run(ex, db, sql, port: bool):
    """Run `sql`, returning its answer and the lane's counters for it."""
    if port:
        from cnosdb_tpu_torch.parallel import mesh
        from cnosdb_tpu_torch.sql.executor import Session
    else:
        from cnosdb_tpu.parallel import mesh
        from cnosdb_tpu.sql.executor import Session
    mesh.reset_counters()
    rs = ex.execute_one(sql, Session(database=db))
    return (rs.names, [c.tolist() for c in rs.columns],
            [str(c.dtype) for c in rs.columns]), mesh.outcomes_snapshot()


def _same(a, b, rtol=None) -> bool:
    """Answers equal in names, dtypes and values (repr: NaN, -0.0 and
    ints vs floats all count); with `rtol`, floats within it."""
    if rtol is None or a[0] != b[0] or a[2] != b[2]:
        return repr(a) == repr(b)
    for ca, cb in zip(a[1], b[1]):
        if len(ca) != len(cb):
            return False
        for x, y in zip(ca, cb):
            if isinstance(x, float) and isinstance(y, float):
                if not (x == pytest.approx(y, rel=rtol, nan_ok=True)):
                    return False
            elif repr(x) != repr(y):
                return False
    return True


def _assert_lane_counters(snap, ref_snap, sql):
    engaged = snap.get(("exec", "engaged"), 0)
    assert engaged == ref_snap.get(("exec", "engaged"), 0), (sql, snap)
    assert snap.get(("merge", "collective"), 0) == engaged, (sql, snap)
    for bad in ("plan_error", "device_loss", "few_devices", "no_devices"):
        assert snap.get(("exec", bad), 0) == 0, (sql, snap)


@pytest.mark.parametrize("db,sql", SQL_CASES,
                         ids=[f"{db}-{i}" for i, (db, _q) in
                              enumerate(SQL_CASES)])
def test_sql_lane_matches_jax_and_legacy(pair, db, sql, monkeypatch):
    from cnosdb_tpu_torch.utils import stages

    ref_ex, port_ex, _rows = pair
    errors = stages.errors_snapshot()
    want, ref_snap = _run(ref_ex, db, sql, port=False)
    got, snap = _run(port_ex, db, sql, port=True)
    _assert_lane_counters(snap, ref_snap, sql)
    if db == "mesh":   # every tag shape engages (the JAX suite's count)
        assert snap.get(("exec", "engaged"), 0) == 1, snap
    assert {k: v for k, v in stages.errors_snapshot().items()
            if k.startswith("mesh.")} == \
        {k: v for k, v in errors.items() if k.startswith("mesh.")}
    assert _same(got, want), (sql, got, want)
    monkeypatch.setenv("CNOSDB_MESH", "0")
    legacy, off = _run(port_ex, db, sql, port=True)
    assert off.get(("exec", "engaged"), 0) == 0
    rtol = 1e-12 if (db, sql) in DRIFT else None
    assert _same(got, legacy, rtol=rtol), (sql, got, legacy)


def test_sql_lane_matches_numpy_oracle(pair):
    """count / integer sum / min / max / first / last per host against a
    plain-python oracle over the inserted rows: association-free, so
    exact."""
    _ref, port_ex, rows = pair
    (names, cols, _dt), snap = _run(
        port_ex, "mesh",
        "SELECT host, count(*) c, sum(i) si, min(v) mn, max(v) mx, "
        "first(v) f, last(v) l FROM m GROUP BY host ORDER BY host",
        port=True)
    assert snap.get(("exec", "engaged")) == 1, snap
    by_host: dict = {}
    for t, h, _r, v, iv in rows:
        by_host.setdefault(h, []).append((t, v, iv))
    got = list(zip(*cols))
    assert [g[0] for g in got] == sorted(by_host)
    for h, c, si, mn, mx, f, last in got:
        ent = by_host[h]
        assert c == len(ent)
        assert si == sum(iv for _t, _v, iv in ent)
        assert mn == min(v for _t, v, _iv in ent)
        assert mx == max(v for _t, v, _iv in ent)
        assert f == min(ent)[1]
        assert last == max(ent)[1]


def test_sql_lane_width_one_holds_every_batch(pair, monkeypatch):
    """CNOSDB_MESH_DEVICES=1 with CNOSDB_MESH_MIN_DEVICES=1 (the bench
    sweep's setting): one shard holds every batch as a slot, and the
    answer is the 8-shard lane's."""
    _ref, port_ex, _rows = pair
    sql = TAG_QUERIES[2]
    wide, _snap = _run(port_ex, "mesh", sql, port=True)
    monkeypatch.setenv("CNOSDB_MESH_DEVICES", "1")
    monkeypatch.setenv("CNOSDB_MESH_MIN_DEVICES", "1")
    narrow, snap = _run(port_ex, "mesh", sql, port=True)
    assert snap.get(("exec", "engaged")) == 1, snap
    assert _same(narrow, wide), (narrow, wide)


def test_device_loss_falls_back_to_legacy(pair):
    """The nemesis `device_loss` injection (mesh.collective:fail): the
    lane books device_loss and answers through the legacy host merge."""
    from cnosdb_tpu_torch import faults

    _ref, port_ex, _rows = pair
    q = TAG_QUERIES[0]
    base, snap = _run(port_ex, "mesh", q, port=True)
    assert snap.get(("exec", "engaged")) == 1, snap
    faults.configure("seed=1;mesh.collective:fail")
    try:
        faulted, snap = _run(port_ex, "mesh", q, port=True)
    finally:
        faults.configure("seed=1")
    assert snap.get(("exec", "device_loss")) == 1, snap
    assert snap.get(("exec", "engaged"), 0) == 0, snap
    assert _same(faulted, base)


def test_lane_reengages_after_heal(pair):
    from cnosdb_tpu_torch import faults

    _ref, port_ex, _rows = pair
    q = TAG_QUERIES[1]
    faults.configure("seed=3;mesh.collective:fail")
    try:
        faulted, snap = _run(port_ex, "mesh", q, port=True)
        assert snap.get(("exec", "device_loss")) == 1, snap
    finally:
        faults.configure("seed=3")
    healed, snap = _run(port_ex, "mesh", q, port=True)
    assert snap.get(("exec", "engaged")) == 1, snap
    assert snap.get(("merge", "collective")) == 1, snap
    assert _same(healed, faulted)
