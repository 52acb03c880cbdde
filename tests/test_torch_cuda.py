"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device. The
file imports neither jax nor cnosdb_tpu, so it runs where only the port's
dependencies are installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(--noconftest: the suite's conftest imports jax for the JAX package's
tests.)
"""
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from cnosdb_tpu_torch.ops import device_decode as dd
from cnosdb_tpu_torch.ops import pallas_kernels as pk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _layout_case(seed, n, ns_per_series, n_series, dtype, nan, null_frac,
                 scattered=False):
    """Series-contiguous rows with ascending buckets per series (seg =
    group × buckets + bucket). Small cases shuffle the group order, as
    tests/test_pallas_kernels.py does; large ones number groups in series
    order, as the scan's tag grouping does, so tiles that straddle two
    series stay inside the window. `scattered`: one series whose bucket
    is drawn anew for every row (the hits table grouped by a field), so
    every tile covers every segment."""
    rng = np.random.default_rng(seed)
    per = -(-n // n_series)
    groups = (rng.permutation(n_series) if n < 10_000
              else np.arange(n_series))
    if scattered:
        seg = rng.integers(0, ns_per_series, n).astype(np.int32)
    else:
        seg = np.concatenate([
            g * ns_per_series + np.sort(rng.integers(0, ns_per_series, per))
            for g in groups])[:n].astype(np.int32)
    if dtype == "float64":
        vals = rng.normal(size=n)
        if nan:
            vals[rng.random(n) < 0.01] = np.nan
            vals[rng.random(n) < 0.005] = np.inf
    else:
        info = np.iinfo(np.int64)
        vals = rng.integers(-1000, 1000, n)
        vals[::97] = info.max
        vals[5::89] = info.min
    valid = rng.random(n) >= null_frac
    return vals, valid, seg, n_series * ns_per_series


CASES = [
    # (n, buckets per series, series, dtype, NaN/inf, NULL fraction)
    (1, 1, 1, "float64", False, 0.0),
    (300, 24, 6, "float64", False, 0.0),
    (4099, 100, 4, "float64", True, 0.4),
    (5000, 16, 3, "int64", False, 0.2),
    (200_000, 300, 100, "float64", True, 0.1),
    (200_000, 1500, 10, "int64", False, 0.0),
    (20_000, 7000, 20, "int64", False, 0.0),    # tile spans up to 2033
    # segment ids drawn anew for every row: each segment takes a partial
    # from every block run, and the completing block folds them
    (4_500_000, 62, 1, "int64", False, 0.1, True),     # the hits shape
    (4_500_000, 62, 1, "float64", True, 0.2, True),
    (200_000, 2000, 1, "float64", True, 0.1, True),    # runs span ~2000
    (200_000, 2000, 1, "int64", False, 0.0, True),
]


def _case_id(c):
    return f"{c[0]}-{c[3]}" + ("-scattered" if c[6:] else "")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_k1_kernel_matches_plain(dev, case):
    vals, valid, seg, ns = _layout_case(7, *case)
    layout = pk.window_layout(seg, ns)
    assert layout is not None
    args = (torch.from_numpy(vals), torch.from_numpy(valid.astype(np.int8)),
            torch.from_numpy(seg))
    plain = pk.window_partials(*args, layout, ns)
    before = pk.launches
    got = pk.window_partials(*[a.to(dev) for a in args], layout, ns)
    again = pk.window_partials(*[a.to(dev) for a in args], layout, ns)
    torch.cuda.synchronize()
    assert pk.launches == before + 2
    for k in plain:
        assert torch.equal(_bits(got[k]), _bits(again[k])), \
            f"{k} not bit-stable"
        if k == "sum" and vals.dtype == np.float64:
            torch.testing.assert_close(got[k].cpu(), plain[k], rtol=1e-12,
                                       atol=1e-12, equal_nan=True)
        else:
            assert torch.equal(_bits(got[k].cpu()), _bits(plain[k])), k


def test_k1_host_wrapper_on_the_card(dev, monkeypatch):
    monkeypatch.delenv("CNOSDB_TORCH_PLACEMENT", raising=False)
    vals, valid, seg, ns = _layout_case(3, 10_000, 50, 8, "float64", True,
                                        0.3)
    got = pk.segment_partials_pallas(vals, valid, seg, ns,
                                     wants={"want_count": True,
                                            "want_sum": True,
                                            "want_min": True,
                                            "want_max": True})
    layout = pk.window_layout(seg, ns)
    plain = pk.window_partials_plain(
        torch.from_numpy(vals), torch.from_numpy(valid.astype(np.int8)),
        torch.from_numpy(seg), layout, ns)
    np.testing.assert_array_equal(got["count"], plain["count"].numpy())
    np.testing.assert_array_equal(got["min"], plain["min"].numpy())
    np.testing.assert_array_equal(got["max"], plain["max"].numpy())
    np.testing.assert_allclose(got["sum"], plain["sum"].numpy(), rtol=1e-12)


@pytest.mark.parametrize("shape", [(1, 1), (1, 128), (3, 1000), (64, 4096),
                                   (16, 131072), (2, 262144)])
def test_k2_kernel_matches_plain(dev, shape):
    rng = np.random.default_rng(shape[1])
    words = torch.from_numpy(rng.integers(
        np.iinfo(np.int64).min, np.iinfo(np.int64).max, shape,
        dtype=np.int64))
    before = dd.xor_launches
    got = dd.xor_scan(words.to(dev))
    torch.cuda.synchronize()
    assert dd.xor_launches == before + 1
    assert torch.equal(got.cpu(), dd.xor_scan_plain(words))
    want = np.bitwise_xor.accumulate(words.numpy().view(np.uint64), axis=1)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint64), want)


@pytest.mark.parametrize("shape,n", [
    ((1, 128), 128), ((3, 1024), 1000), ((32, 131072), 131072),
    ((2, 262144), 200_000),
    ((2, 1000), 1000),        # a length off the 16-byte grid: byte loads
], ids=str)
def test_k2_gorilla_decode_matches_plain(dev, shape, n):
    """The whole decode (plane assembly + scan, one launch) against its
    plain version and numpy, rows zero past a ragged n; two runs give
    the same bits."""
    b, width = shape
    rng = np.random.default_rng(width + b)
    planes = rng.integers(0, 256, (b, 8, width), dtype=np.uint8)
    planes[:, :, n:] = 0
    before = dd.xor_launches
    got = dd.gorilla_decode(torch.from_numpy(planes).to(dev))
    again = dd.gorilla_decode(torch.from_numpy(planes).to(dev))
    torch.cuda.synchronize()
    assert dd.xor_launches == before + 2
    assert torch.equal(got, again), "not bit-stable"
    assert torch.equal(got.cpu(),
                       dd.gorilla_decode_plain(torch.from_numpy(planes)))
    words = np.zeros((b, width), dtype=np.uint64)
    for k in range(8):
        words |= planes[:, k].astype(np.uint64) << np.uint64(8 * k)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint64),
                                  np.bitwise_xor.accumulate(words, axis=1))


def test_k2_gorilla_decode_unaligned_planes(dev):
    """Planes that start off a 16-byte boundary take the byte loads."""
    b, width = 3, 4096
    rng = np.random.default_rng(5)
    raw = torch.from_numpy(rng.integers(0, 256, b * 8 * width + 1,
                                        dtype=np.uint8)).to(dev)
    planes = raw[1:].view(b, 8, width)
    assert planes.data_ptr() % 16 != 0 and planes.is_contiguous()
    got = dd.gorilla_decode(planes)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), dd.gorilla_decode_plain(planes.cpu()))


def test_k1_host_wrapper_from_eight_threads(dev, monkeypatch):
    """Eight threads call the one-copy wrapper at once on one stream, on
    eight different inputs at the warm path's shape (4,320 rows, 12
    segments), 20 times each: every result matches the plain version and
    repeats bit for bit."""
    monkeypatch.delenv("CNOSDB_TORCH_PLACEMENT", raising=False)
    wants = {"want_count": True, "want_sum": True, "want_min": True,
             "want_max": True}
    cases = [_layout_case(100 + i, 4320, 12, 1,
                          "float64" if i % 2 == 0 else "int64", i % 4 == 0,
                          0.1) for i in range(8)]
    barrier = threading.Barrier(len(cases))

    def work(i):
        vals, valid, seg, ns = cases[i]
        barrier.wait()
        return [pk.segment_partials_pallas(vals, valid, seg, ns,
                                           wants=dict(wants))
                for _ in range(20)]

    before = pk.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)   # switch threads often: races show up
    try:
        with ThreadPoolExecutor(max_workers=len(cases)) as pool:
            results = list(pool.map(work, range(len(cases))))
    finally:
        sys.setswitchinterval(interval)
    assert pk.launches == before + 20 * len(cases)
    for (vals, valid, seg, ns), runs in zip(cases, results):
        plain = pk.window_partials_plain(
            torch.from_numpy(vals), torch.from_numpy(valid.astype(np.int8)),
            torch.from_numpy(seg), pk.window_layout(seg, ns), ns)
        for got in runs:
            for k in plain:
                if k == "sum" and vals.dtype == np.float64:
                    np.testing.assert_allclose(got[k], plain[k].numpy(),
                                               rtol=1e-12)
                else:
                    np.testing.assert_array_equal(
                        got[k].view(np.int64) if got[k].dtype == np.float64
                        else got[k],
                        _bits(plain[k]).numpy(), err_msg=k)
                np.testing.assert_array_equal(
                    got[k].view(np.uint8), runs[0][k].view(np.uint8),
                    err_msg=f"{k} not bit-stable")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_k1_host_layout_matches_window_layout(dev, case):
    """The library's host half (tile bounds and block runs, then the
    packed staging regions: rows, runs, fold places, seg_start, zeroed
    counters) is byte for byte what window_layout and pack give."""
    from cnosdb_tpu_torch.ops import cuda_build

    lib = cuda_build.library("segment_window")
    vals, valid, seg, ns = _layout_case(11, *case)
    vals = vals.astype(np.float64)
    layout = pk.window_layout(seg, ns)
    n = len(seg)
    runs, buf, _at, regions = pk._host_bounds(lib, seg.ctypes.data, n, ns)
    assert runs == layout.n_runs
    host = {}
    for k, count in (("bases", -(-n // pk.R_TILE)), ("run_tile", runs + 1),
                     ("run_base", runs), ("slot_off", runs + 1),
                     ("stats", 2)):
        off, _count, d = regions[k]
        host[k] = buf[off:off + count * d.itemsize].view(d)
    for k in ("bases", "run_tile", "run_base", "slot_off"):
        np.testing.assert_array_equal(host[k], getattr(layout, k), err_msg=k)
    assert list(host["stats"]) == [layout.n_slots, layout.span_max]
    plan = pk.stage_plan(n, layout, ns, vals.dtype, rows=True)
    want = np.zeros(plan.in_bytes, dtype=np.uint8)
    pk.pack(want, plan, layout, (vals, valid, seg))
    got = np.full(plan.in_bytes, 0xAB, dtype=np.uint8)
    lib.segment_window_pack(got.ctypes.data, plan.offsets, vals.ctypes.data,
                            valid.ctypes.data, seg.ctypes.data, n,
                            host["run_tile"].ctypes.data,
                            host["run_base"].ctypes.data,
                            host["slot_off"].ctypes.data, layout.n_runs, ns)
    for k in ("values", "valid", "seg_ids", "run_tile", "run_base",
              "slot_off", "fold_pos", "seg_start", "arrivals"):
        np.testing.assert_array_equal(pk.region(got, plan, k),
                                      pk.region(want, plan, k), err_msg=k)


@pytest.mark.parametrize("dtype", ["float64", "int64"])
def test_mesh_merge_kernel_on_the_card(dev, dtype):
    """The mesh lane's merge program over 4 logical shards on the card
    against the same call over 4 logical shards on the CPU: the gather
    and the cross-shard fold run on CUDA tensors. Counts, integer sums,
    min, max, first and last exact; f64 sums within rtol 1e-12 (X1's
    index_add_ adds f64 with atomics on the card)."""
    from cnosdb_tpu_torch.ops.device_cache import put_sharded
    from cnosdb_tpu_torch.parallel.distributed_agg import mesh_merge_kernel
    from cnosdb_tpu_torch.parallel.mesh import Mesh
    from cnosdb_tpu_torch.parallel.mesh import PartitionSpec as P

    d, slots, ns, rows = 4, 2, 1024, 1 << 16
    rng = np.random.default_rng(5)
    total = d * rows
    if dtype == "float64":
        vals = rng.random(total) * 100
        vals[rng.random(total) < 0.001] = np.nan
    else:
        vals = rng.integers(-(2**50), 2**50, total)
    valid = rng.random(total) > 0.1
    seg = (rng.integers(0, slots, total) * ns
           + rng.integers(0, ns - 24, total)).astype(np.int32)
    rank = rng.permutation(total).astype(np.int32)
    dummy = np.zeros(d, dtype=np.int32)
    wants = ("count", "first", "last", "max", "min", "sum")
    out = {}
    for where in (dev, torch.device("cpu")):
        m = Mesh([where] * d)
        out[where.type] = mesh_merge_kernel(
            *[put_sharded(a, m, P("shard"))
              for a in (vals, valid, seg, rank, dummy, dummy)],
            mesh=m, slots=slots, num_segments=ns, wants=wants)
    torch.cuda.synchronize()
    for k, plain in out["cpu"].items():
        got = out["cuda"][k]
        assert got.device == dev, k
        got = got.cpu()
        if k == "sum" and dtype == "float64":
            torch.testing.assert_close(got, plain, rtol=1e-12, atol=0,
                                       equal_nan=True)
            continue
        if got.dtype == torch.float64:
            nan = torch.isnan(plain)
            assert torch.equal(torch.isnan(got), nan), k
            got, plain = got[~nan], plain[~nan]
        assert torch.equal(_bits(got), _bits(plain)), k


def test_mesh_merge_kernel_across_cards(dev):
    """The same merge over one shard per card (peer copies gather the
    partials onto cuda:0) against the CPU. Skips with fewer than 2 cards."""
    from cnosdb_tpu_torch.ops.device_cache import put_sharded
    from cnosdb_tpu_torch.parallel.distributed_agg import mesh_merge_kernel
    from cnosdb_tpu_torch.parallel.mesh import Mesh, make_mesh
    from cnosdb_tpu_torch.parallel.mesh import PartitionSpec as P

    d = torch.cuda.device_count()
    if d < 2:
        pytest.skip("needs 2 or more CUDA cards")
    slots, ns, rows = 2, 512, 1 << 15
    rng = np.random.default_rng(9)
    total = d * rows
    vals = rng.integers(-(2**50), 2**50, total)
    valid = rng.random(total) > 0.1
    seg = (rng.integers(0, slots, total) * ns
           + rng.integers(0, ns - 9, total)).astype(np.int32)
    rank = rng.permutation(total).astype(np.int32)
    dummy = np.zeros(d, dtype=np.int32)
    wants = ("count", "first", "last", "max", "min", "sum")
    out = {}
    for m in (make_mesh(d), Mesh([torch.device("cpu")] * d)):
        h = [put_sharded(a, m, P("shard"))
             for a in (vals, valid, seg, rank, dummy, dummy)]
        if m.devices[0].type == "cuda":
            assert [s.device for s in h[0].shards] == m.devices
        out[m.devices[0].type] = mesh_merge_kernel(
            *h, mesh=m, slots=slots, num_segments=ns, wants=wants)
    for k, plain in out["cpu"].items():
        got = out["cuda"][k]
        assert got.device == torch.device("cuda", 0), k
        assert torch.equal(got.cpu(), plain), k


@pytest.mark.parametrize("width", ["logical", "cards"])
def test_mesh_lane_sql_on_the_card(dev, width, tmp_path, monkeypatch):
    """A grouped aggregate through QueryExecutor with the lane engaged
    (4 logical shards on cuda:0, or one shard per card) against the
    legacy path (CNOSDB_MESH=0) on the same table: counts, integer sums,
    min, max, first and last exact, f64 sums within rtol 1e-12."""
    from cnosdb_tpu_torch.ops import placement
    from cnosdb_tpu_torch.parallel import mesh
    from cnosdb_tpu_torch.parallel.coordinator import Coordinator
    from cnosdb_tpu_torch.parallel.meta import MetaStore
    from cnosdb_tpu_torch.sql.executor import QueryExecutor, Session
    from cnosdb_tpu_torch.storage.engine import TsKv

    if width == "cards" and torch.cuda.device_count() < 2:
        pytest.skip("needs 2 or more CUDA cards")
    monkeypatch.delenv("CNOSDB_TORCH_PLACEMENT", raising=False)
    for k, v in (("CNOSDB_SERVING", "0"), ("CNOSDB_MESH_MIN_ROWS", "0"),
                 ("CNOSDB_MESH_MIN_DEVICES", "1"),
                 ("CNOSDB_COMPRESSED_DOMAIN", "0")):
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("CNOSDB_MESH_DEVICES", raising=False)
    if width == "logical":
        monkeypatch.setattr(placement, "mesh_devices", lambda: [dev] * 4)
    meta = MetaStore(str(tmp_path / "meta.json"))
    coord = Coordinator(meta, TsKv(str(tmp_path / "data")))
    try:
        ex = QueryExecutor(meta, coord)
        ex.execute_one("CREATE DATABASE m WITH SHARD 4 REPLICA 1")
        s = Session(database="m")
        ex.execute_one("CREATE TABLE t (v DOUBLE, i BIGINT, TAGS(host))", s)
        rng = np.random.default_rng(3)
        rows = ", ".join(
            f"({1_700_000_000_000_000_000 + k * 60_000_000_000}, "
            f"'h{k % 12}', {float(rng.normal(50, 10))!r}, "
            f"{int(rng.integers(-1000, 1000))})" for k in range(3000))
        ex.execute_one(f"INSERT INTO t (time, host, v, i) VALUES {rows}", s)
        sql = ("SELECT host, date_bin(INTERVAL '1 hour', time) AS b, "
               "count(v) c, sum(v) sv, sum(i) si, min(v) mn, max(i) mx, "
               "first(v) f, last(i) l FROM t GROUP BY host, b "
               "ORDER BY host, b")
        monkeypatch.setenv("CNOSDB_MESH", "0")
        legacy = ex.execute_one(sql, s)
        monkeypatch.setenv("CNOSDB_MESH", "1")
        mesh.reset_counters()
        got = ex.execute_one(sql, s)
        snap = mesh.outcomes_snapshot()
        assert snap.get(("exec", "engaged")) == 1, snap
        assert snap.get(("merge", "collective")) == 1, snap
        assert got.names == legacy.names
        for name, a, b in zip(got.names, got.columns, legacy.columns):
            if name == "sv":
                np.testing.assert_allclose(a.astype(float), b.astype(float),
                                           rtol=1e-12, atol=0)
            else:
                assert a.tolist() == b.tolist(), name
    finally:
        coord.close()


# ---------------------------------------------------------------- X4
def _x4_case(n, groups, values, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, groups, n).astype(np.int64),
            rng.integers(0, values, n).astype(np.int64))


@pytest.mark.parametrize("dtype", ["uint64", "int64", "float64"])
def test_x4_topk_threshold_on_the_card(dev, dtype):
    from cnosdb_tpu_torch.ops import kernels

    rng = np.random.default_rng(11)
    n = 1_000_000
    if dtype == "uint64":
        vals = rng.integers(0, 1 << 63, n, dtype=np.uint64) \
            * np.uint64(2) + np.uint64(1)
        vals[:5] = np.iinfo(np.uint64).max
    elif dtype == "int64":
        vals = rng.integers(-(1 << 62), 1 << 62, n)
    else:
        vals = rng.normal(size=n)
    before = kernels.x4_launches.get("topk_threshold", 0)
    for k in (1, 10, n - 1):
        got = kernels.topk_threshold(vals, k)
        assert got.dtype == vals.dtype
        assert got == np.partition(vals, n - k)[n - k], k
    assert kernels.x4_launches["topk_threshold"] == before + 3


@pytest.mark.parametrize("chunk_rows", [1 << 22, 200_000],
                         ids=["one-chunk", "chunked"])
def test_x4_distinct_on_the_card(dev, chunk_rows, monkeypatch):
    from cnosdb_tpu_torch.ops import group_agg, kernels, placement

    monkeypatch.delenv(placement.ENV, raising=False)
    gid, vc = _x4_case(1_000_000, 37, 300_000, 5)
    want = np.bincount(group_agg.distinct_pairs(gid, vc, 300_000)
                       // 300_000, minlength=37)
    op = "segment_distinct_count" if chunk_rows > 1_000_000 \
        else "sorted_pair_codes"
    before = kernels.x4_launches.get(op, 0)
    got = group_agg._device_distinct_count(gid, vc, 37, 300_000,
                                           chunk_rows=chunk_rows)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64
    assert kernels.x4_launches[op] > before


def test_x4_dict_mask_gather_on_device_codes(dev):
    from cnosdb_tpu_torch.ops import kernels, strkernels
    from cnosdb_tpu_torch.models.strcol import DictArray

    rng = np.random.default_rng(3)
    uniq = np.array(sorted(f"http://site{i}.test/{'google' * (i % 5 == 0)}"
                           for i in range(500)), dtype=object)
    codes = rng.integers(0, len(uniq), 1_000_000).astype(np.int32)
    on_card = torch.from_numpy(codes).to(dev)
    mask, _ = strkernels.unique_mask(uniq, "%google%")
    got = strkernels.like_rows(DictArray(on_card, uniq), "%google%")
    assert got.device == dev
    np.testing.assert_array_equal(got.cpu().numpy(), mask[codes])
    # codes past either end clip to it, as the JAX gather's clip mode does
    wild = torch.tensor([-3, 0, 499, 600], dtype=torch.int32, device=dev)
    np.testing.assert_array_equal(
        kernels.dict_mask_gather(mask, wild).cpu().numpy(),
        mask[[0, 0, 499, 499]])


def test_x4_sql_routes_on_the_card(dev, tmp_path, monkeypatch):
    """count(DISTINCT) over a derived table and ORDER BY … DESC LIMIT on
    BIGINT and UNSIGNED columns through QueryExecutor: the default routes
    engage the device ops (counted), and answer as the host routes
    (CNOSDB_TPU_GROUP_AGG=0, CNOSDB_TPU_TOPK=0) do."""
    from cnosdb_tpu_torch.models.points import SeriesRows, WriteBatch
    from cnosdb_tpu_torch.models.schema import ValueType
    from cnosdb_tpu_torch.models.series import SeriesKey
    from cnosdb_tpu_torch.ops import group_agg, kernels, placement
    from cnosdb_tpu_torch.parallel.coordinator import Coordinator
    from cnosdb_tpu_torch.parallel.meta import DEFAULT_TENANT, MetaStore
    from cnosdb_tpu_torch.sql.executor import QueryExecutor, Session
    from cnosdb_tpu_torch.storage.engine import TsKv
    from cnosdb_tpu_torch.utils import stages

    monkeypatch.delenv(placement.ENV, raising=False)
    for k in ("CNOSDB_TPU_GROUP_AGG", "CNOSDB_TPU_TOPK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("CNOSDB_SERVING", "0")
    n = 100_000
    rng = np.random.default_rng(8)
    uid = rng.integers(0, 20_000, n)
    reg = rng.integers(0, 30, n)
    big = rng.integers(0, 1 << 63, n, dtype=np.uint64) * np.uint64(2)
    meta = MetaStore(str(tmp_path / "meta.json"))
    coord = Coordinator(meta, TsKv(str(tmp_path / "data")))
    try:
        ex = QueryExecutor(meta, coord)
        s = Session(database="public")
        wb = WriteBatch()
        wb.add_series("h", SeriesRows(
            SeriesKey("h", {"site": "s0"}),
            1_700_000_000_000_000_000 + np.arange(n, dtype=np.int64) * 1000,
            {"uid": (int(ValueType.INTEGER), uid),
             "reg": (int(ValueType.INTEGER), reg),
             "big": (int(ValueType.UNSIGNED), big)}))
        coord.write_points(DEFAULT_TENANT, "public", wb)
        coord.engine.flush_all()
        queries = [
            "SELECT count(DISTINCT uid) FROM (SELECT uid FROM h) AS t",
            "SELECT reg, count(DISTINCT uid) AS u FROM (SELECT reg, uid "
            "FROM h) AS t GROUP BY reg ORDER BY u DESC LIMIT 10",
            "SELECT uid, count(*) AS c FROM h GROUP BY uid "
            "ORDER BY c DESC LIMIT 10",
            "SELECT big FROM h ORDER BY big DESC LIMIT 7",
        ]
        kernels.reset_x4_counts()
        ga0 = group_agg.counters_snapshot()
        qp = stages.QueryProfile()
        got = []
        with stages.profile_scope(qp):
            for sql in queries:
                got.append(ex.execute_one(sql, s))
        snap = qp.snapshot()
        assert kernels.x4_launches.get("segment_distinct_count") == 2
        assert snap.get("topk.device") == 3, snap
        ga = group_agg.counters_snapshot()
        assert ga["distinct_device"] - ga0.get("distinct_device", 0) == 2
        assert ga.get("distinct_device_error", 0) == \
            ga0.get("distinct_device_error", 0)
        shapes = kernels.x4_launch_shapes["topk_threshold"]
        assert any(sh[2] == "uint64" for sh in shapes), shapes
        monkeypatch.setenv("CNOSDB_TPU_GROUP_AGG", "0")
        monkeypatch.setenv("CNOSDB_TPU_TOPK", "0")
        launched = dict(kernels.x4_launches)
        for sql, rs in zip(queries, got):
            ref = ex.execute_one(sql, s)
            assert rs.names == ref.names, sql
            for a, b in zip(rs.columns, ref.columns):
                assert a.tolist() == b.tolist(), sql
        assert kernels.x4_launches == launched
        assert got[0].columns[0][0] == len(np.unique(uid))
        assert got[3].columns[0].tolist() == np.sort(big)[::-1][:7].tolist()
    finally:
        coord.close()


@pytest.mark.parametrize("n,ns", [(864_000, 100), (4_320, 12),
                                  (1 << 20, 32_768)])
def test_float_segment_sum_is_bit_stable(dev, n, ns):
    """index_add_ adds f64 with atomics on the card, so its bits change
    between runs; kernels.segment_sum must give the same bits every run,
    the bits of index_add_ on the CPU (a fold from 0 in row order)."""
    from cnosdb_tpu_torch.ops import kernels

    rng = np.random.default_rng(n)
    vals = rng.normal(50, 20, n)
    seg = rng.integers(0, ns, n)
    v = torch.from_numpy(vals).to(dev)
    s = torch.from_numpy(seg).to(dev)
    runs = {kernels.segment_sum(v, s, ns).cpu().numpy().tobytes()
            for _ in range(10)}
    assert len(runs) == 1
    cpu = torch.zeros(ns, dtype=torch.float64).index_add_(
        0, torch.from_numpy(seg), torch.from_numpy(vals))
    assert runs.pop() == cpu.numpy().tobytes()
