"""The port's segment kernels against the JAX package on the same inputs.

K1 (cnosdb_tpu_torch.ops.pallas_kernels, the windowed segment aggregate)
runs its plain PyTorch version here on the CPU and is held against
cnosdb_tpu's Pallas kernel in interpret mode (segment_partials_pallas
(interpret=True)) and its XLA segment_aggregate, over the
test_pallas_kernels.py cases. X1 (kernels.local_segment_partials) and the
X4 helpers are held against their JAX counterparts. Counts, min, max,
first/last and integers must match exactly; float sums within
rtol=1e-12 (the two sides add in different orders).

The CUDA kernel itself is compared with the plain version on the card by
tests/test_torch_cuda.py and by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

from cnosdb_tpu.ops import kernels as jk
from cnosdb_tpu.ops import pallas_kernels as jpk
from cnosdb_tpu_torch.ops import kernels as tk
from cnosdb_tpu_torch.ops import pallas_kernels as tpk

ALL4 = {"want_count": True, "want_sum": True,
        "want_min": True, "want_max": True}
ALL6 = {**ALL4, "want_first": True, "want_last": True}


@pytest.fixture(autouse=True)
def _cpu_placement(monkeypatch):
    monkeypatch.setenv("CNOSDB_TORCH_PLACEMENT", "cpu")


def _series_layout(rng, n_series, rows_per_series, n_buckets,
                   dtype=np.float64, null_frac=0.0):
    """Storage-shaped batch: series-contiguous rows, time-ordered buckets
    per series, seg = group(series) × n_buckets + bucket."""
    groups = rng.permutation(n_series).astype(np.int64)
    segs, vals, valid = [], [], []
    for s in range(n_series):
        m = rows_per_series
        buckets = np.sort(rng.integers(0, n_buckets, m))
        segs.append(groups[s] * n_buckets + buckets)
        if np.issubdtype(dtype, np.floating):
            vals.append(rng.normal(size=m).astype(dtype))
        else:
            vals.append(rng.integers(-1000, 1000, m).astype(dtype))
        valid.append(rng.random(m) >= null_frac)
    seg_ids = np.concatenate(segs).astype(np.int32)
    return (np.concatenate(vals), np.concatenate(valid), seg_ids,
            n_series * n_buckets)


def _int64_extremes(rng, n):
    info = np.iinfo(np.int64)
    v = rng.integers(-1000, 1000, n).astype(np.int64)
    v[::7] = info.max
    v[3::11] = info.min
    v[5::13] = info.max - 1
    return v


def _special_floats(rng, n):
    v = rng.normal(size=n)
    v[::17] = np.nan
    v[4::19] = np.inf
    v[9::23] = -np.inf
    return v


def _assert_same(got, want, ns):
    """got/want: dicts of [ns] numpy arrays, compared over every segment
    (empty ones carry the same sentinels on both sides). Float sums within
    rtol=1e-12 (NaN/inf sums must match as such); all else exactly."""
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape == (ns,), k
        if k == "sum" and g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=k)
        elif g.dtype.kind == "f":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64), err_msg=k)


CASES = {
    "float": dict(n_series=6, rows=700, buckets=24),
    "nulls_empty_segments": dict(n_series=4, rows=300, buckets=100,
                                 null_frac=0.4),
    "int64": dict(n_series=3, rows=400, buckets=16, dtype=np.int64,
                  null_frac=0.2),
    # the hits shape: a group key drawn anew for every row, so every tile
    # covers every segment and each segment takes several block runs
    "scattered_f64": dict(scattered=True, rows=40_000, buckets=62,
                          null_frac=0.2),
    "scattered_int64": dict(scattered=True, rows=40_000, buckets=62,
                            dtype=np.int64, null_frac=0.1),
    # ~128 segments a tile: the run's union span reaches W_WIN after
    # about 16 tiles, well before TILES_PER_RUN
    "span_breaks_run": dict(n_series=1, rows=40_000, buckets=20_000,
                            null_frac=0.1),
}


def _scattered(rng, n, ns, dtype, null_frac):
    """Segment ids drawn anew for every row; NaN and inf (floats) or the
    int64 extremes, and NULLs."""
    seg_ids = rng.integers(0, ns, n).astype(np.int32)
    if np.issubdtype(dtype, np.floating):
        values = _special_floats(rng, n)
    else:
        values = _int64_extremes(rng, n)
    return values, rng.random(n) >= null_frac, seg_ids, ns


def _case(name):
    c = dict(CASES[name])
    rng = np.random.default_rng(sorted(CASES).index(name))
    if c.get("scattered"):
        return _scattered(rng, c["rows"], c["buckets"],
                          c.get("dtype", np.float64), c["null_frac"])
    return _series_layout(rng, c["n_series"], c["rows"], c["buckets"],
                          dtype=c.get("dtype", np.float64),
                          null_frac=c.get("null_frac", 0.0))


def _jax_k1(values, valid, seg_ids, ns, wants=ALL4):
    return jpk.segment_partials_pallas(values, valid, seg_ids, ns,
                                       wants=dict(wants), interpret=True)


@pytest.mark.parametrize("name", sorted(CASES))
def test_k1_plain_matches_pallas_interpret(name):
    values, valid, seg_ids, ns = _case(name)
    got = tpk.segment_partials_pallas(values, valid, seg_ids, ns,
                                      wants=dict(ALL4))
    want = _jax_k1(values, valid, seg_ids, ns)
    _assert_same(got, want, ns)


@pytest.mark.parametrize("name", sorted(CASES))
def test_k1_staging_round_trips_and_counts_arrivals(name):
    """The Python half of K1's one-copy wrapper: every input packs into
    its own aligned region of one staging buffer and reads back exactly;
    the tiles form greedy block runs (at most TILES_PER_RUN tiles, a
    union span within W_WIN, broken only where the next tile would
    overflow it); each segment's arrival target is the number of runs
    whose window (the lowest of its tiles' `applicable` bases up to their
    top segment) covers it; and the staged call agrees with the Pallas
    kernel."""
    values, valid, seg_ids, ns = _case(name)
    layout = tpk.window_layout(seg_ids, ns)
    plan = tpk.stage_plan(len(values), layout, ns, values.dtype, rows=True)
    spans = sorted((off, off + count * d.itemsize)
                   for off, count, d in plan.regions.values())
    assert all(lo % 16 == 0 for lo, _ in spans)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert plan.regions["arrivals"][0] < plan.in_bytes \
        <= plan.regions["p_cnt"][0] < plan.out_lo \
        == plan.regions["count"][0] < plan.out_hi == plan.total
    buf = np.full(plan.total, 0xAB, dtype=np.uint8)
    tpk.pack(buf, plan, layout, (values, valid, seg_ids))
    np.testing.assert_array_equal(
        tpk.region(buf, plan, "values").view(np.uint64),
        values.view(np.uint64))
    np.testing.assert_array_equal(tpk.region(buf, plan, "valid"),
                                  valid.astype(np.int8))
    np.testing.assert_array_equal(tpk.region(buf, plan, "seg_ids"), seg_ids)
    staged = tpk.staged_layout(buf, plan)
    for k in ("run_tile", "run_base", "slot_off", "fold_pos", "seg_start"):
        np.testing.assert_array_equal(getattr(staged, k),
                                      getattr(layout, k), err_msg=k)
    assert not tpk.region(buf, plan, "arrivals").any()
    bases = jpk.applicable(seg_ids)
    tiles = len(bases)
    tops = np.array([int(seg_ids[t * tpk.R_TILE:(t + 1) * tpk.R_TILE].max())
                     for t in range(tiles)])
    run_tile = layout.run_tile
    assert run_tile[0] == 0 and run_tile[-1] == tiles
    want = np.zeros(ns, dtype=np.int64)
    for r in range(layout.n_runs):
        a, b = int(run_tile[r]), int(run_tile[r + 1])
        lo, hi = int(bases[a:b].min()), int(tops[a:b].max())
        assert 0 < b - a <= tpk.TILES_PER_RUN and hi - lo < tpk.W_WIN
        if b < tiles and b - a < tpk.TILES_PER_RUN:
            assert max(hi, tops[b]) - min(lo, bases[b]) >= tpk.W_WIN
        assert layout.run_base[r] == lo
        assert layout.slot_off[r + 1] - layout.slot_off[r] == hi - lo + 1
        want[lo:hi + 1] += 1
    # the kernel folds a segment when its arrivals reach this target:
    # one arrival per (block run, covered segment), not per tile
    np.testing.assert_array_equal(np.diff(layout.seg_start), want)
    assert layout.n_runs == -(-tiles // tpk.TILES_PER_RUN) \
        or name == "span_breaks_run"
    got = tpk.segment_partials_pallas(values, valid, seg_ids, ns,
                                      wants=dict(ALL4))
    _assert_same(got, _jax_k1(values, valid, seg_ids, ns), ns)


@pytest.mark.parametrize("kind", ["int64_extremes", "nan_inf"])
def test_k1_plain_special_values(kind):
    rng = np.random.default_rng(5)
    values, valid, seg_ids, ns = _series_layout(rng, 5, 300, 12,
                                                null_frac=0.1)
    values = (_int64_extremes(rng, len(values)) if kind == "int64_extremes"
              else _special_floats(rng, len(values)))
    got = tpk.segment_partials_pallas(values, valid, seg_ids, ns,
                                      wants=dict(ALL4))
    want = _jax_k1(values, valid, seg_ids, ns)
    _assert_same(got, want, ns)


def test_k1_window_boundary_series():
    """Series boundaries inside a tile: the window absorbs the group jump
    as long as the span stays under W_WIN."""
    n_buckets = tpk.W_WIN // 2
    a = np.arange(n_buckets, dtype=np.int32)
    b = n_buckets + np.arange(n_buckets, dtype=np.int32)
    seg_ids = np.concatenate([a, b])
    values = np.linspace(-1, 1, len(seg_ids))
    valid = np.ones(len(seg_ids), dtype=bool)
    ns = 2 * n_buckets
    got = tpk.segment_partials_pallas(values, valid, seg_ids, ns,
                                      wants=dict(ALL4))
    _assert_same(got, _jax_k1(values, valid, seg_ids, ns), ns)


def test_k1_all_rows_invalid():
    n = 512
    got = tpk.segment_partials_pallas(
        np.ones(n), np.zeros(n, dtype=bool), np.zeros(n, dtype=np.int32), 8,
        wants=dict(ALL4))
    want = _jax_k1(np.ones(n), np.zeros(n, dtype=bool),
                   np.zeros(n, dtype=np.int32), 8)
    _assert_same(got, want, 8)


def test_k1_declines_wide_span_and_first_last():
    seg_ids = np.array([0, tpk.W_WIN + 7] * (tpk.R_TILE // 2), dtype=np.int32)
    assert tpk.window_layout(seg_ids, tpk.W_WIN + 8) is None
    assert jpk.applicable(seg_ids) is None
    before = tpk.declines()
    got = tpk.segment_partials_pallas(
        np.ones(len(seg_ids)), np.ones(len(seg_ids), bool), seg_ids,
        tpk.W_WIN + 8, wants=dict(ALL4))
    assert got is None
    got = tpk.segment_partials_pallas(
        np.ones(16), np.ones(16, bool), np.zeros(16, np.int32), 1,
        wants={**ALL4, "want_first": True})
    assert got is None
    after = tpk.declines()
    assert after.get("wide_span", 0) == before.get("wide_span", 0) + 1
    assert after.get("first_last", 0) == before.get("first_last", 0) + 1


def test_k1_block_runs_break_on_union_span():
    """~128 segments a tile: every block run stops where the next tile
    would widen its union span past W_WIN, short of TILES_PER_RUN tiles,
    and the result still matches the Pallas kernel."""
    values, valid, seg_ids, ns = _case("span_breaks_run")
    layout = tpk.window_layout(seg_ids, ns)
    lengths = np.diff(layout.run_tile)
    assert len(lengths) > 1 and (lengths[:-1] < tpk.TILES_PER_RUN).all()
    assert layout.span_max <= tpk.W_WIN
    got = tpk.segment_partials_pallas(values, valid, seg_ids, ns,
                                      wants=dict(ALL4))
    _assert_same(got, _jax_k1(values, valid, seg_ids, ns), ns)


def test_k1_layout_bases_match_jax_applicable():
    values, valid, seg_ids, ns = _case("float")
    np.testing.assert_array_equal(tpk.window_layout(seg_ids, ns).bases,
                                  jpk.applicable(seg_ids))


def test_k1_wants_subsetting():
    rng = np.random.default_rng(3)
    values, valid, seg_ids, ns = _series_layout(rng, 2, 300, 8)
    got = tpk.segment_partials_pallas(
        values, valid, seg_ids, ns,
        wants={"want_count": True, "want_sum": False,
               "want_min": False, "want_max": True})
    assert set(got) == {"count", "max"}


def test_k1_rejects_out_of_range_segments():
    with pytest.raises(ValueError):
        tpk.window_layout(np.array([0, 5], dtype=np.int32), 5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_aggregate_column_host_routes_k1(name, monkeypatch):
    """CNOSDB_TPU_PALLAS=1 routes aggregate_column_host through K1 (its
    plain version on the CPU), =0 through X1; both agree with the JAX
    package's aggregate_column_host on the same inputs."""
    values, valid, seg_ids, ns = _case(name)
    rank = np.arange(len(values), dtype=np.int32)
    wants = {**ALL4, "want_first": False, "want_last": False}
    monkeypatch.setenv("CNOSDB_TPU_PALLAS", "0")
    want = jk.aggregate_column_host(values, valid, seg_ids, rank, ns, wants)
    x1 = tk.aggregate_column_host(values, valid, seg_ids, rank, ns, wants)
    monkeypatch.setenv("CNOSDB_TPU_PALLAS", "1")
    before = tpk.engagements()
    k1 = tk.aggregate_column_host(values, valid, seg_ids, rank, ns, wants)
    assert tpk.engagements() == before + 1, "K1 route did not engage"
    for got in (x1, k1):
        assert got["count"].dtype == np.int64
        _assert_same(got, want, ns)


def test_aggregate_column_host_first_last_stays_on_x1(monkeypatch):
    monkeypatch.setenv("CNOSDB_TPU_PALLAS", "1")
    n = 300
    values = np.arange(n, dtype=np.float64)
    valid = np.ones(n, dtype=bool)
    seg_ids = (np.arange(n, dtype=np.int32) // 100)
    rank = np.arange(n, dtype=np.int32)
    before = tpk.engagements()
    wants = {"want_count": True, "want_sum": False, "want_min": False,
             "want_max": False, "want_first": True, "want_last": True}
    out = tk.aggregate_column_host(values, valid, seg_ids, rank, 3, wants)
    assert tpk.engagements() == before
    want = jk.aggregate_column_host(values, valid, seg_ids, rank, 3, wants)
    _assert_same(out, want, 3)
    np.testing.assert_array_equal(out["first"], [0.0, 100.0, 200.0])
    np.testing.assert_array_equal(out["last"], [99.0, 199.0, 299.0])


@pytest.mark.parametrize("dtype", ["float", "int64", "nan_inf"])
def test_x1_matches_jax_segment_aggregate(dtype):
    """X1 with first/last, random (not series-contiguous) segments, NULLs
    and empty segments, against the jitted JAX body."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    n, ns = 900, 64
    seg = rng.integers(0, ns - 8, n).astype(np.int32)   # top 8 stay empty
    valid = rng.random(n) > 0.25
    if dtype == "int64":
        values = _int64_extremes(rng, n)
    elif dtype == "nan_inf":
        values = _special_floats(rng, n)
    else:
        values = rng.normal(size=n)
    rank = rng.permutation(n).astype(np.int32)
    want = jk.segment_aggregate(
        jnp.asarray(values), jnp.asarray(valid), jnp.asarray(seg),
        jnp.asarray(rank), num_segments=ns, **ALL6)
    got = tk.local_segment_partials(
        torch.from_numpy(values), torch.from_numpy(valid),
        torch.from_numpy(seg), torch.from_numpy(rank), num_segments=ns,
        **ALL6)
    _assert_same({k: v.numpy() for k, v in got.items()},
                 {k: np.asarray(v) for k, v in want.items()}, ns)


def test_numpy_helpers_are_the_jax_packages():
    rng = np.random.default_rng(2)
    values, valid, seg_ids, ns = _case("float")
    seg = seg_ids.astype(np.int64)
    rank = np.arange(len(values), dtype=np.int32)
    _assert_same(tk.numpy_segment_partials(values, valid, seg, rank, ns,
                                           ALL6),
                 jk.numpy_segment_partials(values, valid, seg, rank, ns,
                                           ALL6), ns)
    starts = tk.run_boundaries(seg)
    np.testing.assert_array_equal(starts, jk.run_boundaries(seg))
    ts = np.arange(len(values), dtype=np.int64) + rng.integers(0, 3)
    a = tk.run_segment_partials(values, seg, starts, ns, ALL6, ts=ts)
    b = jk.run_segment_partials(values, seg, starts, ns, ALL6, ts=ts)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_x4_distinct_sort_topk_gather_match_jax():
    rng = np.random.default_rng(9)
    n, groups, nv = 2000, 12, 40
    gid = rng.integers(0, groups, n).astype(np.int64)
    codes = rng.integers(0, nv, n).astype(np.int64)
    np.testing.assert_array_equal(
        tk.segment_distinct_count(gid, codes, groups, nv),
        jk.segment_distinct_count(gid, codes, groups, nv))
    np.testing.assert_array_equal(
        tk.sorted_pair_codes(gid, codes, nv),
        jk.sorted_pair_codes(gid, codes, nv))
    vals = rng.normal(size=n)
    for k in (1, 7, n - 1):
        assert tk.topk_threshold(vals, k) == jk.topk_threshold(vals, k)
    mask = rng.random(nv) > 0.5
    got = tk.dict_mask_gather(mask, torch.from_numpy(codes))
    want = jk.dict_mask_gather(mask, codes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


_BUILDER = """
import sys
from cnosdb_tpu_torch.ops import cuda_build
cuda_build.BUILD_DIR = sys.argv[1]
cuda_build.build_all()
"""


def test_processes_sharing_a_checkout_build_each_kernel_once(tmp_path):
    """Three processes (the nodes of a cluster) build at once: one runs
    the compiler for each source, the others load its output. The
    compiler here is a stand-in that counts its runs."""
    import os
    import subprocess
    import sys

    from cnosdb_tpu_torch.ops import cuda_build

    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    runs = tmp_path / "runs"
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    f"echo \"$@\" >> {runs}\n"
                    "sleep 0.5\n"
                    "while [ \"$1\" != -o ]; do shift; done\n"
                    "echo built > \"$2\"\n")
    nvcc.chmod(0o755)
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"),
               PATH="/usr/bin:/bin")
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, str(build)],
                              env=env, cwd=os.path.dirname(
                                  os.path.dirname(__file__)))
             for _ in range(3)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0, 0]
    assert len(runs.read_text().splitlines()) == len(cuda_build._SIGNATURES)
    built = sorted(f for f in os.listdir(build) if f.endswith(".so"))
    assert len(built) == len(cuda_build._SIGNATURES)
    assert not [f for f in os.listdir(build) if f.endswith(".tmp")]


def test_ordered_segment_sum_matches_numpy():
    """The fixed-order float sum the card takes (its CPU run here): every
    segment's sum of its rows, empty segments 0, NaN and inf carried, bit
    for bit the CPU's index_add_."""
    rng = np.random.default_rng(5)
    n, ns = 50_000, 700                    # some segments stay empty
    vals = rng.normal(0, 1e3, n)
    vals[::997] = np.nan
    vals[5] = np.inf
    seg = rng.integers(0, ns - 50, n)
    got = tk.ordered_segment_sum(torch.from_numpy(vals),
                                 torch.from_numpy(seg), ns).numpy()
    want = np.bincount(seg, weights=vals, minlength=ns)
    np.testing.assert_allclose(got, want, rtol=1e-12, equal_nan=True)
    assert (got[ns - 50:] == 0).all()
    # the same fold as index_add_ on the CPU: from 0, in row order
    rows = torch.zeros(ns, dtype=torch.float64).index_add_(
        0, torch.from_numpy(seg), torch.from_numpy(vals)).numpy()
    assert got.tobytes() == rows.tobytes()
    again = tk.ordered_segment_sum(torch.from_numpy(vals),
                                   torch.from_numpy(seg), ns).numpy()
    assert got.tobytes() == again.tobytes()


def test_segment_sum_keeps_index_add_off_the_card():
    """On the CPU (and for integers anywhere) segment_sum is index_add_:
    the CPU adds in row order, the order the JAX parity tests hold."""
    rng = np.random.default_rng(6)
    vals = torch.from_numpy(rng.normal(size=1000))
    seg = torch.from_numpy(rng.integers(0, 10, 1000))
    want = torch.zeros(10, dtype=torch.float64).index_add_(0, seg, vals)
    assert torch.equal(tk.segment_sum(vals, seg, 10), want)
    ints = torch.from_numpy(rng.integers(-5, 5, 1000))
    assert torch.equal(tk.segment_sum(ints, seg, 10),
                       torch.zeros(10, dtype=torch.int64).index_add_(
                           0, seg, ints))


def test_ordered_segment_sum_cuts_long_segments_into_runs(monkeypatch):
    """A segment longer than a run: its runs fold in parallel, then in
    order; the result is the same bits on every call and within rtol
    1e-12 of numpy."""
    monkeypatch.setattr(tk, "ORDERED_CHUNK", 64)
    rng = np.random.default_rng(8)
    n, ns = 20_000, 9                      # 2,000+ rows a segment
    vals = rng.normal(50, 20, n)
    seg = rng.integers(0, ns - 1, n)       # the last segment stays empty
    got = tk.ordered_segment_sum(torch.from_numpy(vals),
                                 torch.from_numpy(seg), ns).numpy()
    np.testing.assert_allclose(
        got, np.bincount(seg, weights=vals, minlength=ns), rtol=1e-12)
    assert got[-1] == 0
    again = tk.ordered_segment_sum(torch.from_numpy(vals),
                                   torch.from_numpy(seg), ns).numpy()
    assert got.tobytes() == again.tobytes()
    # runs of one segment fold as the sums of their 64-row slices
    rows = vals[np.argsort(seg, kind="stable")][:np.sum(seg == 0)]
    want = 0.0
    for lo in range(0, len(rows), 64):
        part = 0.0
        for x in rows[lo:lo + 64]:
            part += x
        want += part
    assert got[0] == want
