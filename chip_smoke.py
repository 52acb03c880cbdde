"""Smoke run of cnosdb_tpu_torch on one CUDA card: the TSBS devops grouped
scan-aggregate served end to end, on the legacy per-vnode path and on the
mesh execution lane, the ClickBench hits queries on the X4 device routes
and on the host routes, four data-plane suites (an IoT-shaped table at
4,000 trucks, log search, a dashboard over a materialized view, a
tiered cold scan), the serving, gray-failure, memory-governance and
mesh-sweep suites, the server entry point as a three-node cluster
through the chaos plane, both hand-written kernels held against their
plain PyTorch versions and the torch library ops, and the X4 ops against
their plain numpy ones.

    python3 chip_smoke.py [--seed 123] [--rows 10000000]
                          [--hits-rows 4500000] [--iot-scale 4000]
                          [--iot-points 1440] [--suite-rows 6000000]
                          [--mesh-rows 10000000] [--cluster-rows 864000]

Phases, in order:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels (one nvcc per csrc/*.cu, all at once; the
     native host codecs build beside them);
  3. ingest TSBS devops cpu-only data (100 hosts, one point every 10 s,
     usage_user + usage_system, generated from --seed) through
     Coordinator.write_points, flush and compact;
  4. the main path, pinned to the legacy per-vnode path (CNOSDB_MESH=0) on
     any number of cards: the query list below through
     QueryExecutor.execute_one, each answer checked against a numpy oracle
     over the generated arrays (kernel launch counts are zeroed just
     before and read just after), then profiled;
  5. the mesh lane (CNOSDB_MESH=1, CNOSDB_MESH_MIN_ROWS=0,
     CNOSDB_MESH_MIN_DEVICES=1, CNOSDB_COMPRESSED_DOMAIN=0) on the same
     table, counts zeroed just before and read just after: width 1 over
     the card (double_groupby_1 cold, then twice more, double_groupby_all
     and last_loc twice each), the same queries after the cold one over 4
     logical shards on the one card, and over every card where there are
     several. Every answer matches the oracle and the legacy answer of
     step 4; every query engages the lane and merges through the
     collective, with no decline and no mesh.* error. Then width 1
     against the legacy path on warm double_groupby_1, in turns, and
     profiled;
  5b. the invariant-analysis plane: the port's lint engine
     (cnosdb_tpu_torch.analysis) over cnosdb_tpu_torch/ must pass its
     gate here, where there is no jax; then the card's own sync reports
     (torch.cuda.set_sync_debug_mode("warn")) on cold double_groupby_1,
     warm double_groupby_1 on the legacy path and on the width-1 mesh
     lane, and warm cpu_max_all_8, each booked by the innermost stack
     frame under cnosdb_tpu_torch/ and held against what the engine's
     host-sync and torch-sync report or see suppressed. It fails when no
     sync is recorded, or when a sync in host-sync's scope has an
     explicit crossing (.cpu(), .numpy(), .item(), .tolist(), int(),
     float(), bool()) on its source line that the engine misses;
  5c. the port's graft entry points (cnosdb_tpu_torch/graft_entry.py),
     K1/K2 counts zeroed just before and read just after: entry()'s
     flagship step on the card against the plain numpy version (count,
     min, max, first and last bit for bit, the sum within rtol 1e-12),
     then dryrun_multichip(4): the mesh aggregate and three SQL shapes
     over 4 shards on the cards in turn (one card here), each held to
     its oracle; prints {"graft": {...}} on a line of its own;
  5d. both SQL golden corpora (tests/sqllogic/, tests/sqllogic_ref/;
     tests/sqllogic_port.py) through QueryExecutor.execute_one on the
     card with no forcing env, X2/K1/K2/X4 counts zeroed just before and
     read just after: every statement gives its golden answer or, where
     the reference package is recorded wrong on its device branch
     (tests/sqllogic_ref_faults.json), the reference's; X2 must launch;
     a statement the reference answers wrong on its device branch only
     (no host answer recorded) must be golden, and at most 190 may give
     the reference's answer; prints {"sqllogic": {...}} on a line of its
     own (files and statements passed per corpus, the statements that
     gave the recorded reference answer, seconds, launches);
  5e. device semantics at size: a TSBS devops `net`-shaped table
     (SEM_ROWS rows, 100 hosts, 10 s points, from --seed; BIGINT byte
     counters whose per-host sums pass 2^53, a BIGINT above 2^62, about
     10 % NULLs in one DOUBLE and one BIGINT field) in a directory of its
     own; int64 sum/min/max by host, count(*) under OR and NOT across the
     nullable fields, NOT IN with and then without a NULL, integer x/0,
     CAST and count(hostname), each equal to a numpy and Python-int
     oracle, X2's launches rising for each query it must take and not
     for count(hostname); the int64 aggregates again at K1's windowed
     shape (K1 launching) and on the width-1 mesh lane; X2/K1 counts zeroed just before and read just after; prints
     {"semantics": {...}} on a line of its own;
  6. the ClickBench hits table (bench_suites.py's schema and value
     distributions, --hits-rows rows from --seed) written through
     Coordinator.write_points, flushed and compacted; its 43 queries, then
     three synthetic route probes that are not ClickBench traffic (q05/q09
     over a derived table: the only way into the device DISTINCT), each
     run on the default routes (X4 on the card) and again with
     CNOSDB_TPU_GROUP_AGG=0 and CNOSDB_TPU_TOPK=0 (host numpy): identical
     answers, every oracle passed, X4/K1/K2 counts zeroed just before and
     read just after; the device DISTINCT (segment_distinct_count and
     sorted_pair_codes) and the device top-K must have engaged; probe q05d
     and query q16 profiled;
  6b. four data-plane suites of bench_suites_torch.py (the port's copy
     of bench_suites.py), data from --seed, in directories of their own,
     K1/K2/X2 counts zeroed just before and read just after: the IoT
     suite's 13 query names over --iot-scale trucks x --iot-points
     readings (bench_suites.py's IoT-shaped table, 2 tags and one
     measurement, at TSBS --scale=4000 --log-interval=10s trucks for
     4 h: 5,760,000 rows), log search over --suite-rows // 4 OTLP
     spans, each query once cold (scan cache emptied) and three times
     warm, every answer against its oracle; the dashboard (10 steps of --suite-rows // 100
     rows, the panel query with and without its materialized view, with
     the scan cache emptied and through a serving plane, against the
     oracle); the cold scan (10 steps of --suite-rows // 50 rows, half
     tiered to a local object store: hot, cold, warm and the window
     prune against the oracle, the compressed-domain A/B equal and
     downloading fewer bytes); X2 and K2 must launch and no page book a
     device-decode kernel_error; one cold and one warm IoT query
     profiled; prints {"suites": {...}} on a line of its own;
  6c. the other four suites of bench_suites_torch.py, each in a data
     directory of its own, data from --seed, K1/K2/X2 counts and the
     mesh outcomes zeroed just before and read just after: run_pointqps
     (64 hosts x 64 points, 4 threads x 5,000 point queries, then 8 x 40
     fused) through a serving plane of its own, run_straggler (the
     hedge lane, 60 scans a phase, a 120 ms brownout), run_overload (256
     hosts x 200 points, storms and writers at 0.5x, 1x and 2x of the
     footprint) and run_mesh (--mesh-rows rows, widths 1, 2, 4 and 8 of
     [cuda:0] * 8 as logical shards, and of every card where there are
     several, against the legacy merge); every answer against its
     oracle inside the suite; fails on a suite's error, no fused
     request, no spill at 2x, a mesh query off the collective, no X2 or
     K2 launch, a kernel_error page, or a straggler whose hedged p99 is
     not below the unhedged one or whose unhedged p99 is below the
     delay; prints {"suites2": {...}} on a line of its own;
  7. the cluster: one meta process and three query_tskv nodes of
     `python -m cnosdb_tpu_torch.server.main run` on the card (each must
     hold a CUDA context), TSBS devops cpu-only (--cluster-rows, one day at
     scale 100) written as line protocol over HTTP into SHARD 4 REPLICA 3;
     every node's answers to double_groupby_1, last_loc and a grouped
     count/sum/min/max/first/last against the numpy oracle (scans follow
     the live raft leaders: tsbs's sets are led from the static leaders'
     node for its reads, then spread so that every node leads one); a
     seeded device_loss nemesis on nodes whose mesh lane engages, with
     tsbs's sets led from one node (answers byte-identical, the decline
     booked, the lane re-engaged after heal); read-your-writes: dcw's
     leadership moved off its static leader, that node's raft traffic
     held back, keys acked through the new leader, whose scans are then
     slowed past the hedge floor, and one read with no wait through the
     third node holding every acked key with no hedge fired, the lag it
     forced logged; the same through the node that holds no member of
     dcx (SHARD 1 REPLICA 2), whose scan is a leader read: the static
     leader's raft messages delayed, keys acked through the new leader,
     one read with no wait holding every acked key, a redirect booked,
     the static leader's lag logged; a deposed leader's read (its raft
     cut both ways, its own read index refusing, the read served by the
     members that confirm it); a failover read (dcw's leader unreachable
     for the reader's scans, the reader's own replica behind over raft
     by FAILOVER_RAFT_DELAY_MS, the read holding every acked key through
     the follower read index, booked); a seeded symmetric partition
     around one node (the other two answer every query against the
     oracle and take the clients' writes; the cut-off node, which can
     confirm no read of a replicated group, answers against the oracle
     or refuses with the leader-read error within LEADERLESS_READ_S and
     REFUSAL_SLACK_S, each query's ms printed; after the heal the node of
     tsbs's live leaders engages its lane first with the all-local
     answers, and the history checker is green on every node); no vnode
     marked BROKEN in any node's view of meta after each heal and after
     the restart;
     a SIGKILL and restart of one node, read as it comes back with no
     flush or compaction first: its first read decodes its own files on
     the device lane (K2) with no memcache-overlap page, rounds of reads
     during its catch-up all answer and hold to the oracle, and its
     memory cache stays under 1 MB; recorded clients writing and reading
     throughout, judged by the history checker on every node; the CLI
     against HTTP and its --dump-ddl replayed; then the crash sweep over
     chaos.sweep.FAST_POINTS with its workload subprocesses on the card;
  8. each kernel at the shape the main path gave it, on the card, against
     its plain version (twice, for bit-stable output), with its time, the
     plain version's time, the torch library ops' time for K1, and its
     bound, and K1 again at the whole TSBS table and at the shape the hits
     phase gave it most, and each at the shape each suites phase (6b,
     6c) gave it most; each X4
     op likewise against its plain numpy version at the largest shape the
     hits phase gave it;
  9. assertions: scan device is cuda, the fused program launched, K1 ran on
     the warm cpu_max_all_8, K2 on both paths' cold scans, no
     device-decode kernel_error outcome.

Prints a JSON line of the analysis phase ({"analysis": {...}}), one of
the graft phase ({"graft": {...}}), one of the SQL corpora
({"sqllogic": {...}}), one of the semantics phase ({"semantics":
{...}}), one of each suites phase ({"suites": {...}}, {"suites2":
{...}}), a JSON line of
per-kernel numbers
(with an "x4" list), the nvidia-smi line, and as its last line
{"ok": true, "device": {...}}.
Exits non-zero, printing no result, when there is no CUDA device, when
the package is missing, or when any phase fails.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import linecache
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N_HOSTS = 100
INTERVAL_NS = 10 * 10**9          # one point every 10 s
BUCKET_NS = 3600 * 10**9          # 1 h buckets
BASE_TS = 1_640_995_200_000_000_000  # 2022-01-01
CHUNK = 250_000
LOAD_WORKERS = 8
SHARDS = 8
HBM_BYTES_PER_S = 3.35e12         # H100 SXM, NVIDIA data sheet
PROFILE_MARGIN_S = 0.05
SQL = {
    "double_groupby_1":
        "SELECT date_bin(INTERVAL '1 hour', time) AS t, hostname, "
        "avg(usage_user) AS m FROM cpu GROUP BY t, hostname",
    "double_groupby_all":
        "SELECT date_bin(INTERVAL '1 hour', time) AS t, hostname, "
        "avg(usage_user) AS mu, avg(usage_system) AS ms "
        "FROM cpu GROUP BY t, hostname",
    "last_loc":
        "SELECT hostname, last(usage_user) AS l FROM cpu GROUP BY hostname",
}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- data
class Data:
    """The generated TSBS columns, host-major (the numpy oracle's input)."""

    def __init__(self, seed: int, rows: int):
        self.per_host = max(1, rows // N_HOSTS)
        self.seed = seed
        k = np.arange(self.per_host)
        self.user = np.empty((N_HOSTS, self.per_host))
        self.syst = np.empty((N_HOSTS, self.per_host))
        for h in range(N_HOSTS):
            rng = np.random.default_rng(seed + h)
            u = np.clip(50 + 20 * np.sin(k / 500 + h)
                        + rng.normal(0, 5, self.per_host), 0, 100)
            self.user[h] = u
            self.syst[h] = np.clip(u * 0.4 + rng.normal(0, 2, self.per_host),
                                   0, 100)
        self.ts = BASE_TS + k.astype(np.int64) * INTERVAL_NS
        self.bucket = (k.astype(np.int64) * INTERVAL_NS) // BUCKET_NS
        self.nb = int(self.bucket[-1]) + 1
        self.rows = N_HOSTS * self.per_host


def ingest(coord, data: Data) -> tuple[float, float]:
    from cnosdb_tpu_torch.models.points import SeriesRows, WriteBatch
    from cnosdb_tpu_torch.models.schema import ValueType
    from cnosdb_tpu_torch.models.series import SeriesKey
    from cnosdb_tpu_torch.parallel.meta import DEFAULT_TENANT

    t0 = time.perf_counter()

    def load_host(h):
        key = SeriesKey("cpu", {"hostname": f"host_{h:03d}"})
        for off in range(0, data.per_host, CHUNK):
            e = min(off + CHUNK, data.per_host)
            wb = WriteBatch()
            wb.add_series("cpu", SeriesRows(
                key, data.ts[off:e],
                {"usage_user": (int(ValueType.FLOAT), data.user[h, off:e]),
                 "usage_system": (int(ValueType.FLOAT),
                                  data.syst[h, off:e])}))
            coord.write_points(DEFAULT_TENANT, "public", wb)

    with ThreadPoolExecutor(max_workers=LOAD_WORKERS) as pool:
        list(pool.map(load_host, range(N_HOSTS)))
    coord.engine.flush_all()
    ingest_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    coord.engine.compact_all()
    return ingest_s, time.perf_counter() - t1


# ---------------------------------------------------------------- oracle
def _seg_mean(seg, w, nseg):
    s = np.bincount(seg, weights=w, minlength=nseg)
    c = np.bincount(seg, minlength=nseg)
    return s / np.maximum(c, 1), c


def _cols(rs):
    return {n: c for n, c in zip(rs.names, rs.columns)}


def _host_idx(names) -> np.ndarray:
    return np.array([int(str(h).split("_")[1]) for h in names])


def check_groupby(rs, data: Data, col_of: dict) -> None:
    """Every (hour, host) group against numpy means over the arrays."""
    c = _cols(rs)
    seg_all = (np.arange(N_HOSTS)[:, None] * data.nb
               + data.bucket[None, :]).ravel()
    nseg = N_HOSTS * data.nb
    got_seg = _host_idx(c["hostname"]) * data.nb \
        + (np.asarray(c["t"], dtype=np.int64) - BASE_TS) // BUCKET_NS
    if len(got_seg) != nseg or len(np.unique(got_seg)) != nseg:
        raise AssertionError(f"{len(got_seg)} groups, want {nseg}")
    for alias, arr in col_of.items():
        want, _ = _seg_mean(seg_all, arr.ravel(), nseg)
        np.testing.assert_allclose(np.asarray(c[alias], dtype=np.float64),
                                   want[got_seg], rtol=1e-9, err_msg=alias)


def cpu_max_sql(data: Data):
    mid = data.nb // 2
    win_lo = BASE_TS + mid * BUCKET_NS
    win_hi = win_lo + 12 * BUCKET_NS - 1
    hosts = list(range(0, 64, 8))
    in_list = ", ".join(f"'host_{h:03d}'" for h in hosts)
    sql = ("SELECT date_bin(INTERVAL '1 hour', time) AS t, "
           "max(usage_user) AS a1, min(usage_user) AS a2, "
           "sum(usage_user) AS a3, avg(usage_user) AS a4, "
           "max(usage_system) AS a5, min(usage_system) AS a6, "
           "sum(usage_system) AS a7, avg(usage_system) AS a8 "
           f"FROM cpu WHERE hostname IN ({in_list}) "
           f"AND time >= {win_lo} AND time <= {win_hi} GROUP BY t")
    return sql, win_lo, win_hi, hosts


def check_cpu_max(rs, data: Data, win_lo, win_hi, hosts) -> None:
    c = _cols(rs)
    sel = (data.ts >= win_lo) & (data.ts <= win_hi)
    b = data.bucket[sel]
    order = np.argsort(np.asarray(c["t"], dtype=np.int64))
    got_b = (np.asarray(c["t"], dtype=np.int64)[order] - BASE_TS) \
        // BUCKET_NS
    want_b = np.unique(b)
    np.testing.assert_array_equal(got_b, want_b)
    for col, (amax, amin, asum, amean) in (
            (data.user, ("a1", "a2", "a3", "a4")),
            (data.syst, ("a5", "a6", "a7", "a8"))):
        v = col[hosts][:, sel]
        for i, bb in enumerate(want_b):
            x = v[:, b == bb]
            assert float(np.asarray(c[amax])[order][i]) == x.max(), amax
            assert float(np.asarray(c[amin])[order][i]) == x.min(), amin
            np.testing.assert_allclose(np.asarray(c[asum])[order][i],
                                       x.sum(), rtol=1e-9, err_msg=asum)
            np.testing.assert_allclose(np.asarray(c[amean])[order][i],
                                       x.mean(), rtol=1e-9, err_msg=amean)


def check_last(rs, data: Data) -> None:
    c = _cols(rs)
    h = _host_idx(c["hostname"])
    assert sorted(h.tolist()) == list(range(N_HOSTS))
    np.testing.assert_array_equal(np.asarray(c["l"], dtype=np.float64),
                                  data.user[h, -1])


# ---------------------------------------------------------------- kernels
def cuda_ms(fn, iters: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 200) -> float:
    """Host-clock ms per call of a function that synchronizes itself."""
    fn()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t) * 1e3 / iters


def _bits(t):
    import torch

    return t.view(torch.int64) if t.dtype == torch.float64 else t


def k1_case(n: int, ns: int, n_series: int, grouped: bool, dtype: str,
            seed: int, nan: bool, nulls: bool, scattered: bool = False):
    """Storage-shaped K1 inputs: `n_series` series-contiguous runs, each
    with ascending time buckets; seg = bucket (cpu_max_all_8 groups by
    hour only) or, `grouped`, series × buckets + bucket (double_groupby).
    `scattered`: one series whose group key is drawn anew for every row
    (the hits table grouped by a field). Optional NaNs and NULLs."""
    rng = np.random.default_rng(seed)
    per = -(-n // n_series)
    buckets = ns // n_series if grouped else ns
    within = np.arange(per) * buckets // per
    host = np.repeat(np.arange(n_series), per)[:n]
    seg = (np.tile(within, n_series)[:n]
           + (host * buckets if grouped else 0)).astype(np.int32)
    if scattered:
        seg = rng.integers(0, ns, n).astype(np.int32)
    valid = np.ones(n, dtype=bool)
    if nulls:
        valid &= rng.random(n) > 0.2
    if dtype == "float64":
        vals = rng.normal(50, 20, n)
        if nan:
            vals[rng.random(n) < 0.001] = np.nan
    else:
        vals = rng.integers(-(1 << 62), 1 << 62, n)
    return vals, valid, seg


def check_k1(got: dict, plain: dict, dtype: str, what: str) -> float:
    """count/min/max exact, the float sum within rtol 1e-12 (the
    reference's own tolerance) → max |sum - plain|."""
    import torch

    worst = 0.0
    for k in plain:
        g = torch.as_tensor(got[k]).cpu()
        p = plain[k].cpu()
        if k == "sum" and dtype == "float64":
            torch.testing.assert_close(g, p, rtol=1e-12, atol=1e-9,
                                       equal_nan=True)
            d = (g - p).abs()
            d = d[~torch.isnan(d)]
            worst = max(worst, float(d.max()) if len(d) else 0.0)
        elif not torch.equal(_bits(g), _bits(p)):
            raise AssertionError(f"K1 {k} differs from plain ({what})")
    return worst


def compare_k1(shape, seed: int, dev, n_series: int = 1,
               grouped: bool = False, call: bool = True,
               scattered: bool = False, call_iters: int = 200) -> dict:
    """K1 at one shape: against its plain version (three data variants,
    twice each for bit-stable output), then timed on the first variant of
    the shape's dtype: `ms` the CUDA entry on device-resident rows with
    its layout staging, `kernel_ms` the launch alone over staged buffers,
    `call_ms` the host wrapper from numpy in to numpy out (what
    aggregate_column_host pays), `plain_ms`, and `library_ms` the torch
    library ops that compute the same function (held against the plain
    version first). `bound_ms` counts the function's own bytes (13 B a
    row in, 28 B a segment out), whatever layout an implementation
    stages."""
    import torch

    from cnosdb_tpu_torch.ops import kernels
    from cnosdb_tpu_torch.ops import pallas_kernels as pk

    n, ns, dt = shape
    worst = 0.0
    timed = None
    for dtype, nan, nulls in (("float64", False, False),
                              ("float64", True, True),
                              ("int64", False, True)):
        vals, valid, seg = k1_case(n, ns, n_series, grouped, dtype, seed,
                                   nan, nulls, scattered)
        layout = pk.window_layout(seg, ns)
        args = [torch.from_numpy(vals).to(dev),
                torch.from_numpy(valid.astype(np.int8)).to(dev),
                torch.from_numpy(seg).to(dev)]
        got = pk.window_partials(*args, layout, ns)
        again = pk.window_partials(*args, layout, ns)
        plain = pk.window_partials_plain(*args, layout, ns)
        torch.cuda.synchronize()
        for k in got:
            if not torch.equal(_bits(got[k]), _bits(again[k])):
                raise AssertionError(f"K1 {k} not bit-stable ({dtype})")
        worst = max(worst, check_k1(got, plain, dtype, dtype))
        if call:
            host = pk.segment_partials_pallas(vals, valid, seg, ns)
            worst = max(worst, check_k1(host, plain, dtype, "host wrapper"))
        if timed is None and dt == f"torch.{dtype}":
            timed = (vals, valid, seg, args, layout)
    vals, valid, seg, args, layout = timed
    # the torch library computation of the same function (X1's ops:
    # index_add_ for count and sum, scatter_reduce_ amin/amax)
    as_bool = args[1].bool()
    library = lambda: kernels.local_segment_partials(  # noqa: E731
        args[0], as_bool, args[2], None, num_segments=ns)
    check_k1(library(), pk.window_partials_plain(*args, layout, ns),
             str(vals.dtype), "library")
    library_ms = cuda_ms(library)
    ms = cuda_ms(lambda: pk.window_partials(*args, layout, ns))
    launch = pk.prepare(*args, layout, ns)
    kernel_ms = cuda_ms(launch, iters=200)
    plain_ms = cuda_ms(lambda: pk.window_partials_plain(*args, layout, ns))
    call_ms = (host_ms(lambda: pk.segment_partials_pallas(vals, valid, seg,
                                                          ns),
                       iters=call_iters)
               if call else None)
    moved = k1_bytes(n, ns)
    return {"ms": ms, "kernel_ms": kernel_ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "max_abs_err": worst,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bytes": moved}


def k1_bytes(n: int, ns: int) -> int:
    """What K1's function must move: values, valid flags and segment ids
    in (13 B a row), count/sum/min/max out (28 B a segment)."""
    return n * (8 + 1 + 4) + ns * (4 + 8 * 3)


def k1_threads(shape, seed: int, n_series: int, threads: int = 8,
               repeats: int = 20) -> None:
    """`threads` threads call the host wrapper at once, on as many
    different inputs at the main-path shape, `repeats` times each; every
    result is held against the plain version. Raises on a mismatch."""
    import torch

    from cnosdb_tpu_torch.ops import pallas_kernels as pk

    n, ns, _dt = shape
    cases = [k1_case(n, ns, n_series, False,
                     "float64" if i % 2 == 0 else "int64", seed + 10 + i,
                     i % 4 == 0, True) for i in range(threads)]
    barrier = threading.Barrier(threads)

    def work(i):
        vals, valid, seg = cases[i]
        barrier.wait()
        return [pk.segment_partials_pallas(vals, valid, seg, ns)
                for _ in range(repeats)]

    with ThreadPoolExecutor(max_workers=threads) as pool:
        results = list(pool.map(work, range(threads)))
    for i, ((vals, valid, seg), runs) in enumerate(zip(cases, results)):
        plain = pk.window_partials_plain(
            torch.from_numpy(vals), torch.from_numpy(valid.astype(np.int8)),
            torch.from_numpy(seg), pk.window_layout(seg, ns), ns)
        dtype = str(vals.dtype)
        for got in runs:
            check_k1(got, plain, dtype, f"thread {i}")
            for k in got:
                if got[k].tobytes() != runs[0][k].tobytes():
                    raise AssertionError(f"K1 {k} not bit-stable across "
                                         f"threaded calls (thread {i})")


def compare_k2(shape, seed: int, dev) -> dict:
    """K2 at one [B, L]: the whole Gorilla decode and the scan alone
    against their plain versions (twice, for bit-stable output), then
    timed: `ms` gorilla_decode on the planes (the main path's call),
    `kernel_ms` its launch alone into kept buffers, `scan_ms` xor_scan on
    the words, `plain_ms` the plain decode."""
    import torch

    from cnosdb_tpu_torch.ops import device_decode as dd

    b, width = shape
    rng = np.random.default_rng(seed)
    planes = torch.from_numpy(rng.integers(0, 256, (b, 8, width),
                                           dtype=np.uint8)).to(dev)
    got = dd.gorilla_decode(planes)
    again = dd.gorilla_decode(planes)
    plain = dd.gorilla_decode_plain(planes)
    words = dd._gorilla_words(planes)
    scan = dd.xor_scan(words)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("K2 decode not bit-stable")
    if not torch.equal(got, plain):
        raise AssertionError("K2 decode differs from plain")
    if not torch.equal(scan, plain):
        raise AssertionError("K2 scan differs from plain")
    ms = cuda_ms(lambda: dd.gorilla_decode(planes), iters=50)
    out = torch.empty_like(got)
    state = dd.k2_state(shape, dev)
    kernel_ms = cuda_ms(lambda: dd._k2_launch(
        "gorilla_decode_u8", planes, shape, out, state), iters=200)
    scan_ms = cuda_ms(lambda: dd.xor_scan(words), iters=50)
    plain_ms = cuda_ms(lambda: dd.gorilla_decode_plain(planes))
    moved = b * width * (8 + 8)    # byte planes in, f64 bits out
    return {"ms": ms, "kernel_ms": kernel_ms, "scan_ms": scan_ms,
            "plain_ms": plain_ms, "max_abs_err": 0.0,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bytes": moved}


def compare_segment_sum(seed: int, dev) -> list:
    """The f64 segment sum of X1 and the mesh lane on the card:
    kernels.segment_sum (the ordered fold) against index_add_ (atomics),
    at the main path's shapes and at one segment over the whole table.
    Counts the distinct results of 10 runs of each, holds the ordered one
    to index_add_ on the CPU bit for bit where no segment passes
    ORDERED_CHUNK rows (else within rtol 1e-12), and times both."""
    import torch

    from cnosdb_tpu_torch.ops import kernels

    out = []
    rng = np.random.default_rng(seed)
    for n, ns in ((4_320, 12), (864_000, 100), (10_000_000, 27_800),
                  (10_000_000, 1)):
        vals = rng.normal(50, 20, n)
        seg = rng.integers(0, ns, n)
        v = torch.from_numpy(vals).to(dev)
        s = torch.from_numpy(seg).to(dev)
        atomic = lambda: torch.zeros(  # noqa: E731
            ns, dtype=torch.float64, device=dev).index_add_(0, s, v)
        ordered = lambda: kernels.segment_sum(v, s, ns)  # noqa: E731
        runs_a = {atomic().cpu().numpy().tobytes() for _ in range(10)}
        runs_o = {ordered().cpu().numpy().tobytes() for _ in range(10)}
        cpu = torch.zeros(ns, dtype=torch.float64).index_add_(
            0, torch.from_numpy(seg), torch.from_numpy(vals)).numpy()
        got = np.frombuffer(next(iter(runs_o)), dtype=np.float64)
        if len(runs_o) != 1:
            raise AssertionError(f"segment_sum at {(n, ns)} not bit-stable")
        if n // ns <= kernels.ORDERED_CHUNK // 2:
            if got.tobytes() != cpu.tobytes():
                raise AssertionError(f"segment_sum at {(n, ns)} differs "
                                     "from index_add_ on the CPU")
        else:
            np.testing.assert_allclose(got, cpu, rtol=1e-12)
        row = {"at": [n, ns], "index_add_ms": cuda_ms(atomic),
               "ordered_ms": cuda_ms(ordered),
               "index_add_distinct_of_10": len(runs_a),
               "ordered_distinct_of_10": len(runs_o),
               "ordered_equals_cpu": got.tobytes() == cpu.tobytes()}
        out.append(row)
        log(f"# f64 segment sum at {(n, ns)}: index_add_ "
            f"{row['index_add_ms']:.4f} ms, {len(runs_a)} distinct results "
            f"in 10 runs; ordered {row['ordered_ms']:.4f} ms, "
            f"{len(runs_o)} distinct, equal to index_add_ on the CPU: "
            f"{row['ordered_equals_cpu']}")
    return out


def _most_launched(shapes: dict):
    return max(shapes.items(), key=lambda kv: (kv[1], kv[0][0]))[0]


def _launch_counts() -> dict:
    """Every launch counter of the port: X4 ops by name, K1, K2."""
    from cnosdb_tpu_torch.ops import device_decode as dd
    from cnosdb_tpu_torch.ops import kernels
    from cnosdb_tpu_torch.ops import pallas_kernels as pk

    return {**kernels.x4_launches, "K1": pk.launches, "K2": dd.xor_launches}


def profile_query(ex, session, sql: str, prepare=None) -> None:
    """`sql` under the stage profiler and torch.profiler: one warm-up
    step that the profiler does not keep (it readies the device tracer),
    then the recorded run; `prepare()`, when given, runs before each of
    the two (a cold profile clears the scan cache there). Prints the
    host stage breakdown, the routes and launches of the recorded run,
    and the card's busy time against wall time with the kernels that
    took it. Every X4 op and K1 launch
    uploads its input, so a trace with fewer host-to-device copies than
    those launches has lost device events: its busy time is then not
    measured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from cnosdb_tpu_torch.utils import stages

    qp = stages.QueryProfile()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        if prepare is not None:
            prepare()
        ex.execute_one(sql, session)
        torch.cuda.synchronize()
        prof.step()
        if prepare is not None:
            prepare()
        # idle margins inside the recorded step, so that no device event
        # of the query lies near either edge of the trace window
        time.sleep(PROFILE_MARGIN_S)
        before = _launch_counts()
        t = time.perf_counter()
        with stages.profile_scope(qp):
            ex.execute_one(sql, session)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        after = _launch_counts()
        time.sleep(PROFILE_MARGIN_S)
        prof.step()
    launched = {k: v - before.get(k, 0) for k, v in after.items()
                if v != before.get(k, 0)}
    snap = qp.snapshot()
    times = {k: round(v, 3) for k, v in snap.items() if k.endswith("_ms")}
    routes = {k: v for k, v in snap.items()
              if k.startswith(("topk.", "distinct_path."))}
    dev = []
    runtime = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            # a host op (aten::*) may carry the time of the kernels it
            # launched: count only the device's own events
            if e.key.startswith(("cudaLaunchKernel", "cudaMemcpy")):
                runtime += e.count
            continue
        if e.key.startswith("ProfilerStep"):
            continue   # the step's annotation spans the device timeline
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            dev.append((us / 1e3, e.key, e.count))
    dev.sort(reverse=True)
    busy = sum(ms for ms, _k, _n in dev)
    uploads = sum(n for _ms, k, n in dev if k.startswith("Memcpy HtoD"))
    want = sum(n for k, n in launched.items() if k != "K2")
    log(f"#   stages {times}; routes {routes or '-'}; launched "
        f"{launched or '-'}; device events {sum(n for *_x, n in dev)}, "
        f"runtime API calls {runtime}, uploads {uploads}")
    if not dev or uploads < want:
        log(f"#   device time: not measured (the trace kept {uploads} "
            f"host-to-device copies of at least {want}); wall "
            f"{wall:.3f} ms under the profiler; kept: "
            + "; ".join(f"{k[:60]} x{n}" for _ms, k, n in dev))
        return
    log(f"#   device busy {busy:.3f} ms of {wall:.3f} ms wall under the "
        f"profiler ({100 * busy / wall:.1f} %); top: "
        + "; ".join(f"{k[:60]} {ms:.3f} ms x{n}" for ms, k, n in dev[:6]))


# ---------------------------------------------------------------- mesh lane
# bench_suites.run_mesh's settings; the compressed-domain lane is off
# because it answers last() from page metadata before any aggregate runs,
# so last_loc would never reach the mesh lane
MESH_KNOBS = {"CNOSDB_MESH": "1", "CNOSDB_MESH_MIN_ROWS": "0",
              "CNOSDB_MESH_MIN_DEVICES": "1", "CNOSDB_COMPRESSED_DOMAIN": "0"}
MESH_DECLINES = ("plan_error", "device_loss", "few_devices", "no_devices")
# per query: the key columns and the value columns held exactly / within
# rtol 1e-12 against the legacy answer (f64 means: index_add_ adds f64
# with atomics on the card, on both paths)
MESH_COMPARE = {
    "double_groupby_1": (("t", "hostname"), (), ("m",)),
    "double_groupby_all": (("t", "hostname"), (), ("mu", "ms")),
    "last_loc": (("hostname",), ("l",), ()),
}


def check_legacy(rs, ref, keys, exact, close) -> None:
    """`rs` against the legacy answer `ref`: the same groups, values
    exact or within rtol 1e-12, matched by key (not by row order)."""
    a, b = _cols(rs), _cols(ref)
    ka = list(zip(*[np.asarray(a[k]).tolist() for k in keys]))
    kb = list(zip(*[np.asarray(b[k]).tolist() for k in keys]))
    pos = {k: i for i, k in enumerate(kb)}
    if len(ka) != len(kb) or len(pos) != len(kb) \
            or any(k not in pos for k in ka):
        raise AssertionError("mesh groups differ from the legacy groups")
    order = np.array([pos[k] for k in ka], dtype=np.int64)
    for col in exact:
        np.testing.assert_array_equal(np.asarray(a[col]),
                                      np.asarray(b[col])[order], err_msg=col)
    for col in close:
        np.testing.assert_allclose(np.asarray(a[col], dtype=np.float64),
                                   np.asarray(b[col], dtype=np.float64)
                                   [order], rtol=1e-12, atol=0, err_msg=col)


def mesh_phase(ex, session, coord, data, legacy, checks) -> dict:
    """Step 5: the mesh lane over the ingested table. `legacy` holds the
    pinned path's warm answers and wall times by query name, `checks`
    the oracle checks. Raises on a wrong answer, a decline or a missing
    engagement. → {"launches": {...}, "queries": n}."""
    import torch

    import bench_suites_torch as bst
    from cnosdb_tpu_torch.ops import device_decode as dd
    from cnosdb_tpu_torch.ops import pallas_kernels as pk
    from cnosdb_tpu_torch.parallel import mesh
    from cnosdb_tpu_torch.utils import stages

    os.environ.update(MESH_KNOBS)
    cuda0 = torch.device("cuda", 0)
    widths = [("width 1", "1", None, True),
              ("4 logical shards on cuda:0", None, [cuda0] * 4, False)]
    if torch.cuda.device_count() > 1:
        widths.append((f"{torch.cuda.device_count()} cards", None, None,
                       False))
    errors0 = {k: v for k, v in stages.errors_snapshot().items()
               if k.startswith("mesh.")}
    pk.launches = 0
    dd.xor_launches = 0
    mesh.reset_counters()
    n_queries = 0
    k2_cold = 0
    for label, cap, devices, cold in widths:
        if cap is None:
            os.environ.pop("CNOSDB_MESH_DEVICES", None)
        else:
            os.environ["CNOSDB_MESH_DEVICES"] = cap
        plan = [("double_groupby_1", True)] if cold else []
        plan += [("double_groupby_1", False), ("double_groupby_1", False),
                 ("double_groupby_all", False), ("double_groupby_all", False),
                 ("last_loc", False), ("last_loc", False)]
        seen = set()
        with bst.mesh_pool(devices):
            m = mesh.get_mesh()
            log(f"# mesh {label}: {mesh.mesh_size(m)} shards on "
                f"{sorted({str(d) for d in m.devices})}")
            for name, clear in plan:
                if clear:
                    bst.clear_scan_cache(coord)
                before = mesh.outcomes_snapshot()
                k2 = dd.xor_launches
                qp = stages.QueryProfile()
                t = time.perf_counter()
                with stages.profile_scope(qp):
                    rs = ex.execute_one(SQL[name], session)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3
                after = mesh.outcomes_snapshot()
                n_queries += 1
                for key in (("exec", "engaged"), ("merge", "collective")):
                    if after.get(key, 0) != before.get(key, 0) + 1:
                        raise AssertionError(
                            f"mesh {label} {name}: {key} not booked: {after}")
                checks[name](rs)
                keys, exact, close = MESH_COMPARE[name]
                check_legacy(rs, legacy[name][0], keys, exact, close)
                if clear:
                    k2_cold += dd.xor_launches - k2
                st = {k: round(v, 3) for k, v in qp.snapshot().items()
                      if k.startswith("mesh.")}
                state = "cold" if clear else (
                    "repeat" if name in seen else "first")
                seen.add(name)
                log(f"# mesh {label} {name} ({state}):"
                    f" {ms:.1f} ms, {len(rs.columns[0])} rows, K2 "
                    f"+{dd.xor_launches - k2}, matches the numpy oracle "
                    f"and the legacy answer; stages {st}")
    snap = mesh.outcomes_snapshot()
    launches = {"K1": pk.launches, "K2": dd.xor_launches}
    errors = {k: v for k, v in stages.errors_snapshot().items()
              if k.startswith("mesh.")}
    log(f"# mesh lane: {n_queries} queries, outcomes {snap}, K1 launches "
        f"{launches['K1']}, K2 launches {launches['K2']}")
    if snap.get(("exec", "engaged"), 0) != n_queries \
            or snap.get(("merge", "collective"), 0) != n_queries:
        raise AssertionError(f"mesh lane engaged {snap}, want {n_queries}")
    bad = {k: v for k, v in snap.items() if k[1] in MESH_DECLINES}
    if bad:
        raise AssertionError(f"mesh lane declined: {bad}")
    if errors != errors0:
        raise AssertionError(f"mesh errors booked: {errors} (was {errors0})")
    if k2_cold <= 0:
        raise AssertionError("K2 did not run on the mesh phase's cold scan")

    # width 1 against the legacy path on warm double_groupby_1, in turns
    os.environ["CNOSDB_MESH_DEVICES"] = "1"
    walls = {"legacy": [], "mesh": []}
    for path in ("mesh", "legacy") + ("legacy", "mesh", "mesh", "legacy") * 2:
        os.environ["CNOSDB_MESH"] = "1" if path == "mesh" else "0"
        t = time.perf_counter()
        ex.execute_one(SQL["double_groupby_1"], session)
        torch.cuda.synchronize()
        walls[path].append(round((time.perf_counter() - t) * 1e3, 3))
    log(f"# double_groupby_1 warm, in turns in this process after one "
        f"warm-up each: mesh width 1 {walls['mesh'][1:]} ms, legacy "
        f"{walls['legacy'][1:]} ms (pinned phase's warm runs: "
        f"{legacy['double_groupby_1'][1]} ms)")
    os.environ["CNOSDB_MESH"] = "1"
    for name in ("double_groupby_1", "last_loc"):
        log(f"# profile mesh width 1 {name} (warm):")
        profile_query(ex, session, SQL[name])
    for k in MESH_KNOBS:
        os.environ.pop(k, None)
    os.environ["CNOSDB_MESH"] = "0"
    os.environ.pop("CNOSDB_MESH_DEVICES", None)
    return {"launches": launches, "queries": n_queries}


# ---------------------------------------------------------------- analysis
SYNC_MESSAGE = "called a synchronizing CUDA operation"
# an explicit device->host crossing written on a source line: the syncs
# host-sync must report or see suppressed where it applies
EXPLICIT_CROSSING = re.compile(
    r"\.(cpu|numpy|item|tolist)\(\)|\b(int|float|bool)\(")


class SyncRecorder:
    """The card's own sync reports. Under
    torch.cuda.set_sync_debug_mode("warn") every synchronizing CUDA
    operation warns; a lock-guarded warnings.showwarning hook (the legacy
    path dispatches on a thread pool, and warnings.catch_warnings is not
    thread-safe) books each, per query, by the innermost stack frame under
    cnosdb_tpu_torch/, not the frame the warning names (ops such as
    torch.unique warn from torch's own Python)."""

    def __init__(self):
        import cnosdb_tpu_torch

        self.pkg = os.path.dirname(os.path.abspath(cnosdb_tpu_torch.__file__))
        self.root = os.path.dirname(self.pkg)
        self.lock = threading.Lock()
        self.query = None
        self.counts: dict = {}      # (relpath, line) → {query: syncs}
        self.outside: dict = {}     # query → syncs with no package frame
        self._saved = None
        # every occurrence, not once per location
        warnings.filterwarnings("always", message=".*" + SYNC_MESSAGE)

    def _hook(self, message, category, filename, lineno, file=None,
              line=None):
        if SYNC_MESSAGE not in str(message):
            return self._saved(message, category, filename, lineno, file,
                               line)
        f = sys._getframe(1)
        while f is not None and not f.f_code.co_filename.startswith(
                self.pkg + os.sep):
            f = f.f_back
        with self.lock:
            if f is None:
                self.outside[self.query] = \
                    self.outside.get(self.query, 0) + 1
                return
            site = (os.path.relpath(f.f_code.co_filename, self.root)
                    .replace(os.sep, "/"), f.f_lineno)
            per = self.counts.setdefault(site, {})
            per[self.query] = per.get(self.query, 0) + 1

    @contextlib.contextmanager
    def recording(self, query: str):
        import torch

        torch.cuda.synchronize()   # earlier work must not report here
        self.query = query
        self._saved = warnings.showwarning
        warnings.showwarning = self._hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = self._saved


def _pin_path(on_mesh: bool) -> None:
    """The width-1 mesh lane with the mesh phase's knobs, or the main
    path's environment: the legacy per-vnode path."""
    if on_mesh:
        os.environ.update(MESH_KNOBS)
        os.environ["CNOSDB_MESH_DEVICES"] = "1"
        return
    for k in MESH_KNOBS:
        os.environ.pop(k, None)
    os.environ.pop("CNOSDB_MESH_DEVICES", None)
    os.environ["CNOSDB_MESH"] = "0"


def analysis_phase(ex, session, coord, checks, sql8, c8) -> dict:
    """Step 5b: the port's engine over cnosdb_tpu_torch/ (its gate must
    pass), then four queries under the card's sync reports, each site
    held against the engine. Raises when the gate fails, when no sync was
    recorded (then the debug mode proved nothing), or when a sync in
    host-sync's scope has an explicit crossing on its source line that
    the engine neither reports nor sees suppressed: a gap in the port's
    taint (cnosdb_tpu_torch/analysis/interproc.py). → the phase's JSON."""
    import torch

    import bench_suites_torch as bst
    from cnosdb_tpu_torch import analysis
    from cnosdb_tpu_torch.analysis import interproc, rules
    from cnosdb_tpu_torch.ops import device_decode as dd
    from cnosdb_tpu_torch.ops import pallas_kernels as pk
    from cnosdb_tpu_torch.parallel import mesh

    rep = analysis.run()
    per_rule = {r: n for r, n in sorted(rep.rule_totals.items()) if n}
    log(f"# analysis gate: ok {rep.ok}, {len(rep.findings)} findings "
        f"({len(rep.findings) - len(rep.violations)} baselined), "
        f"{len(rep.stale)} stale cells, per rule {per_rule}, engine wall "
        f"{rep.wall_ms} ms")
    if not rep.ok:
        raise AssertionError(
            f"analysis gate failed: {[f.render() for f in rep.violations]} "
            f"stale {rep.stale}")
    host_sync = interproc.HostSync()
    static: dict = {}      # (relpath, line) → what the engine sees there
    for rule in (host_sync, rules.TorchSync()):
        found, suppressed = interproc.rule_sites(rule)
        for f in found:
            static[(f.path, f.line)] = f"reported ({rule.name})"
        for rel, lines in suppressed.items():
            for ln in lines:
                static.setdefault((rel, ln), f"suppressed ({rule.name})")

    rec = SyncRecorder()
    plan = (("double_groupby_1 cold", SQL["double_groupby_1"],
             checks["double_groupby_1"], False, "cold"),
            ("double_groupby_1 warm", SQL["double_groupby_1"],
             checks["double_groupby_1"], False, "warm"),
            ("double_groupby_1 warm mesh width 1", SQL["double_groupby_1"],
             checks["double_groupby_1"], True, "warm"),
            ("cpu_max_all_8 warm", sql8, c8, False, "warm"))
    walls = {}
    for name, sql, check, on_mesh, state in plan:
        _pin_path(on_mesh)
        if state == "cold":
            bst.clear_scan_cache(coord)
        else:
            ex.execute_one(sql, session)   # the warm-up is not recorded
        before = mesh.outcomes_snapshot()
        k1, k2 = pk.launches, dd.xor_launches
        t = time.perf_counter()
        with rec.recording(name):
            rs = ex.execute_one(sql, session)
        torch.cuda.synchronize()
        walls[name] = round((time.perf_counter() - t) * 1e3, 3)
        check(rs)
        engaged = mesh.outcomes_snapshot().get(("exec", "engaged"), 0) \
            - before.get(("exec", "engaged"), 0)
        if on_mesh and engaged != 1:
            raise AssertionError(f"{name}: the mesh lane did not engage")
        if name.startswith("cpu_max") and pk.launches == k1:
            raise AssertionError(f"{name}: K1 did not run")
        if state == "cold" and dd.xor_launches == k2:
            raise AssertionError(f"{name}: K2 did not run")
    _pin_path(False)

    sites = []
    for (rel, ln), per in sorted(rec.counts.items()):
        code = linecache.getline(os.path.join(rec.root, rel), ln) \
            .split("#", 1)[0].strip()
        site = {"site": f"{rel}:{ln}", "per_query": per,
                "static": static.get((rel, ln), "missed"),
                "explicit": bool(EXPLICIT_CROSSING.search(code)),
                "host_sync_scope": host_sync.applies_to(rel)}
        sites.append(site)
        log(f"# sync {site['site']}: {per} per query; static engine: "
            f"{site['static']}; "
            f"{'explicit' if site['explicit'] else 'implicit'}"
            f"{'' if site['host_sync_scope'] else ', outside host-sync'}: "
            f"{code[:90]}")
    per_query = {name: sum(p.get(name, 0) for p in rec.counts.values())
                 for name, *_r in plan}
    log(f"# sync totals per query (package frames): {per_query}; with no "
        f"package frame: {rec.outside}; query walls under the debug mode "
        f"{walls} ms")
    if not rec.counts:
        raise AssertionError("no sync recorded: the debug mode proved "
                             "nothing")
    gaps = [s["site"] for s in sites if s["explicit"]
            and s["host_sync_scope"] and s["static"] == "missed"]
    if gaps:
        raise AssertionError(f"explicit syncs the static engine misses: "
                             f"{gaps}")
    return {"ok": rep.ok, "rule_totals": dict(sorted(
                rep.rule_totals.items())),
            "findings": len(rep.findings), "wall_ms": rep.wall_ms,
            "runtime_sites": len(sites),
            "seen": sum(s["static"] != "missed" for s in sites),
            "implicit": sum(not s["explicit"] for s in sites),
            "syncs_per_query": per_query, "outside_package": rec.outside,
            "sites": sites}


GRAFT_SHARDS = 4


def graft_phase() -> dict:
    """Step 5c: the port's graft entry points on the card, K1/K2 counts
    zeroed just before and read just after. `entry()`'s flagship step on
    its example batch against the plain numpy version (count, min, max,
    first and last bit for bit, the sum within rtol 1e-12), then
    `dryrun_multichip(GRAFT_SHARDS)`: the mesh aggregate and three SQL
    shapes over GRAFT_SHARDS shards on the cards in turn, each held to
    its oracle inside the call. → the phase's JSON."""
    import torch

    from cnosdb_tpu_torch import graft_entry
    from cnosdb_tpu_torch.ops import device_decode as dd
    from cnosdb_tpu_torch.ops import pallas_kernels as pk
    from cnosdb_tpu_torch.ops.kernels import numpy_segment_partials

    names = ("count", "sum", "min", "max", "first", "last")
    pk.launches = 0
    dd.xor_launches = 0
    t = time.perf_counter()
    fn, args = graft_entry.entry()
    out = fn(*args)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t
    where = {str(a.device) for a in args} | {str(o.device) for o in out}
    if where != {"cuda:0"}:
        raise AssertionError(f"entry() ran on {where}, not the card")
    got = dict(zip(names, (o.cpu().numpy() for o in out)))
    plain = numpy_segment_partials(
        *(a.cpu().numpy() for a in args), graft_entry.N_SEGMENTS,
        wants={f"want_{k}": True for k in names})
    for k in names:
        if k == "sum":
            np.testing.assert_allclose(got[k], plain[k], rtol=1e-12)
        else:
            np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
    err = float(np.abs(got["sum"] - plain["sum"]).max())
    t = time.perf_counter()
    run = graft_entry.dryrun_multichip(GRAFT_SHARDS)
    dryrun_s = time.perf_counter() - t
    line = run["line"]
    if line["device"] != "cuda" or line["vnodes"] != GRAFT_SHARDS:
        raise AssertionError(f"dryrun_multichip: {line}")
    launches = {"K1": pk.launches, "K2": dd.xor_launches}
    entry_ms = cuda_ms(lambda: fn(*args))
    res = {"entry_s": entry_s, "entry_ms": entry_ms,
           "entry_max_abs_err": err, "dryrun_s": dryrun_s,
           "kernel_s": line["kernel_s"], "sql_s": line["sql_s"],
           "shards": GRAFT_SHARDS, "cards": line["cards"],
           "vnodes": line["vnodes"], "launches": launches}
    log(f"# graft: entry() on the card {entry_s:.3f}s for its first call "
        f"({entry_ms:.4f} ms a call after), its 6 outputs against the "
        f"plain version (max |sum - plain| {err:.3g}; the rest exact); "
        f"dryrun_multichip({GRAFT_SHARDS}) over {line['cards']} card(s) in "
        f"{dryrun_s:.2f}s (kernel leg {line['kernel_s']:.3f}s, 3 SQL "
        f"shapes {line['sql_s']:.3f}s over {line['vnodes']} vnodes), every "
        f"answer against its oracle; K1 +{launches['K1']}, K2 "
        f"+{launches['K2']}")
    print(json.dumps({"graft": res}), flush=True)
    return res


def sqllogic_phase() -> dict:
    """Step 5d: both SQL golden corpora (tests/sqllogic/ and
    tests/sqllogic_ref/, run by tests/sqllogic_port.py) through the port
    on the card, every statement through QueryExecutor.execute_one with no
    forcing env (the device branch is the default here), each file over a
    fresh data directory. Every statement gives its golden answer or,
    where the reference package is recorded wrong on its device branch
    (tests/sqllogic_ref_faults.json), the reference's answer; any other
    answer fails the phase. X2/K1/K2/X4 counts zeroed just before and read
    just after. → the phase's JSON."""
    sys.path.insert(0, os.path.join(REPO_DIR, "tests"))
    import sqllogic_port as slt

    from cnosdb_tpu_torch.ops import device_decode as dd
    from cnosdb_tpu_torch.ops import fused, kernels
    from cnosdb_tpu_torch.ops import pallas_kernels as pk

    faults = slt.load_faults()
    fused.launch_count = 0
    pk.launches = 0
    dd.xor_launches = 0
    kernels.x4_launches.clear()
    corpora, matched, off = {}, {}, []
    t = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_slt_")
    try:
        for corpus in slt.CORPORA:
            c = corpora[corpus] = {"files": 0, "files_passed": 0,
                                   "statements": 0, "passed": 0}
            for name in slt.corpus_files(corpus):
                d = tempfile.mkdtemp(dir=root)
                recs = slt.run_file(corpus, name, d)
                shutil.rmtree(d, ignore_errors=True)
                passed, keys, bad = slt.judge(recs, corpus, name, "device",
                                              faults)
                c["files"] += 1
                c["files_passed"] += not bad
                c["statements"] += len(recs)
                c["passed"] += passed
                off += bad
                for key in keys:
                    f, line = key.rsplit(":", 1)
                    matched.setdefault(f, []).append(int(line))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _sync()
    secs = time.perf_counter() - t
    launches = {"X2": fused.launch_count, "K1": pk.launches,
                "K2": dd.xor_launches,
                "X4": sum(kernels.x4_launches.values()),
                "X4_ops": dict(kernels.x4_launches)}
    res = {"corpora": corpora, "seconds": secs, "launches": launches,
           "reference_faults_matched": matched,
           "n_reference_faults_matched": sum(map(len, matched.values()))}
    log(f"# sqllogic: {secs:.2f}s; "
        + "; ".join(f"{k} {v['files_passed']}/{v['files']} files, "
                    f"{v['passed']}/{v['statements']} statements"
                    for k, v in corpora.items())
        + f"; {res['n_reference_faults_matched']} gave the reference's "
        f"recorded answer; X2 +{launches['X2']}, K1 +{launches['K1']}, "
        f"K2 +{launches['K2']}, X4 +{launches['X4']}")
    for line in off:
        log("# sqllogic off its rule: " + line)
    print(json.dumps({"sqllogic": res}), flush=True)
    if off:
        raise AssertionError(f"{len(off)} corpus statements off their rule")
    # the device branch answers as the host branch: a statement the
    # reference answers wrong on its device branch only is golden here
    device_only = sorted(f"{f}:{ln}" for f, lines in matched.items()
                         for ln in lines if "host" not in faults[f"{f}:{ln}"])
    if device_only:
        raise AssertionError(f"device-only reference faults not golden: "
                             f"{device_only}")
    if res["n_reference_faults_matched"] > 190:
        raise AssertionError(f"{res['n_reference_faults_matched']} "
                             "statements at the reference's answer, over 190")
    if launches["X2"] <= 0:
        raise AssertionError("the corpora never launched the fused program")
    return res


# ---------------------------------------------------------------- semantics
# Step 5e: the device branch answers as the host branch, at size. The
# compressed-domain lane would answer an unfiltered aggregate of flushed
# pages from their statistics: off here, so that X2 answers it.
SEM_ENV = {"CNOSDB_COMPRESSED_DOMAIN": "0"}
SEM_T = 400_000_000_000           # bytes_recv / drop_in below this
# 20,000 points a host, so that each host's byte counters sum past 2^53
SEM_ROWS = 2_000_000


class NetData:
    """TSBS devops `net`-shaped columns (per-host BIGINT byte and packet
    counters, one point every 10 s), host-major, from --seed. bytes_recv
    and bytes_sent are drawn so that each host's sum passes 2^53 and stays
    under 2^63; packets_recv holds values above 2^62 (min and max only);
    drop_in (BIGINT, 0-7: zero divisors) and err_rate (DOUBLE) are NULL in
    about 10 % of the rows each."""

    def __init__(self, seed: int, rows: int):
        self.per_host = per = max(1, rows // N_HOSTS)
        rng = np.random.default_rng(seed + 5)
        lo = max(2**40, -(-(2**54) // per))
        shape = (N_HOSTS, per)
        self.recv = rng.integers(lo, 2 * lo, shape, dtype=np.int64)
        self.sent = rng.integers(lo, 2 * lo, shape, dtype=np.int64)
        self.packets = rng.integers(2**62, 2**63 - 1, shape, dtype=np.int64)
        self.drop = rng.integers(0, 8, shape, dtype=np.int64)
        self.drop_ok = rng.random(shape) >= 0.1
        self.err = np.round(rng.uniform(0, 3, shape), 3)
        self.err_ok = rng.random(shape) >= 0.1
        self.ts = BASE_TS + np.arange(per, dtype=np.int64) * INTERVAL_NS
        self.rows = N_HOSTS * per


def net_ingest(coord, nd: NetData) -> float:
    """Write `nd` as table `net`; a nullable field is written at its
    non-NULL rows only. Flushed and compacted. → seconds."""
    from cnosdb_tpu_torch.models.points import SeriesRows, WriteBatch
    from cnosdb_tpu_torch.models.schema import ValueType
    from cnosdb_tpu_torch.models.series import SeriesKey
    from cnosdb_tpu_torch.parallel.meta import DEFAULT_TENANT

    i64, f64 = int(ValueType.INTEGER), int(ValueType.FLOAT)
    t0 = time.perf_counter()

    def load_host(h):
        key = SeriesKey("net", {"hostname": f"host_{h:03d}"})
        for off in range(0, nd.per_host, CHUNK):
            e = min(off + CHUNK, nd.per_host)
            ts = nd.ts[off:e]
            parts = [(ts, {"bytes_recv": (i64, nd.recv[h, off:e]),
                           "bytes_sent": (i64, nd.sent[h, off:e]),
                           "packets_recv": (i64, nd.packets[h, off:e])})]
            for name, vt, vals, ok in (("drop_in", i64, nd.drop, nd.drop_ok),
                                       ("err_rate", f64, nd.err, nd.err_ok)):
                m = ok[h, off:e]
                parts.append((ts[m], {name: (vt, vals[h, off:e][m])}))
            for part_ts, fields in parts:
                wb = WriteBatch()
                wb.add_series("net", SeriesRows(key, part_ts, fields))
                coord.write_points(DEFAULT_TENANT, "public", wb)

    with ThreadPoolExecutor(max_workers=LOAD_WORKERS) as pool:
        list(pool.map(load_host, range(N_HOSTS)))
    coord.engine.flush_all()
    coord.engine.compact_all()
    return time.perf_counter() - t0


def semantics_queries(nd: NetData) -> list:
    """[(name, sql, want, route)]: `want` the oracle's answer from the
    generated arrays (Python ints for the int64 aggregates); `route` the
    path that must take the query: "X2" or "K1" (its launches rise),
    "mesh" (the lane engages) or "host" (a TAGS aggregate, which X2
    declines: its launches stay). The x/0 query counts the rows below a
    bound, so an x/0 that gave 0 in place of NULL would be counted."""
    d, dk, e, ek = nd.drop, nd.drop_ok, nd.err, nd.err_ok
    per_host = [(f"host_{h:03d}", sum(nd.recv[h].tolist()),
                 sum(nd.sent[h].tolist()), int(nd.packets[h].min()),
                 int(nd.packets[h].max())) for h in range(N_HOSTS)]
    by_host = ("SELECT hostname, sum(bytes_recv) AS r, sum(bytes_sent) AS "
               "s, min(packets_recv) AS lo, max(packets_recv) AS hi FROM net "
               "GROUP BY hostname")
    safe = np.where(d == 0, 1, d)
    mid = nd.per_host // 2
    w_lo = int(nd.ts[mid])
    w_hi = int(nd.ts[min(nd.per_host - 1, mid + 4320)])
    hosts = list(range(0, 64, 8))
    win = (nd.ts >= w_lo) & (nd.ts <= w_hi)
    bucket = (nd.ts[win] - BASE_TS) // BUCKET_NS
    windowed = []
    for b in np.unique(bucket):
        sel = np.flatnonzero(win)[bucket == b]
        r = nd.recv[hosts][:, sel]
        p = nd.packets[hosts][:, sel]
        windowed.append((int(BASE_TS + b * BUCKET_NS), sum(r.ravel().tolist()),
                         int(p.min()), int(p.max())))
    in_list = ", ".join(f"'host_{h:03d}'" for h in hosts)

    def count(m):
        return [(int(m.sum()),)]

    return [
        ("int64 sum/min/max by host", by_host, per_host, "X2"),
        ("OR across NULLs",
         "SELECT count(*) AS c FROM net WHERE drop_in > 5 OR err_rate > 2.5",
         count((dk & (d > 5)) | (ek & (e > 2.5))), "X2"),
        ("NOT across NULLs",
         "SELECT count(*) AS c FROM net WHERE NOT (drop_in > 5 AND "
         "err_rate < 0.5)", count((dk & (d <= 5)) | (ek & (e >= 0.5))), "X2"),
        ("NOT IN with a NULL",
         "SELECT count(*) AS c FROM net WHERE drop_in NOT IN (1, 2, NULL)",
         [(0,)], "X2"),
        ("NOT IN without it",
         "SELECT count(*) AS c FROM net WHERE drop_in NOT IN (1, 2)",
         count(dk & (d != 1) & (d != 2)), "X2"),
        ("integer x/0",
         f"SELECT count(*) AS c FROM net WHERE bytes_recv / drop_in < {SEM_T}",
         count(dk & (d != 0) & (nd.recv // safe < SEM_T)), "X2"),
        ("CAST",
         "SELECT count(*) AS c FROM net WHERE CAST(err_rate AS BIGINT) >= 2",
         count(ek & (np.trunc(e) >= 2)), "X2"),
        ("TAGS aggregate",
         "SELECT count(hostname) AS c FROM net WHERE err_rate > 1.0",
         count(ek & (e > 1.0)), "host"),
        ("int64 window (K1's shape)",
         "SELECT date_bin(INTERVAL '1 hour', time) AS t, sum(bytes_recv) AS "
         "r, min(packets_recv) AS lo, max(packets_recv) AS hi FROM net WHERE "
         f"hostname IN ({in_list}) AND time >= {w_lo} AND time <= {w_hi} "
         "GROUP BY t", windowed, "K1"),
        ("int64 sum/min/max by host, mesh lane", by_host, per_host, "mesh"),
    ]


def _rows_of(rs) -> list:
    """The result's rows as tuples of Python values, sorted."""
    cols = [[x.item() if hasattr(x, "item") else x for x in c]
            for c in rs.columns]
    return sorted(zip(*cols))


def semantics_phase(seed: int, rows: int) -> dict:
    """Step 5e: the table `net` (NetData, `rows` rows from --seed) in
    a data directory of its own; every query of semantics_queries through
    QueryExecutor.execute_one with no forcing env, each answer equal to
    its oracle, X2 launched for each query routed "X2", K1's and the mesh
    lane's answers to the int64 aggregates exact too. X2/K1 counts zeroed
    just before and read just after. → the phase's JSON."""
    from cnosdb_tpu_torch.ops import fused
    from cnosdb_tpu_torch.ops import pallas_kernels as pk
    from cnosdb_tpu_torch.parallel import mesh
    from cnosdb_tpu_torch.parallel.coordinator import Coordinator
    from cnosdb_tpu_torch.parallel.meta import MetaStore
    from cnosdb_tpu_torch.sql.executor import QueryExecutor, Session
    from cnosdb_tpu_torch.storage.engine import TsKv

    t_phase = time.perf_counter()
    nd = NetData(seed, rows)
    root = tempfile.mkdtemp(prefix="chip_smoke_sem_")
    saved = {k: os.environ.get(k)
             for k in {*SEM_ENV, *MESH_KNOBS, "CNOSDB_MESH_DEVICES"}}
    os.environ.update(SEM_ENV)
    coord = None
    try:
        meta = MetaStore(os.path.join(root, "meta.json"))
        coord = Coordinator(meta, TsKv(os.path.join(root, "data")))
        ex = QueryExecutor(meta, coord)
        s = Session(database="public")
        ex.execute_one(f"ALTER DATABASE public SET SHARD {SHARDS}", s)
        ingest_s = net_ingest(coord, nd)
        queries = semantics_queries(nd)
        fused.launch_count = 0
        pk.launches = 0
        mesh.reset_counters()
        t = time.perf_counter()
        out = []
        for name, sql, want, route in queries:
            if route == "mesh":
                os.environ.update(MESH_KNOBS)
                os.environ["CNOSDB_MESH_DEVICES"] = "1"
            x2, k1 = fused.launch_count, pk.launches
            before = mesh.outcomes_snapshot()
            q0 = time.perf_counter()
            rs = ex.execute_one(sql, s)
            _sync()
            ms = (time.perf_counter() - q0) * 1e3
            got = _rows_of(rs)
            if got != sorted(want):
                bad = next((g, w) for g, w in zip(got, sorted(want))
                           if g != w) if len(got) == len(want) else \
                    (len(got), len(want))
                raise AssertionError(f"semantics {name}: {bad} against the "
                                     "oracle")
            d_x2, d_k1 = fused.launch_count - x2, pk.launches - k1
            engaged = mesh.outcomes_snapshot().get(("exec", "engaged"), 0) \
                - before.get(("exec", "engaged"), 0)
            if route == "X2" and d_x2 <= 0:
                raise AssertionError(f"semantics {name}: X2 did not launch")
            if route == "K1" and d_k1 <= 0:
                raise AssertionError(f"semantics {name}: K1 did not launch")
            if route == "host" and d_x2 != 0:
                raise AssertionError(f"semantics {name}: X2 launched {d_x2} "
                                     "times for a query it must decline")
            if route == "mesh" and engaged <= 0:
                raise AssertionError(f"semantics {name}: the mesh lane did "
                                     "not engage")
            out.append({"name": name, "ms": ms, "rows": len(got),
                        "X2": d_x2, "K1": d_k1, "mesh": engaged})
            log(f"# semantics {name}: {ms:.1f} ms, {len(got)} rows equal "
                f"to the oracle, X2 +{d_x2}, K1 +{d_k1}, mesh +{engaged}")
        secs = time.perf_counter() - t
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if coord is not None:
            coord.close()
        shutil.rmtree(root, ignore_errors=True)
    res = {"rows": nd.rows, "ingest_s": ingest_s, "queries_s": secs,
           "seconds": time.perf_counter() - t_phase,
           "launches": {"X2": fused.launch_count, "K1": pk.launches},
           "queries": out}
    log(f"# semantics phase: {res['seconds']:.2f}s ({nd.rows} rows, ingest "
        f"{ingest_s:.2f}s, {len(out)} queries {secs:.2f}s); X2 "
        f"+{fused.launch_count}, K1 +{pk.launches}")
    print(json.dumps({"semantics": res}), flush=True)
    return res


# ---------------------------------------------------------------- ClickBench
# The hits table and the 43 queries of bench_suites.py (build_hits,
# run_clickbench), with the port's imports and the seed from --seed. The
# oracles are the same checks over the generated arrays, vectorized with
# numpy (dense codes in place of per-row Python sets) so they finish at
# ten million rows.
DAY_NS = 86_400_000_000_000
HITS_CHUNK = 250_000
HOST_ROUTE = {"CNOSDB_TPU_GROUP_AGG": "0", "CNOSDB_TPU_TOPK": "0"}


def build_hits(coord, seed: int, n_rows: int) -> dict:
    """The ClickBench-shaped hits table (18 BIGINT and 5 STRING fields,
    one series), written through Coordinator.write_points, flushed and
    compacted. → the columns as arrays (the oracle's input), strings as
    object arrays, plus "_codes": each string column's dense codes and
    sorted dictionary."""
    from cnosdb_tpu_torch.models.points import SeriesRows, WriteBatch
    from cnosdb_tpu_torch.models.schema import ValueType
    from cnosdb_tpu_torch.models.series import SeriesKey
    from cnosdb_tpu_torch.parallel.meta import DEFAULT_TENANT

    rng = np.random.default_rng(seed)
    n = n_rows
    phrases = np.array([""] * 4 + [f"phrase {i}" for i in range(60)],
                       dtype=object)
    urls = np.array([f"http://site{i % 7}.test/p/{i}"
                     for i in range(500)] + [
                    f"http://google.test/q/{i}" for i in range(20)],
                    dtype=object)
    titles = np.array([f"Title {i}" for i in range(200)] + [
                      f"Google Result {i}" for i in range(8)],
                      dtype=object)
    referers = np.array([""] * 3 + [
        f"https://www.ref{i % 9}.test/path/{i}" for i in range(80)],
        dtype=object)
    models = np.array([""] * 5 + [f"model-{i}" for i in range(12)],
                      dtype=object)

    cols = {
        "adv_engine_id": rng.integers(0, 5, n) * (rng.random(n) < 0.2),
        "resolution_width": rng.integers(800, 2600, n),
        "user_id": rng.integers(0, n // 20 + 2, n),
        "region_id": rng.integers(0, 40, n),
        "mobile_phone": rng.integers(0, 6, n),
        "search_engine_id": rng.integers(0, 4, n),
        "counter_id": rng.integers(0, 100, n),
        "client_ip": rng.integers(1 << 20, 1 << 28, n),
        "watch_id": rng.integers(0, n // 3 + 2, n),
        "is_refresh": (rng.random(n) < 0.1).astype(np.int64),
        "trafic_source_id": rng.integers(-1, 8, n),
        "is_link": (rng.random(n) < 0.3).astype(np.int64),
        "is_download": (rng.random(n) < 0.05).astype(np.int64),
        "dont_count_hits": (rng.random(n) < 0.05).astype(np.int64),
        "url_hash": rng.integers(0, 50, n),
        "referer_hash": rng.integers(0, 50, n),
        "window_client_width": rng.integers(300, 2000, n),
        "window_client_height": rng.integers(300, 1400, n),
    }
    sidx = {
        "search_phrase": rng.integers(0, len(phrases), n),
        "url": rng.integers(0, len(urls), n),
        "title": rng.integers(0, len(titles), n),
        "referer": rng.integers(0, len(referers), n),
        "mobile_phone_model": rng.integers(0, len(models), n),
    }
    sdata = {"search_phrase": phrases, "url": urls, "title": titles,
             "referer": referers, "mobile_phone_model": models}
    ts = BASE_TS + rng.integers(0, 30 * DAY_NS // 1000, n).astype(
        np.int64) * 1000
    ts.sort()
    # one series keeps one point per timestamp (the last write wins), and
    # from a few million rows on the draws repeat: move each repeat 1 us
    # past its predecessor so that every generated row is stored
    step = np.arange(n, dtype=np.int64) * 1000
    ts = np.maximum.accumulate(ts - step) + step
    key = SeriesKey("hits", {"site": "s0"})
    for off in range(0, n, HITS_CHUNK):
        e = min(off + HITS_CHUNK, n)
        fields = {}
        for name, arr in cols.items():
            fields[name] = (int(ValueType.INTEGER),
                            arr[off:e].astype(np.int64))
        for name, idx in sidx.items():
            fields[name] = (int(ValueType.STRING),
                            list(sdata[name][idx[off:e]]))
        wb = WriteBatch()
        wb.add_series("hits", SeriesRows(key, ts[off:e], fields))
        coord.write_points(DEFAULT_TENANT, "public", wb)
    coord.engine.flush_all()
    coord.engine.compact_all()
    out = {k: v.astype(np.int64) for k, v in cols.items()}
    out.update({k: sdata[k][v] for k, v in sidx.items()})
    out["time"] = ts
    codes = {}
    for k, v in sidx.items():
        uniq, inv = np.unique(sdata[k].astype(str), return_inverse=True)
        codes[k] = (inv.astype(np.int64)[v], uniq)
    out["_codes"] = codes
    return out


def _dense(a: dict, codes: dict, key) -> tuple[np.ndarray, int]:
    """A key column (a column name or an array) → dense int64 codes and
    their count."""
    if isinstance(key, str) and key in codes:
        c, uniq = codes[key]
        return c, len(uniq)
    arr = a[key] if isinstance(key, str) else key
    uniq, inv = np.unique(arr, return_inverse=True)
    return inv.astype(np.int64).ravel(), len(uniq)


def hits_statements(a: dict) -> tuple[list, list]:
    """The 43 ClickBench queries of bench_suites.run_clickbench over the
    hits arrays `a` (as build_hits returns them, "_codes" included), and
    the three route probes below → two lists of (name, sql, check or
    None); each check raises AssertionError when the ResultSet disagrees
    with its numpy oracle."""
    n = len(a["time"])
    codes = a["_codes"]

    def unique_mask(column, pred):
        """Row mask of a per-string predicate, evaluated once a unique."""
        c, uniq = codes[column]
        return np.array([pred(u) for u in uniq.tolist()], dtype=bool)[c]

    def col(rs, name):
        return rs.columns[rs.names.index(name)]

    def scalar_eq(val):
        def chk(rs):
            got = rs.columns[0][0]
            if isinstance(val, float):
                np.testing.assert_allclose(float(got), val, rtol=1e-9)
            else:
                assert int(got) == int(val), (got, val)
        return chk

    def topk_col(colname, want_sorted):
        def chk(rs):
            got = np.sort(np.asarray(col(rs, colname), dtype=np.float64))
            np.testing.assert_allclose(got, np.sort(want_sorted),
                                       rtol=1e-9)
        return chk

    def rows_eq(k):
        def chk(rs):
            assert rs.n_rows == k, (rs.n_rows, k)
        return chk

    def key_codes(keys, sel):
        combo, dim = np.zeros(int(sel.sum()), dtype=np.int64), 1
        for key in keys:
            c, card = _dense(a, codes, key)
            combo = combo * card + c[sel]
            dim *= card
        assert dim < 2 ** 62
        return combo

    def topc(keys, k=10, sel=None):
        """Top-k counts per composite key → sorted count list."""
        sel = np.ones(n, dtype=bool) if sel is None else sel
        _u, cnt = np.unique(key_codes(keys, sel), return_counts=True)
        return np.sort(cnt)[::-1][:k].astype(np.float64)

    def distinct_per_key(keys, sel=None, k=10):
        """Top-k count(DISTINCT user_id) per composite key."""
        sel = np.ones(n, dtype=bool) if sel is None else sel
        nv = int(uid.max()) + 1
        pairs = np.unique(key_codes(keys, sel) * nv + uid[sel])
        _u, cnt = np.unique(pairs // nv, return_counts=True)
        return np.sort(cnt)[::-1][:k].astype(np.float64)

    adv = a["adv_engine_id"]
    rw = a["resolution_width"]
    uid = a["user_id"]
    sp_c = codes["search_phrase"][0]
    sm = unique_mask("search_phrase", lambda s: s != "")
    um = unique_mask("url", lambda s: s != "")
    gm = unique_mask("url", lambda s: "google" in s)
    mm = unique_mask("mobile_phone_model", lambda s: s != "")
    q = []
    q.append(("q01", "SELECT count(*) FROM hits", scalar_eq(n)))
    q.append(("q02", "SELECT count(*) FROM hits WHERE adv_engine_id <> 0",
              scalar_eq(int((adv != 0).sum()))))
    q.append(("q03", "SELECT sum(adv_engine_id), count(*), "
              "avg(resolution_width) FROM hits",
              scalar_eq(int(adv.sum()))))
    q.append(("q04", "SELECT avg(user_id) FROM hits",
              lambda rs: np.testing.assert_allclose(
                  float(rs.columns[0][0]), uid.mean(), rtol=1e-9)))
    q.append(("q05", "SELECT count(DISTINCT user_id) FROM hits",
              scalar_eq(len(np.unique(uid)))))
    q.append(("q06", "SELECT count(DISTINCT search_phrase) FROM hits",
              scalar_eq(len(np.unique(sp_c)))))
    q.append(("q07", "SELECT min(time), max(time) FROM hits",
              scalar_eq(int(a["time"].min()))))
    adv_counts = np.bincount(adv[adv != 0])
    q.append(("q08", "SELECT adv_engine_id, count(*) AS c FROM hits "
              "WHERE adv_engine_id <> 0 GROUP BY adv_engine_id "
              "ORDER BY c DESC",
              topk_col("c", np.sort(adv_counts[adv_counts > 0])[::-1]
                       .astype(np.float64))))
    q.append(("q09", "SELECT region_id, count(DISTINCT user_id) AS u "
              "FROM hits GROUP BY region_id ORDER BY u DESC LIMIT 10",
              topk_col("u", distinct_per_key(["region_id"]))))
    q.append(("q10", "SELECT region_id, sum(adv_engine_id), count(*) AS "
              "c, avg(resolution_width), count(DISTINCT user_id) FROM "
              "hits GROUP BY region_id ORDER BY c DESC LIMIT 10",
              topk_col("c", topc(["region_id"]))))
    q.append(("q11", "SELECT mobile_phone_model, count(DISTINCT user_id)"
              " AS u FROM hits WHERE mobile_phone_model <> '' GROUP BY "
              "mobile_phone_model ORDER BY u DESC LIMIT 10",
              topk_col("u", distinct_per_key(["mobile_phone_model"], mm))))
    q.append(("q12", "SELECT mobile_phone, mobile_phone_model, "
              "count(DISTINCT user_id) AS u FROM hits WHERE "
              "mobile_phone_model <> '' GROUP BY mobile_phone, "
              "mobile_phone_model ORDER BY u DESC LIMIT 10",
              topk_col("u", distinct_per_key(
                  ["mobile_phone", "mobile_phone_model"], mm))))
    q.append(("q13", "SELECT search_phrase, count(*) AS c FROM hits "
              "WHERE search_phrase <> '' GROUP BY search_phrase "
              "ORDER BY c DESC LIMIT 10",
              topk_col("c", topc(["search_phrase"], sel=sm))))
    q.append(("q14", "SELECT search_phrase, count(DISTINCT user_id) AS u"
              " FROM hits WHERE search_phrase <> '' GROUP BY "
              "search_phrase ORDER BY u DESC LIMIT 10",
              topk_col("u", distinct_per_key(["search_phrase"], sm))))
    q.append(("q15", "SELECT search_engine_id, search_phrase, count(*) "
              "AS c FROM hits WHERE search_phrase <> '' GROUP BY "
              "search_engine_id, search_phrase ORDER BY c DESC LIMIT 10",
              topk_col("c", topc(["search_engine_id", "search_phrase"],
                                 sel=sm))))
    q.append(("q16", "SELECT user_id, count(*) AS c FROM hits GROUP BY "
              "user_id ORDER BY c DESC LIMIT 10",
              topk_col("c", topc(["user_id"]))))
    q.append(("q17", "SELECT user_id, search_phrase, count(*) AS c FROM "
              "hits GROUP BY user_id, search_phrase ORDER BY c DESC "
              "LIMIT 10", topk_col("c", topc(["user_id", "search_phrase"]))))
    q.append(("q18", "SELECT user_id, search_phrase, count(*) AS c FROM "
              "hits GROUP BY user_id, search_phrase LIMIT 10",
              rows_eq(10)))
    q.append(("q19", "SELECT user_id, date_part('minute', time) AS m, "
              "search_phrase, count(*) AS c FROM hits GROUP BY user_id, "
              "m, search_phrase ORDER BY c DESC LIMIT 10",
              topk_col("c", topc(
                  ["user_id", (a["time"] // 60_000_000_000) % 60,
                   "search_phrase"]))))
    some_uid = int(uid[0])
    q.append(("q20", f"SELECT user_id FROM hits WHERE user_id = "
              f"{some_uid}", rows_eq(int((uid == some_uid).sum()))))
    q.append(("q21", "SELECT count(*) FROM hits WHERE url LIKE "
              "'%google%'", scalar_eq(int(gm.sum()))))
    q.append(("q22", "SELECT search_phrase, min(url), count(*) AS c "
              "FROM hits WHERE url LIKE '%google%' AND search_phrase <> "
              "'' GROUP BY search_phrase ORDER BY c DESC LIMIT 10",
              topk_col("c", topc(["search_phrase"], sel=gm & sm))))
    tmask = unique_mask("title", lambda t: "Google" in t) \
        & ~unique_mask("url", lambda u: ".google." in u) & sm
    q.append(("q23", "SELECT search_phrase, min(url), min(title), "
              "count(*) AS c, count(DISTINCT user_id) FROM hits WHERE "
              "title LIKE '%Google%' AND url NOT LIKE '%.google.%' AND "
              "search_phrase <> '' GROUP BY search_phrase ORDER BY c "
              "DESC LIMIT 10", topk_col("c", topc(["search_phrase"],
                                                  sel=tmask))))
    q.append(("q24", "SELECT * FROM hits WHERE url LIKE '%google%' "
              "ORDER BY time LIMIT 10",
              rows_eq(min(10, int(gm.sum())))))
    q.append(("q25", "SELECT search_phrase FROM hits WHERE search_phrase"
              " <> '' ORDER BY time LIMIT 10", rows_eq(10)))
    q.append(("q26", "SELECT search_phrase FROM hits WHERE search_phrase"
              " <> '' ORDER BY search_phrase LIMIT 10", rows_eq(10)))
    q.append(("q27", "SELECT search_phrase FROM hits WHERE search_phrase"
              " <> '' ORDER BY time, search_phrase LIMIT 10",
              rows_eq(10)))
    q.append(("q28", "SELECT counter_id, avg(length(url)) AS l, count(*)"
              " AS c FROM hits WHERE url <> '' GROUP BY counter_id "
              "HAVING count(*) > 1000 ORDER BY l DESC LIMIT 25",
              None))
    q.append(("q29", "SELECT regexp_replace(referer, "
              "'^https?://(?:www\\.)?([^/]+)/.*$', '\\1') AS k, "
              "avg(length(referer)) AS l, count(*) AS c, min(referer) "
              "FROM hits WHERE referer <> '' GROUP BY k HAVING count(*) "
              "> 1000 ORDER BY l DESC LIMIT 25", None))
    q.append(("q30", "SELECT " + ", ".join(
        f"sum(resolution_width + {i})" for i in range(0, 90, 30))
        + " FROM hits", scalar_eq(int(rw.sum()))))
    q.append(("q31", "SELECT search_engine_id, client_ip, count(*) AS c,"
              " sum(is_refresh), avg(resolution_width) FROM hits WHERE "
              "search_phrase <> '' GROUP BY search_engine_id, client_ip "
              "ORDER BY c DESC LIMIT 10",
              topk_col("c", topc(["search_engine_id", "client_ip"],
                                 sel=sm))))
    q.append(("q32", "SELECT watch_id, client_ip, count(*) AS c, "
              "sum(is_refresh), avg(resolution_width) FROM hits WHERE "
              "search_phrase <> '' GROUP BY watch_id, client_ip "
              "ORDER BY c DESC LIMIT 10",
              topk_col("c", topc(["watch_id", "client_ip"], sel=sm))))
    q.append(("q33", "SELECT url, count(*) AS c FROM hits GROUP BY url "
              "ORDER BY c DESC LIMIT 10", topk_col("c", topc(["url"]))))
    q.append(("q34", "SELECT 1 AS one, url, count(*) AS c FROM hits "
              "GROUP BY one, url ORDER BY c DESC LIMIT 10",
              topk_col("c", topc(["url"]))))
    q.append(("q35", "SELECT client_ip, client_ip - 1, client_ip - 2, "
              "client_ip - 3, count(*) AS c FROM hits GROUP BY "
              "client_ip, client_ip - 1, client_ip - 2, client_ip - 3 "
              "ORDER BY c DESC LIMIT 10",
              topk_col("c", topc(["client_ip"]))))
    lo = BASE_TS + 5 * DAY_NS
    hi = BASE_TS + 12 * DAY_NS
    range_m = ((a["time"] >= lo) & (a["time"] <= hi)
               & (a["counter_id"] == 62))
    q36m = range_m & (a["dont_count_hits"] == 0) \
        & (a["is_refresh"] == 0) & um
    q.append(("q36", f"SELECT url, count(*) AS pv FROM hits WHERE "
              f"counter_id = 62 AND time >= {lo} AND time <= {hi} AND "
              "dont_count_hits = 0 AND is_refresh = 0 AND url <> '' "
              "GROUP BY url ORDER BY pv DESC LIMIT 10",
              topk_col("pv", topc(["url"], sel=q36m))))
    q37m = range_m & (a["dont_count_hits"] == 0) & (a["is_refresh"] == 0)
    q.append(("q37", f"SELECT title, count(*) AS pv FROM hits WHERE "
              f"counter_id = 62 AND time >= {lo} AND time <= {hi} AND "
              "dont_count_hits = 0 AND is_refresh = 0 AND title <> '' "
              "GROUP BY title ORDER BY pv DESC LIMIT 10",
              topk_col("pv", topc(["title"], sel=q37m))))
    q.append(("q38", f"SELECT url, count(*) AS pv FROM hits WHERE "
              f"counter_id = 62 AND time >= {lo} AND time <= {hi} AND "
              "is_refresh = 0 AND is_link <> 0 AND is_download = 0 "
              "GROUP BY url ORDER BY pv DESC LIMIT 10 OFFSET 100",
              None))
    q.append(("q39", "SELECT trafic_source_id, search_engine_id, "
              "adv_engine_id, CASE WHEN (search_engine_id = 0 AND "
              "adv_engine_id = 0) THEN referer ELSE '' END AS src, url "
              f"AS dst, count(*) AS pv FROM hits WHERE counter_id = 62 "
              f"AND time >= {lo} AND time <= {hi} AND is_refresh = 0 "
              "GROUP BY trafic_source_id, search_engine_id, "
              "adv_engine_id, src, dst ORDER BY pv DESC LIMIT 10 "
              "OFFSET 100", None))
    q.append(("q40", f"SELECT url_hash, date_bin(INTERVAL '24 hours', "
              f"time) AS d, count(*) AS pv FROM hits WHERE counter_id = "
              f"62 AND time >= {lo} AND time <= {hi} AND is_refresh = 0 "
              "AND trafic_source_id IN (-1, 6) AND referer_hash = 33 "
              "GROUP BY url_hash, d ORDER BY pv DESC LIMIT 10 OFFSET 10",
              None))
    q.append(("q41", f"SELECT window_client_width, window_client_height,"
              f" count(*) AS pv FROM hits WHERE counter_id = 62 AND "
              f"time >= {lo} AND time <= {hi} AND is_refresh = 0 AND "
              "dont_count_hits = 0 AND url_hash = 22 GROUP BY "
              "window_client_width, window_client_height ORDER BY pv "
              "DESC LIMIT 10 OFFSET 100", None))
    q.append(("q42", "SELECT date_trunc('minute', time) AS m, count(*) "
              f"AS pv FROM hits WHERE counter_id = 62 AND time >= "
              f"{BASE_TS + 7 * DAY_NS} AND time <= "
              f"{BASE_TS + 9 * DAY_NS} AND is_refresh = 0 AND "
              "dont_count_hits = 0 GROUP BY m ORDER BY m LIMIT 10 "
              "OFFSET 10", None))
    q.append(("q43", "SELECT count(*) FROM hits WHERE time >= "
              f"{BASE_TS + 7 * DAY_NS} AND time <= "
              f"{BASE_TS + 9 * DAY_NS}",
              scalar_eq(int(((a["time"] >= BASE_TS + 7 * DAY_NS)
                             & (a["time"] <= BASE_TS + 9 * DAY_NS))
                            .sum()))))
    # The route probes: synthetic statements, not ClickBench traffic (q05
    # and q09 over a derived table). No hits query reaches the device
    # DISTINCT: a single-table scan aggregate merges count(DISTINCT) per
    # scan batch on the host (executor._merge_distinct_vec, in both
    # packages); only the relational engine's group_agg.distinct_count has
    # the X4 route, and the probes exist to drive it. q05d and q09d take
    # all rows past the 4,194,304-row chunk from 4.5 M rows up
    # (sorted_pair_codes per chunk, then merge_distinct_pairs); q09s's
    # region_id < 15 is a cut chosen to keep its 37.5 % of the rows in
    # one chunk up to 11 M rows (segment_distinct_count).
    probes = [
        ("q05d", "SELECT count(DISTINCT user_id) FROM "
         "(SELECT user_id FROM hits) AS t",
         scalar_eq(len(np.unique(uid)))),
        ("q09d", "SELECT region_id, count(DISTINCT user_id) AS u "
         "FROM (SELECT region_id, user_id FROM hits) AS t "
         "GROUP BY region_id ORDER BY u DESC LIMIT 10",
         topk_col("u", distinct_per_key(["region_id"]))),
        ("q09s", "SELECT region_id, count(DISTINCT user_id) AS u "
         "FROM (SELECT region_id, user_id FROM hits WHERE "
         "region_id < 15) AS t GROUP BY region_id ORDER BY u DESC "
         "LIMIT 10",
         topk_col("u", distinct_per_key(["region_id"],
                                        a["region_id"] < 15)))]
    return q, probes


def same_answer(rs, ref, what: str) -> None:
    """The device route's answer against the host route's: the same
    names and rows in the same order; counts and integers exact, floats
    within rtol 1e-12."""
    if list(rs.names) != list(ref.names) or rs.n_rows != ref.n_rows:
        raise AssertionError(f"{what}: {rs.names} x {rs.n_rows} rows, host "
                             f"route {ref.names} x {ref.n_rows}")
    for name, g, w in zip(rs.names, rs.columns, ref.columns):
        g, w = np.asarray(g), np.asarray(w)
        if g.dtype.kind == "f" and w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0,
                                       equal_nan=True, err_msg=name)
        elif g.tolist() != w.tolist():
            raise AssertionError(f"{what}: column {name} differs from the "
                                 "host route's")


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def hits_phase(ex, session, queries: list, probes: list) -> dict:
    """Every hits query, then every route probe, in this process: once
    cold on the default routes, then timed warm on the default routes
    (the X4 device routes on a CUDA scan device), then with
    CNOSDB_TPU_GROUP_AGG and CNOSDB_TPU_TOPK at 0 (the host numpy
    routes). The answers must be identical and pass the oracle; the host
    route must launch no X4 op.
    X4, K1 and K2 counts are zeroed just before and read just after.
    Raises unless segment_distinct_count, sorted_pair_codes and the device
    top-K engaged, with no distinct_device_error. → {"x4": launches,
    "x4_shapes": ..., "K1": n, "K2": n, "K1_shapes": ...,
    "K2_shapes": ...}."""
    from cnosdb_tpu_torch.ops import device_decode as dd
    from cnosdb_tpu_torch.ops import group_agg, kernels
    from cnosdb_tpu_torch.ops import pallas_kernels as pk
    from cnosdb_tpu_torch.utils import stages

    kernels.reset_x4_counts()
    pk.launches = 0
    pk.launch_shapes.clear()
    dd.xor_launches = 0
    dd.xor_launch_shapes.clear()
    ga0 = group_agg.counters_snapshot()
    saved = {k: os.environ.get(k) for k in HOST_ROUTE}
    topk_device = 0
    by_queries = None
    for kind, (name, sql, check) in ([("hits", q) for q in queries]
                                     + [("probe", p) for p in probes]):
        if kind == "probe" and by_queries is None:
            by_queries = _launch_counts()
        x4 = dict(kernels.x4_launches)
        k1, k2 = pk.launches, dd.xor_launches
        # the first run scans and decodes what no earlier query left in
        # the scan cache: both timed routes below then start warm
        cold_qp = stages.QueryProfile()
        t = time.perf_counter()
        with stages.profile_scope(cold_qp):
            cold = ex.execute_one(sql, session)
        _sync()
        cold_ms = (time.perf_counter() - t) * 1e3
        qp = stages.QueryProfile()
        t = time.perf_counter()
        with stages.profile_scope(qp):
            rs = ex.execute_one(sql, session)
        _sync()
        dev_ms = (time.perf_counter() - t) * 1e3
        snap = qp.snapshot()
        x4d = {op: kernels.x4_launches[op] - x4.get(op, 0)
               for op in kernels.x4_launches
               if kernels.x4_launches[op] != x4.get(op, 0)}
        k1d, k2d = pk.launches - k1, dd.xor_launches - k2
        os.environ.update(HOST_ROUTE)
        try:
            x4h = dict(kernels.x4_launches)
            t = time.perf_counter()
            ref = ex.execute_one(sql, session)
            _sync()
            host_ms = (time.perf_counter() - t) * 1e3
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if kernels.x4_launches != x4h:
            raise AssertionError(f"{name}: the host route launched X4 ops")
        same_answer(rs, ref, name)
        same_answer(cold, ref, name + " (cold)")
        if check is not None:
            check(rs)
        paths = {k: v for k, v in snap.items()
                 if k.startswith(("topk.", "distinct_path."))}
        # the LIKE page skip and string lanes act on the cold scan only
        paths.update({k: v for k, v in cold_qp.snapshot().items()
                      if k.startswith(("ngram_", "string_path."))})
        topk_device += snap.get("topk.device", 0)
        log(f"# {kind} {name}: cold {cold_ms:.1f} ms, then device route "
            f"{dev_ms:.1f} ms, host route {host_ms:.1f} ms, {rs.n_rows} "
            "rows, identical"
            f"{', oracle ok' if check is not None else ''}; X4 "
            f"{x4d or '-'}, K1 +{k1d}, K2 +{k2d}, {paths}")
    ga = group_agg.counters_snapshot()
    ga_d = {k: v - ga0.get(k, 0) for k, v in ga.items()
            if v != ga0.get(k, 0)}
    x4_all = dict(kernels.x4_launches)
    of_queries = {k: v for k, v in by_queries.items() if v}
    log(f"# hits phase: {len(queries)} queries launched {of_queries}, then "
        f"{len(probes)} route probes; in all X4 launches {x4_all}; K1 "
        f"{pk.launches} {dict(pk.launch_shapes)}, K2 {dd.xor_launches}; "
        f"group_agg {ga_d}; topk.device {topk_device}")
    for op in ("segment_distinct_count", "sorted_pair_codes"):
        if x4_all.get(op, 0) <= 0:
            raise AssertionError(f"{op} never ran on the hits phase")
    if ga_d.get("distinct_device", 0) <= 0:
        raise AssertionError(f"the device DISTINCT never engaged: {ga_d}")
    if ga_d.get("distinct_device_error", 0):
        raise AssertionError(f"distinct_device_error booked: {ga_d}")
    if topk_device <= 0:
        raise AssertionError("the device top-K never engaged")
    return {"x4": x4_all,
            "x4_shapes": {k: dict(v)
                          for k, v in kernels.x4_launch_shapes.items()},
            "K1": pk.launches, "K2": dd.xor_launches,
            "K1_shapes": dict(pk.launch_shapes),
            "K2_shapes": dict(dd.xor_launch_shapes)}


def _largest(shapes: dict):
    return max(shapes, key=lambda sh: (sh[0], shapes[sh]))


def _twice_bit_exact(name: str, fn, plain) -> None:
    """`fn()` twice against `plain`, bit-exact and bit-stable."""
    got, again = fn(), fn()
    if not np.array_equal(got, plain):
        raise AssertionError(f"{name} differs from its plain version")
    if got.tobytes() != again.tobytes():
        raise AssertionError(f"{name} is not bit-stable")


def compare_x4(run: dict, a: dict, seed: int, dev) -> list:
    """Each X4 op on the card at the largest shape the hits phase gave
    it (seeded inputs of that shape), held against its plain numpy
    version twice: `ms` the device half on inputs already on the card
    (CUDA events), `call_ms` the host wrapper from numpy in to numpy out,
    `upload_ms` the pageable upload of its input, `plain_ms` the plain
    version, `bound_ms` the bytes it must move (each input read once,
    each output written once) over the HBM rate. dict_mask_gather has no
    SQL caller; it runs on the url column's dictionary codes, on the
    card, at the hits row count."""
    import torch

    from cnosdb_tpu_torch.ops import group_agg, kernels

    rng = np.random.default_rng(seed + 4)
    shapes = run["x4_shapes"]
    out = []

    def upload(host):
        def go():
            kernels.to_device(host, dev)
            torch.cuda.synchronize()
        return host_ms(go, iters=5)

    def row(name, shape, ms, call_ms, up_ms, plain_ms, moved):
        out.append({"name": name, "launches": run["x4"].get(name, 0),
                    "shapes": [[list(sh), c] for sh, c in
                               sorted(shapes.get(name, {}).items())],
                    "at": list(shape), "ms": ms, "call_ms": call_ms,
                    "upload_ms": up_ms, "plain_ms": plain_ms,
                    "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes", "bytes": moved})
        log(f"# X4 {name} at {tuple(shape)}: ms {ms:.4f} (device half, "
            f"inputs on the card), call_ms {call_ms} (numpy in, numpy "
            f"out), upload_ms {up_ms} (pageable), plain {plain_ms:.4f} ms, "
            f"bound {moved / HBM_BYTES_PER_S * 1e3:.5f} ms for {moved} B; "
            "bit-exact, bit-stable over two runs")

    n, ns, nv = _largest(shapes["segment_distinct_count"])
    gid = rng.integers(0, ns, n)
    vc = rng.integers(0, nv, n)
    pairs = gid * nv + vc
    plain = np.bincount(group_agg.distinct_pairs(gid, vc, nv) // nv,
                        minlength=ns)
    _twice_bit_exact("segment_distinct_count",
                 lambda: kernels.segment_distinct_count(gid, vc, ns, nv),
                 plain)
    on_card = kernels.to_device(pairs, dev)
    row("segment_distinct_count", (n, ns, nv),
        cuda_ms(lambda: kernels.distinct_counts(on_card, nv, ns), iters=5),
        host_ms(lambda: kernels.segment_distinct_count(gid, vc, ns, nv),
                iters=3), upload(pairs),
        host_ms(lambda: np.bincount(group_agg.distinct_pairs(gid, vc, nv)
                                    // nv, minlength=ns), iters=3),
        n * 8 + ns * 8)

    n, nv = _largest(shapes["sorted_pair_codes"])
    gid = np.zeros(n, dtype=np.int64)     # the all-rows DISTINCT: 1 group
    vc = rng.integers(0, nv, n)
    plain = group_agg.distinct_pairs(gid, vc, nv)
    _twice_bit_exact("sorted_pair_codes",
                 lambda: kernels.sorted_pair_codes(gid, vc, nv), plain)
    on_card = kernels.to_device(vc, dev)
    row("sorted_pair_codes", (n, nv),
        cuda_ms(lambda: torch.sort(on_card), iters=5),
        host_ms(lambda: kernels.sorted_pair_codes(gid, vc, nv), iters=3),
        upload(vc),
        host_ms(lambda: group_agg.distinct_pairs(gid, vc, nv), iters=3),
        n * 8 * 2)

    n, k, _dt = _largest(shapes["topk_threshold"])
    k = min(k, n - 1)
    cases = {"int64": rng.integers(1, 60, n),
             "uint64": rng.integers(0, 1 << 63, n, dtype=np.uint64)
             * np.uint64(2) + np.uint64(1),
             "float64": rng.normal(size=n)}
    for dt, vals in cases.items():
        want = np.partition(vals, n - k)[n - k]
        for _ in range(2):
            got = kernels.topk_threshold(vals, k)
            if got != want or got.dtype != vals.dtype:
                raise AssertionError(f"topk_threshold {dt}: {got!r} != "
                                     f"{want!r}")
    vals = cases["int64"]
    on_card = kernels.to_device(vals, dev)
    row("topk_threshold", (n, k, "int64"),
        cuda_ms(lambda: kernels.kth_largest(on_card, k), iters=20),
        host_ms(lambda: kernels.topk_threshold(vals, k), iters=20),
        upload(vals),
        host_ms(lambda: np.partition(vals, n - k)[n - k], iters=20),
        n * 8 + 8)

    codes, uniq = a["_codes"]["url"]
    mask = np.char.find(uniq.astype(str), "google") >= 0
    codes32 = codes.astype(np.int32)
    on_card = kernels.to_device(codes32, dev)
    plain = mask[codes32]
    _twice_bit_exact("dict_mask_gather",
                 lambda: kernels.dict_mask_gather(mask, on_card)
                 .cpu().numpy(), plain)
    n = len(codes32)
    row("dict_mask_gather", (n, len(mask)),
        cuda_ms(lambda: kernels.dict_mask_gather(mask, on_card), iters=20),
        None, upload(codes32), host_ms(lambda: mask[codes32], iters=5),
        n * 4 + len(mask) + n)
    return out


# ---------------------------------------------------------------- suites
# bench_suites_torch.py's four data-plane suites at a deployment's size:
# bench_suites.py's IoT-shaped table (2 tags, one measurement) at
# --iot-scale trucks 10 s apart, modelled on BASELINE.json configs[2]
# (TSBS --use-case=iot, whose own schema has 8 tags), log search over
# OTLP spans, a dashboard over a materialized view, and a scan of a
# table half tiered to a local object store. Each builder's seed is
# --seed plus the reference's own.
SUITE_SEEDS = {"readings": 17, "spans": 7, "dashboard": 23, "coldscan": 31}
SUITE_WARM = 3


def suites_phase(seed: int, iot_scale: int, iot_points: int,
                 suite_rows: int) -> dict:
    """Step 6b: the IoT suite's 13 query names over `iot_scale` trucks x
    `iot_points` readings and log search over suite_rows // 4 spans, in a data
    directory of their own; every query once cold (scan cache emptied),
    then SUITE_WARM times warm, every answer against its oracle; the
    dashboard (10 steps of suite_rows // 100 rows, with and without the
    view, plus the no-view query with the scan cache emptied and through
    a serving plane) in the same directory; the cold scan (10 steps of
    suite_rows // 50 rows, half tiered) in a directory of its own, its
    compressed-domain A/B equal and downloading fewer bytes. K1, K2 and
    X2 counts zeroed just before and read just after; one cold and one
    warm IoT query profiled after. Raises on any oracle, a suite's
    error, no X2 or K2 launch, or a device-decode kernel_error page. →
    the phase's JSON."""
    import bench_suites_torch as bst
    from cnosdb_tpu_torch.ops import device_decode as dd
    from cnosdb_tpu_torch.ops import fused
    from cnosdb_tpu_torch.ops import pallas_kernels as pk
    from cnosdb_tpu_torch.parallel.coordinator import Coordinator
    from cnosdb_tpu_torch.parallel.meta import DEFAULT_TENANT, MetaStore
    from cnosdb_tpu_torch.sql.executor import QueryExecutor, Session
    from cnosdb_tpu_torch.storage.engine import TsKv
    from cnosdb_tpu_torch.utils.memory_pool import MemoryPool

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_suites_")
    coords = []

    def open_db(name):
        meta = MetaStore(os.path.join(root, name, "meta.json"))
        pool = MemoryPool(32 << 30)
        coord = Coordinator(meta, TsKv(os.path.join(root, name, "data")),
                            memory_pool=pool)
        coords.append(coord)
        ex = QueryExecutor(meta, coord, memory_pool=pool)
        s = Session(database="public")
        ex.execute_one(f"ALTER DATABASE public SET SHARD {SHARDS}", s)
        return coord, ex, s

    def report(suite, runs):
        for name, r in runs.items():
            cold, warm = r["passes"][0], r["passes"][1:]
            log(f"# {suite} {name}: cold {cold['ms']:.1f} ms (K1 "
                f"+{cold['K1']}, K2 +{cold['K2']}, X2 +{cold['X2']}), warm "
                + ", ".join(f"{p['ms']:.1f}" for p in warm)
                + f" ms (K1 +{sum(p['K1'] for p in warm)}, K2 "
                f"+{sum(p['K2'] for p in warm)}, X2 "
                f"+{sum(p['X2'] for p in warm)}), {r['rows']} rows; oracle "
                "ok on every pass")

    out: dict = {}
    try:
        coord, ex, s = open_db("iot")
        t = time.perf_counter()
        a = bst.build_readings(coord, DEFAULT_TENANT, "public",
                               n_trucks=iot_scale, points=iot_points,
                               seed=seed + SUITE_SEEDS["readings"])
        iot_ingest = time.perf_counter() - t
        log(f"# suites: IoT suite {iot_scale} trucks x {iot_points} readings "
            f"= {len(a['ts'])} rows (7 DOUBLE + 1 BIGINT fields) written, "
            f"flushed and compacted in {iot_ingest:.2f}s")
        clear = lambda: bst.clear_scan_cache(coord)  # noqa: E731

        pk.launches = 0
        pk.launch_shapes.clear()
        dd.xor_launches = 0
        dd.xor_launch_shapes.clear()
        fused.launch_count = 0
        outcomes0 = dd.outcomes_snapshot()

        t = time.perf_counter()
        iot_runs: dict = {}
        iot_ms, iot_err = bst.run_tsbs(ex, s, a, clear=clear,
                                       warm=SUITE_WARM, runs=iot_runs)
        if iot_err:
            raise AssertionError(f"suites: TSBS IoT failed {iot_err}")
        report("iot", iot_runs)
        out["iot"] = {"trucks": iot_scale, "points": iot_points,
                      "rows": len(a["ts"]), "ingest_s": iot_ingest,
                      "queries_s": time.perf_counter() - t,
                      "pass": f"{len(iot_ms)}/13", "queries": iot_runs}

        t = time.perf_counter()
        spans = bst.build_spans(coord, DEFAULT_TENANT, "public",
                                suite_rows // 4,
                                seed=seed + SUITE_SEEDS["spans"])
        span_ingest = time.perf_counter() - t
        log(f"# suites: {suite_rows // 4} spans (4 STRING + 1 BIGINT "
            f"fields, 4 services) written, flushed and compacted in "
            f"{span_ingest:.2f}s")
        t = time.perf_counter()
        ls_runs: dict = {}
        ls_ms, ls_err, ls_stg = bst.run_logsearch(
            ex, s, spans, clear=clear, warm=SUITE_WARM, runs=ls_runs)
        if ls_err:
            raise AssertionError(f"suites: log search failed {ls_err}")
        report("logsearch", ls_runs)
        out["logsearch"] = {"rows": suite_rows // 4, "ingest_s": span_ingest,
                            "queries_s": time.perf_counter() - t,
                            "pass": f"{len(ls_ms)}/6", "queries": ls_runs,
                            "stages": ls_stg}
        del spans

        t = time.perf_counter()
        dash = bst.run_dashboard(ex, coord, DEFAULT_TENANT, "public", s,
                                 suite_rows,
                                 seed=seed + SUITE_SEEDS["dashboard"])
        dash["seconds"] = time.perf_counter() - t
        log(f"# suites dashboard: history {dash['history_rows']} rows; "
            f"view_ms {dash['view_ms']}; noview_ms {dash['noview_ms']}; "
            f"noview_scan_ms {dash['noview_scan_ms']}; noview_cached_ms "
            f"{dash['noview_cached_ms']}; view_hits {dash['view_hits']}; "
            f"every step against the oracle ({dash['seconds']:.2f}s)")
        out["dashboard"] = dash

        cold_coord, cold_ex, cold_s = open_db("cold")
        t = time.perf_counter()
        cold = bst.run_coldscan(cold_ex, cold_coord, DEFAULT_TENANT,
                                "public", cold_s, suite_rows,
                                seed=seed + SUITE_SEEDS["coldscan"])
        cold["seconds"] = time.perf_counter() - t
        if cold["compressed_bytes_downloaded"] \
                >= cold["compressed_oracle_bytes_downloaded"]:
            raise AssertionError(
                "suites coldscan: the compressed domain downloaded "
                f"{cold['compressed_bytes_downloaded']} B, its oracle "
                f"{cold['compressed_oracle_bytes_downloaded']} B")
        log(f"# suites coldscan: {cold['rows']} rows, {cold['files_tiered']} "
            f"files ({cold['bytes_tiered']} B) tiered; hot {cold['hot_ms']} "
            f"ms, cold {cold['cold_ms']} ms ({cold['cold_pages_fetched']} "
            f"pages, {cold['cold_bytes_downloaded']} B in "
            f"{cold['cold_range_gets']} range GETs), warm "
            f"{cold['cold_warm_ms']} ms (block cache hit ratio "
            f"{cold['block_cache_hit_ratio']}); window query "
            f"{cold['window_bytes_downloaded']} B; compressed domain "
            f"{cold['compressed_ms']} ms, {cold['compressed_bytes_downloaded']}"
            f" B against {cold['compressed_oracle_ms']} ms, "
            f"{cold['compressed_oracle_bytes_downloaded']} B, equal answers, "
            f"{cold['compressed_pages_answered']} pages answered; launches "
            f"{cold['launches']} ({cold['seconds']:.2f}s)")
        out["coldscan"] = cold

        launches = bst.launch_counts()
        out["launches"] = launches
        out["K1_shapes"] = dict(pk.launch_shapes)
        out["K2_shapes"] = dict(dd.xor_launch_shapes)
        outcomes = dd.outcomes_snapshot()
        errors = outcomes.get(("host", "kernel_error"), 0) \
            - outcomes0.get(("host", "kernel_error"), 0)
        log(f"# suites: launches {launches}, K1 {out['K1_shapes']}, K2 "
            f"{out['K2_shapes']}; device decode kernel_error pages {errors}")
        if launches["X2"] <= 0:
            raise AssertionError("suites: X2 never launched")
        if launches["K2"] <= 0:
            raise AssertionError("suites: K2 never launched")
        if errors:
            raise AssertionError("suites: device decode booked kernel_error "
                                 "pages")

        # where the time goes (after the counts were read)
        sql_of = {name: sql for name, sql, _c in bst.tsbs_queries(a)}
        for name, prepare in (("long-driving-sessions", clear),
                              ("avg-load", None)):
            log(f"# profile iot {name} "
                f"({'cold' if prepare else 'warm'}):")
            profile_query(ex, s, sql_of[name], prepare=prepare)
    finally:
        for c in coords:
            c.close()
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"# suites phase: {out['seconds']:.2f}s")
    print(json.dumps({"suites": {
        **out, **{k: {str(at): n for at, n in out[k].items()}
                  for k in ("K1_shapes", "K2_shapes")}}}), flush=True)
    return out


# ------------------------------------------------------------ suites 6c
# bench_suites.py's serving, gray-failure, memory-governance and mesh
# suites, at the reference's sizes (the mesh sweep at --mesh-rows). Each
# suite's seed is --seed plus the reference's own.
SUITE2_SEEDS = {"pointqps": 47, "overload": 53, "mesh": 41}


def suites2_phase(seed: int, mesh_rows: int) -> dict:
    """Step 6c: run_pointqps through a serving plane of its own (the
    process runs with CNOSDB_SERVING=0), run_straggler, run_overload and
    run_mesh over [cuda:0] * 8 (logical shards) and, where there are
    several cards, over every card; each in a data directory of its own,
    every answer held to its oracle inside the suite. K1, K2 and X2
    counts and the mesh outcomes zeroed just before and read just after.
    Raises on a suite's exception, no fused request, no X2 or K2 launch,
    a device-decode kernel_error page, a mesh query off the collective,
    or a straggler run whose hedged p99 is not below the unhedged one or
    whose unhedged p99 is below the injected delay. → the phase's JSON."""
    import torch

    import bench_suites_torch as bst
    from cnosdb_tpu_torch.ops import device_decode as dd
    from cnosdb_tpu_torch.ops import fused
    from cnosdb_tpu_torch.ops import pallas_kernels as pk
    from cnosdb_tpu_torch.parallel import mesh
    from cnosdb_tpu_torch.parallel.coordinator import Coordinator
    from cnosdb_tpu_torch.parallel.meta import DEFAULT_TENANT, MetaStore
    from cnosdb_tpu_torch.server.serving import ServingPlane
    from cnosdb_tpu_torch.sql.executor import QueryExecutor, Session
    from cnosdb_tpu_torch.storage.engine import TsKv
    from cnosdb_tpu_torch.utils.memory_pool import MemoryPool

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_suites2_")
    coords = []

    def open_db(name):
        meta = MetaStore(os.path.join(root, name, "meta.json"))
        pool = MemoryPool(32 << 30)
        coord = Coordinator(meta, TsKv(os.path.join(root, name, "data")),
                            memory_pool=pool)
        coords.append(coord)
        ex = QueryExecutor(meta, coord, memory_pool=pool)
        s = Session(database="public")
        ex.execute_one(f"ALTER DATABASE public SET SHARD {SHARDS}", s)
        return coord, ex, s

    def timed(fn):
        before = bst.launch_counts()
        t = time.perf_counter()
        res = fn()
        res["seconds"] = time.perf_counter() - t
        after = bst.launch_counts()
        res["launches"] = {k: after[k] - before[k] for k in after}
        return res

    cards = torch.cuda.device_count()
    pools = [("logical", [torch.device("cuda", 0)] * 8)]
    if cards > 1:
        pools.append(("cards", None))
    out: dict = {}
    try:
        pk.launches = 0
        pk.launch_shapes.clear()
        dd.xor_launches = 0
        dd.xor_launch_shapes.clear()
        fused.launch_count = 0
        mesh.reset_counters()
        outcomes0 = dd.outcomes_snapshot()

        coord, ex, s = open_db("pointqps")
        ex.serving = ServingPlane(ex)
        pq = out["pointqps"] = timed(lambda: bst.run_pointqps(
            ex, coord, DEFAULT_TENANT, "public", s,
            seed=seed + SUITE2_SEEDS["pointqps"]))
        log(f"# suites2 pointqps: {pq['requests']} requests at "
            f"{pq['point_qps']:.1f} qps, p50 {pq['p50_ms']:.3f} ms, p99 "
            f"{pq['p99_ms']:.3f} ms, hit ratio {pq['hit_ratio']:.4f}; fused "
            f"{pq['fused_queries']} of {pq['fused_requests']} at {pq['fused_qps']:.1f} "
            f"qps, widths {pq['fused_widths']}; {pq['answers_checked']} "
            f"answers against the oracle; launches {pq['launches']} "
            f"({pq['seconds']:.2f}s)")

        sg = out["straggler"] = timed(bst.run_straggler)
        log(f"# suites2 straggler: p99 healthy {sg['healthy_p99_ms']:.2f} "
            f"ms, hedged {sg['hedged_p99_ms']:.2f} ms, unhedged "
            f"{sg['nohedge_p99_ms']:.2f} ms (delay "
            f"{sg['straggle_delay_ms']} ms); hedges healthy "
            f"{sg['healthy_hedges']}, browned out {sg['hedged']}; both "
            f"scans equal the healthy one ({sg['seconds']:.2f}s)")
        if not sg["hedged_p99_ms"] < sg["nohedge_p99_ms"]:
            raise AssertionError("suites2 straggler: the hedged p99 is not "
                                 "below the unhedged one")
        if sg["nohedge_p99_ms"] < sg["straggle_delay_ms"]:
            raise AssertionError("suites2 straggler: the unhedged p99 is "
                                 "below the delay: no brownout applied")

        coord, ex, s = open_db("overload")
        ov = out["overload"] = timed(lambda: bst.run_overload(
            ex, coord, DEFAULT_TENANT, "public", s,
            seed=seed + SUITE2_SEEDS["overload"]))
        for name, ph in ov["phases"].items():
            log(f"# suites2 overload {name}: budget {ph['budget_bytes']} B, "
                f"group budget {ph['group_budget_bytes']} B; storms "
                f"{ph['query_ok']} (p99 {ph['query_p99_ms']} ms, shed "
                f"{ph['query_shed']}), writes {ph['write_ok']} (p99 "
                f"{ph['write_p99_ms']} ms, rejects {ph['write_rejects']}); "
                f"spills {ph['spills']}, unspills {ph['unspills']}, "
                f"reclaims {ph['reclaims']}; bit_identical "
                f"{ph['bit_identical']}, spill_identical "
                f"{ph['spill_identical']}, route_identical "
                f"{ph['route_identical']}")
        log(f"# suites2 overload: {ov['table_rows']} rows, every storm "
            f"against the oracle; cold and warm governance-off answers "
            f"equal: {ov['cold_warm_identical']}; launches "
            f"{ov['launches']} ({ov['seconds']:.2f}s)")

        out["mesh"] = {}
        for label, devices in pools:
            coord, ex, s = open_db(f"mesh_{label}")
            res = out["mesh"][label] = timed(lambda: bst.run_mesh(
                ex, coord, DEFAULT_TENANT, "public", s, rows=mesh_rows,
                devices=devices, seed=seed + SUITE2_SEEDS["mesh"]))
            log(f"# suites2 mesh over {res['pool']}: {res['rows']} rows; "
                f"legacy p50 {res['legacy']['p50_ms']:.2f} ms; "
                + "; ".join(
                    f"{d}: p50 {r['p50_ms']:.2f} ms, collective "
                    f"{r['stages'].get('mesh.collective_ms', 0):.2f} ms, "
                    f"{r['outcomes']}" for d, r in res["devices"].items()
                    if "p50_ms" in r)
                + f"; speedup_8x {res.get('speedup_8x')} "
                f"({res.get('speedup_8x_of')}); bit_identical "
                f"{res['bit_identical']}; every answer against the oracle; "
                f"launches {res['launches']} ({res['seconds']:.2f}s)")
            coord.close()
            coords.remove(coord)

        launches = bst.launch_counts()
        out["launches"] = launches
        out["K1_shapes"] = dict(pk.launch_shapes)
        out["K2_shapes"] = dict(dd.xor_launch_shapes)
        out["mesh_outcomes"] = {f"{lane}:{reason}": n for (lane, reason), n
                                in mesh.outcomes_snapshot().items()}
        outcomes = dd.outcomes_snapshot()
        errors = outcomes.get(("host", "kernel_error"), 0) \
            - outcomes0.get(("host", "kernel_error"), 0)
        log(f"# suites2: launches {launches}, K1 {out['K1_shapes']}, K2 "
            f"{out['K2_shapes']}; mesh outcomes {out['mesh_outcomes']}; "
            f"device decode kernel_error pages {errors}")
        if launches["X2"] <= 0:
            raise AssertionError("suites2: X2 never launched")
        if launches["K2"] <= 0:
            raise AssertionError("suites2: K2 never launched")
        if errors:
            raise AssertionError("suites2: device decode booked "
                                 "kernel_error pages")
    finally:
        for c in coords:
            c.close()
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"# suites2 phase: {out['seconds']:.2f}s")
    print(json.dumps({"suites2": {
        **out, **{k: {str(at): n for at, n in out[k].items()}
                  for k in ("K1_shapes", "K2_shapes")}}}), flush=True)
    return out


# ---------------------------------------------------------------- cluster
# The port's server entry point as processes: one meta service and three
# query_tskv nodes of `python -m cnosdb_tpu_torch.server.main run`, on the
# card (no placement variable), with the `_faults` control RPC armed
# (CNOSDB_FAULTS), the serving tier's caches off so every query reaches
# the operators, and the mesh lane allowed on one card.
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
# CNOSDB_LOCKWATCH: the nodes record their lock-order graph and longest
# holds, which /debug/lockgraph serves when a raft wait times out
CLUSTER_ENV = {"CNOSDB_FAULTS": "seed=1", "CNOSDB_SERVING": "0",
               "CNOSDB_MESH_MIN_DEVICES": "1", "CNOSDB_LOCKWATCH": "1"}
NEMESIS_SEED = 23
# a node's scan RPCs to its peers fail: every split fails over to its own
# replica, whatever raft leadership and the hedges would route
SCANS_LOCAL = "rpc.send:fail:if=scan_vnode"
# the read-your-writes step slows the live leader's scans by this much,
# past the 25 ms hedge floor
LEADER_SCAN_DELAY_MS = 200
# the outsider step delays the static leader's raft messages by this
# much: a group of two members commits only with its ack, so it holds
# every acked entry and applies it only when a later message arrives
STATIC_RAFT_DELAY_MS = 2000
# the failover-read step delays the leader's raft messages to one
# follower by this much, so that its replica lags at the read
FAILOVER_RAFT_DELAY_MS = 1000
# a query of a replicated group that no member can confirm refuses within
# the port's leaderless-read span (coordinator.LEADERLESS_READ_S, from
# raft's election timeout) and this much more for the query around it
REFUSAL_SLACK_S = 1.0
# the restarted node's memory cache after catch-up: only the dcw rows
# written while it was down belong there
MEMCACHE_LIMIT = 1 << 20
LP_BATCH = 10_000
# the write errors of an entry raft did not commit (the leader changed
# under it, or the group elected past the propose timeout): the write
# was not acked, and a client sends it again
RETRIED_WRITE_ERRORS = ("entry superseded after leadership change",
                        "propose timeout",
                        "no reachable leader for replica set")
CLUSTER_SQL = {
    "double_groupby_1":
        "SELECT date_bin(INTERVAL '1 hour', time) AS t, hostname, "
        "avg(usage_user) AS m FROM cpu GROUP BY t, hostname "
        "ORDER BY t, hostname",
    "last_loc":
        "SELECT hostname, last(usage_user) AS l FROM cpu GROUP BY hostname "
        "ORDER BY hostname",
    "agg":
        "SELECT hostname, count(*), sum(usage_user), min(usage_user), "
        "max(usage_user), first(usage_user), last(usage_user) FROM cpu "
        "GROUP BY hostname ORDER BY hostname",
}


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class ServerProc:
    """One `cnosdb_tpu_torch.server.main run` process, its ports and log."""

    def __init__(self, root: str, name: str, args: list, env: dict):
        self.name, self.args, self.env = name, args, env
        self.log_path = os.path.join(root, f"{name}.log")
        self.proc = None

    def start(self) -> "ServerProc":
        with open(self.log_path, "ab") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "cnosdb_tpu_torch.server.main",
                 "run", *self.args], cwd=REPO_DIR, env=self.env,
                stdout=log, stderr=log)
        return self

    def kill(self) -> None:
        if self.proc is not None:
            self.proc.kill()
            self.proc.wait(timeout=30)
            self.proc = None

    def alive(self) -> None:
        if self.proc is None or self.proc.poll() is not None:
            raise AssertionError(f"{self.name} exited: {self.log_tail()}")

    def log_tail(self) -> str:
        with open(self.log_path, "rb") as f:
            return f.read()[-3000:].decode(errors="replace")


class ClusterNode(ServerProc):
    def __init__(self, root: str, node_id: int, meta_port: int, env: dict):
        self.node_id = node_id
        self.http_port, self.rpc_port = _free_port(), _free_port()
        super().__init__(root, f"node{node_id}", [
            "--mode", "query_tskv", "--meta", f"127.0.0.1:{meta_port}",
            "--node-id", str(node_id),
            "--data-dir", os.path.join(root, f"node{node_id}"),
            "--http-port", str(self.http_port),
            "--rpc-port", str(self.rpc_port)], env)

    def kill(self) -> None:
        """SIGKILL, and close the keep-alive connections this process
        pooled to the node's RPC port: the node restarts on the same port,
        and a request sent on a dead connection fails in its response
        phase ("Remote end closed connection without response"), which
        the RPC client never retries."""
        from cnosdb_tpu_torch.parallel import net

        super().kill()
        with net._pool.lock:
            dead = net._pool.idle.pop(f"127.0.0.1:{self.rpc_port}", [])
        for conn, _ in dead:
            conn.close()

    def http(self, method: str, path: str, body: bytes | None = None,
             timeout: float = 300.0) -> str:
        """The answer text; any status but 200 raises with the node's
        answer and log."""
        import base64
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            f"http://127.0.0.1:{self.http_port}{path}", data=body,
            method=method)
        req.add_header("Authorization",
                       "Basic " + base64.b64encode(b"root:").decode())
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.read().decode()
        except urllib.error.HTTPError as e:
            raise AssertionError(
                f"{self.name} {path}: HTTP {e.code} "
                f"{e.read().decode(errors='replace')[:2000]}") from None

    def sql(self, q: str, db: str = "tsbs") -> str:
        return self.http("POST", f"/api/v1/sql?db={db}", q.encode())

    def write_lp(self, lines: str, db: str) -> str:
        return self.http("POST", f"/api/v1/write?db={db}", lines.encode())

    def wait_ready(self, timeout: float = 180.0) -> None:
        deadline = time.monotonic() + timeout
        while True:
            self.alive()
            try:
                self.http("GET", "/api/v1/ping", timeout=5.0)
                return
            except OSError:
                if time.monotonic() > deadline:
                    raise AssertionError(f"{self.name} not ready: "
                                         + self.log_tail()) from None
                time.sleep(0.2)

    def metric(self, name: str, **labels) -> int:
        """Sum of the /metrics samples of `name` that carry `labels`."""
        want = [f'{k}="{v}"' for k, v in labels.items()]
        total = 0
        for line in self.http("GET", "/metrics").splitlines():
            if line.startswith(name + "{") and all(w in line for w in want):
                total += int(float(line.rsplit(" ", 1)[1]))
        return total


class LocalCluster:
    """A meta process and `n` data nodes on this host, in `root`."""

    def __init__(self, root: str, n: int, env: dict):
        self.meta_port = _free_port()
        self.meta = ServerProc(root, "meta", [
            "--mode", "meta", "--data-dir", os.path.join(root, "meta"),
            "--meta-port", str(self.meta_port)], env)
        self.nodes = [ClusterNode(root, i + 1, self.meta_port, env)
                      for i in range(n)]

    def start(self) -> "LocalCluster":
        self.meta.start()
        for n in self.nodes:
            n.start()
        for n in self.nodes:
            n.wait_ready()
        return self

    def stop(self) -> None:
        for p in self.nodes + [self.meta]:
            p.kill()


def cluster_env(placement: str | None) -> dict:
    """The nodes' environment: this process's, less every CNOSDB_* switch
    the earlier phases set, plus CLUSTER_ENV; `placement` None is the
    card."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CNOSDB_")}
    env.update(CLUSTER_ENV)
    env["PYTHONUNBUFFERED"] = "1"
    if placement is not None:
        env["CNOSDB_TORCH_PLACEMENT"] = placement
    return env


def tsbs_lines(data: Data) -> list[str]:
    """The TSBS rows as line protocol, time-major (every host at one
    instant, then the next), in batches of LP_BATCH lines."""
    names = [f"host_{h:03d}" for h in range(N_HOSTS)]
    out, cur = [], []
    for k in range(data.per_host):
        ts = int(data.ts[k])
        for h in range(N_HOSTS):
            cur.append(f"cpu,hostname={names[h]} "
                       f"usage_user={float(data.user[h, k])!r},"
                       f"usage_system={float(data.syst[h, k])!r} {ts}")
            if len(cur) == LP_BATCH:
                out.append("\n".join(cur))
                cur = []
    if cur:
        out.append("\n".join(cur))
    return out


def csv_rows(text: str) -> list[list[str]]:
    import csv
    import io

    rows = [r for r in csv.reader(io.StringIO(text)) if r]
    return rows[1:]


def check_cluster_answer(name: str, text: str, data: Data) -> None:
    """One node's answer text against the numpy oracle: counts exact,
    min/max/first/last exact, sums and means within rtol 1e-9."""
    rows = csv_rows(text)
    if name == "double_groupby_1":
        check_groupby_rows(rows, data)
        return
    hosts = [int(r[0].split("_")[1]) for r in rows]
    if hosts != list(range(N_HOSTS)):
        raise AssertionError(f"{name}: hosts {hosts[:5]}...")
    u = data.user
    if name == "last_loc":
        np.testing.assert_array_equal([float(r[1]) for r in rows], u[:, -1])
        return
    got = np.array([[float(x) for x in r[1:]] for r in rows])
    np.testing.assert_array_equal(got[:, 0], data.per_host)
    np.testing.assert_allclose(got[:, 1], u.sum(axis=1), rtol=1e-9)
    for col, want in ((2, u.min(axis=1)), (3, u.max(axis=1)),
                      (4, u[:, 0]), (5, u[:, -1])):
        np.testing.assert_array_equal(got[:, col], want)


def check_groupby_rows(rows, data: Data) -> None:
    ts = np.array([int(r[0]) for r in rows], dtype=np.int64)
    host = np.array([int(r[1].split("_")[1]) for r in rows])
    seg = host * data.nb + (ts - BASE_TS) // BUCKET_NS
    seg_all = (np.arange(N_HOSTS)[:, None] * data.nb
               + data.bucket[None, :]).ravel()
    want, _ = _seg_mean(seg_all, data.user.ravel(), N_HOSTS * data.nb)
    if len(seg) != N_HOSTS * data.nb or len(np.unique(seg)) != len(seg):
        raise AssertionError(f"double_groupby_1: {len(seg)} groups")
    np.testing.assert_allclose([float(r[2]) for r in rows], want[seg],
                               rtol=1e-9)


def gpu_apps() -> str:
    """nvidia-smi's compute apps (pid, used memory), as it prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().replace("\n", "; ")


def nvidia_fds(pid: int) -> int:
    """How many of the process's open files are NVIDIA device nodes: a
    process that holds a CUDA context keeps /dev/nvidia* open."""
    n = 0
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            n += os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia")
        except OSError:
            pass      # closed since the listing
    return n


class Clients:
    """Recorded clients writing keys into `dcw` and reading them back
    (the key set of cw) from any node."""

    def __init__(self, path: str):
        from cnosdb_tpu_torch.chaos.history import HistoryRecorder

        self.path = path
        self.rec = HistoryRecorder(path)
        self.acked: set[str] = set()
        self.n = 0
        self.failed = 0

    def write(self, node, k: int) -> None:
        keys = [f"w{self.n + i}" for i in range(k)]
        body = "\n".join(f"cw,k={key} v=1 {BASE_TS + (self.n + i) * 1000}"
                         for i, key in enumerate(keys))
        e = self.rec.invoke("cw", "write", keys=keys)
        try:
            node.write_lp(body, db="dcw")
        except AssertionError as ex:
            # not acked: the history records the failure, and the checker
            # allows the keys either way
            self.rec.fail("cw", e, str(ex)[:200])
            if not any(m in str(ex) for m in RETRIED_WRITE_ERRORS):
                raise
            self.failed += 1
            self.n += k
            return
        self.rec.ok("cw", e)
        self.n += k
        self.acked.update(keys)

    def read(self, node) -> set:
        s = f"r{node.node_id}"
        e = self.rec.invoke(s, "read", durable=False, mono=True)
        keys = table_keys(node)
        self.rec.ok(s, e, keys=sorted(keys))
        return keys


def table_keys(node, db: str = "dcw", table: str = "cw") -> set:
    return {r[0] for r in csv_rows(node.sql(f"SELECT DISTINCT k FROM {table}",
                                            db=db))}


def replica_keys(node, owner: str, vnode_id: int, db_table: str = "cw"
                 ) -> set:
    """The keys the node's replica `vnode_id` of `owner` holds: the scan
    RPC without the `leader_read` flag, served where it lands with no
    leader check (not a client read: the history would take it for a
    read that went back in time)."""
    from cnosdb_tpu_torch.models.predicate import ColumnDomains, TimeRanges
    from cnosdb_tpu_torch.parallel.ipc import decode_scan_batch
    from cnosdb_tpu_torch.parallel.net import rpc_call

    r = rpc_call(f"127.0.0.1:{node.rpc_port}", "scan_vnode", {
        "owner": owner, "vnode_id": vnode_id, "table": db_table,
        "trs": TimeRanges.all().to_wire(),
        "doms": ColumnDomains.all().to_wire(), "field_names": ["v"]},
        timeout=30.0)
    if r.get("ipc") is None:
        return set()
    b = decode_scan_batch(r["ipc"])
    return {b.series_keys[o].tag_value("k")
            for o in np.unique(b.sid_ordinal[:b.n_rows])}


def wait_keys(node, want: set, timeout: float = 60.0) -> set:
    """The node's key set once it holds every key of `want` (an unacked
    write may have landed too), or at the timeout."""
    deadline = time.monotonic() + timeout
    while True:
        got = table_keys(node)
        if want <= got or time.monotonic() > deadline:
            return got
        time.sleep(0.3)


def dump_nodes(nodes, why: str) -> None:
    """Print every node's /debug/backtrace and /debug/lockgraph."""
    for n in nodes:
        for what in ("backtrace", "lockgraph"):
            try:
                text = n.http("GET", f"/debug/{what}", timeout=30.0)
            except (AssertionError, OSError) as e:
                text = f"unavailable: {e}"
            log(f"# {why}: node {n.node_id} /debug/{what}:\n{text}")


def wait_leaders(cluster, groups: dict, timeout: float = 120.0) -> None:
    """Until every replica set of each database (owner → shard count)
    has elected a leader, as the nodes' /debug/health reports it."""
    import json as _json

    deadline = time.monotonic() + timeout
    while True:
        led: dict = {}
        views: dict = {}
        for n in cluster.nodes:
            members = _json.loads(n.http("GET", "/debug/health"))[
                "raft_members"]
            for key, m in members.items():
                owner, _, rest = key.partition("/")
                gid = rest.split("#")[0]
                led.setdefault(owner, {}).setdefault(gid, False)
                led[owner][gid] |= m["role"] == "leader"
                views.setdefault((owner, gid), {})[n.node_id] = m
        if all(len(led.get(o, {})) == k and all(led[o].values())
               for o, k in groups.items()):
            return
        if time.monotonic() > deadline:
            dump_nodes(cluster.nodes, "wait_leaders timed out")
            leaderless = {f"{o}/{g}": views[(o, g)]
                          for o, gs in led.items() for g, ok in gs.items()
                          if not ok}
            raise AssertionError(f"replica sets without a leader: {led}; "
                                 f"their members by node: {leaderless}")
        time.sleep(0.2)


def local_answers(node, data: Data):
    """The node's answers to CLUSTER_SQL when every one engages its mesh
    lane, which takes only batches scanned on the node itself; else None.
    Each answer is checked against the oracle."""
    out = {}
    for name, q in CLUSTER_SQL.items():
        before = node.metric("cnosdb_mesh_total", reason="engaged")
        out[name] = node.sql(q)
        check_cluster_answer(name, out[name], data)
        if node.metric("cnosdb_mesh_total", reason="engaged") == before:
            return None
    return out


def raft_state(node, owners) -> dict:
    """The node's raft members of the databases `owners` → (log, commit,
    applied)."""
    import json as _json

    members = _json.loads(node.http("GET", "/debug/health"))["raft_members"]
    return {k: (m["last_index"], m["commit"], m["applied"])
            for k, m in members.items() if k.split("/")[0] in owners}


def caught_up(state: dict) -> bool:
    return bool(state) and all(last == commit == applied
                               for last, commit, applied in state.values())


def wait_caught_up(node, owners, peers=(), timeout: float = 180.0) -> float:
    """Until every raft member of the databases `owners` on the node has
    applied its whole log, and the logs stood still for one poll: a
    restarted follower takes entries from its leaders for a while after
    it answers pings. On a timeout the error shows the lagging groups'
    members on the node and on `peers` (role, term, leader, log,
    commit, applied), after every node's thread stacks and lock graph.
    → seconds waited."""
    import json as _json

    t0 = time.monotonic()
    prev = None
    while True:
        state = raft_state(node, owners)
        if state == prev and caught_up(state):
            return time.monotonic() - t0
        if time.monotonic() - t0 > timeout:
            dump_nodes((node, *peers), "wait_caught_up timed out")
            lagging = {k.split("#")[0] for k, (last, commit, applied)
                       in state.items() if not last == commit == applied}
            views = {n.node_id: {
                k: m for k, m in _json.loads(n.http(
                    "GET", "/debug/health"))["raft_members"].items()
                if k.split("#")[0] in lagging} for n in (node, *peers)}
            raise AssertionError(f"node {node.node_id} did not catch up: "
                                 f"{state}; the lagging groups' members "
                                 f"by node: {views}")
        prev = state
        time.sleep(0.5)


def scans_local(node, on: bool) -> None:
    """Arm SCANS_LOCAL on the node (or clear its faults): with it, its
    scans stay on its own replicas whatever raft leadership and the
    hedges would route."""
    from cnosdb_tpu_torch.parallel.net import rpc_call

    spec = f"seed={NEMESIS_SEED}" + (f";{SCANS_LOCAL}" if on else "")
    rpc_call(f"127.0.0.1:{node.rpc_port}", "_faults", {"spec": spec},
             timeout=5.0)


def engaging_node(cluster, start: int, data: Data):
    """The first node, from `start` on, whose scans are all local
    (leader-follow routing decides it) → (node, its answers), or
    (None, None)."""
    n_nodes = len(cluster.nodes)
    for i in range(n_nodes):
        n = cluster.nodes[(start + i) % n_nodes]
        answers = local_answers(n, data)
        if answers is not None:
            return n, answers
    return None, None


def replica_sets(node, owners) -> list:
    """The replica sets of the databases `owners` in the node's own view
    of meta (/debug/health): static leader and each vnode's status."""
    sets = json.loads(node.http("GET", "/debug/health"))["replica_sets"]
    return [rs for o in owners for rs in sets.get(o, [])]


def check_no_marks(cluster, owners, where: str) -> None:
    """No vnode of `owners` is BROKEN in any node's view of meta: BROKEN
    marks a replica whose data is suspect (quarantine, the scrubber),
    and nothing here damages data; a replica a node could not reach
    while a fault lasted is that node's health scorer's to judge."""
    marks = {}
    for n in cluster.nodes:
        m = sorted(v["id"] for rs in replica_sets(n, owners)
                   for v in rs["vnodes"] if v["status"] == "BROKEN")
        if m:
            marks[n.node_id] = m
    if marks:
        raise AssertionError(f"{where}: vnodes marked BROKEN, by the node "
                             f"whose view of meta shows them: {marks}")


def live_leaders(cluster, owner: str) -> dict:
    """Each replica set of `owner` that has a raft leader → (its node id,
    vnode id), as the nodes' /debug/health report their members: of the
    members that report leading, the one in the highest term (a member
    cut off from its group may still think it leads an older one)."""
    best: dict = {}
    for n in cluster.nodes:
        for key, m in json.loads(n.http("GET", "/debug/health"))[
                "raft_members"].items():
            o, _, rest = key.partition("/")
            gid, _, vid = rest.partition("#")
            if o == owner and m["role"] == "leader" and \
                    m["term"] > best.get(gid, (-1,))[0]:
                best[gid] = (m["term"], n.node_id, int(vid))
    return {gid: (nid, vid) for gid, (_t, nid, vid) in best.items()}


def _rs_payload(rs: dict) -> dict:
    """A replica set as /debug/health shows it → ReplicationSet.to_dict."""
    from cnosdb_tpu_torch.models.meta_data import VnodeStatus

    return {**rs, "vnodes": [{**v, "status": int(VnodeStatus[v["status"]])}
                             for v in rs["vnodes"]]}


def stepdown(node, owner: str, rs: dict, vnode_id: int) -> bool:
    """Ask the node's raft member `vnode_id` of the set to yield its
    leadership → whether it led."""
    from cnosdb_tpu_torch.parallel.net import rpc_call

    return rpc_call(f"127.0.0.1:{node.rpc_port}", "replica_stepdown",
                    {"owner": owner, "rs": _rs_payload(rs),
                     "vnode_id": vnode_id}, timeout=10.0)["stepped"]


def place_leaders(cluster, owner: str, want, timeout: float = 120.0) -> int:
    """Raft leadership of each replica set of `owner` onto the node
    `want(set id)` names: a leader elsewhere steps down, and its group
    elects again (the member that stepped down sits the election out),
    until every set is led from its node → the stepdowns it took."""
    sets = {str(rs["id"]): rs
            for rs in replica_sets(cluster.nodes[0], (owner,))}
    by_id = {n.node_id: n for n in cluster.nodes}
    n = 0
    deadline = time.monotonic() + timeout
    while True:
        led = live_leaders(cluster, owner)
        away = {gid: led.get(gid) for gid in sets
                if led.get(gid, (None,))[0] != want(gid).node_id}
        if not away:
            return n
        if time.monotonic() > deadline:
            dump_nodes(cluster.nodes, "place_leaders timed out")
            raise AssertionError(f"{owner}: sets led away from their "
                                 f"nodes: {away}")
        for gid, at in away.items():
            if at is not None:          # else the set is electing
                n += stepdown(by_id[at[0]], owner, sets[gid], at[1])
        time.sleep(0.5)


def lead_on(cluster, owner: str, target) -> int:
    """Every replica set of `owner` led from node `target` → the
    stepdowns it took."""
    return place_leaders(cluster, owner, lambda gid: target)


def spread_leaders(cluster, owner: str) -> int:
    """The replica sets of `owner` led from the nodes in turn, by set
    id, so that every node leads one → the stepdowns it took."""
    ids = sorted((rs["id"] for rs in replica_sets(cluster.nodes[0],
                                                  (owner,))))
    node_of = {str(i): cluster.nodes[k % len(cluster.nodes)]
               for k, i in enumerate(ids)}
    return place_leaders(cluster, owner, node_of.__getitem__)


def static_leaders_node(cluster, owner: str):
    """The node that meta places the static leaders of `owner`'s replica
    sets on (one bucket: all on one node)."""
    leaders = {rs["leader_node_id"]
               for rs in replica_sets(cluster.nodes[0], (owner,))}
    if len(leaders) != 1:
        raise AssertionError(f"{owner}'s static leaders on nodes {leaders}")
    (nid,) = leaders
    return next(n for n in cluster.nodes if n.node_id == nid)


def leaders_node(cluster, owner: str):
    """The node that holds the live raft leaders of every replica set of
    `owner`, where they sit on one node; where they are spread, the node
    that holds most of them, once the rest are moved onto it →
    (node, stepdowns)."""
    led = [nid for nid, _vid in live_leaders(cluster, owner).values()]
    node = max(cluster.nodes, key=lambda n: (led.count(n.node_id),
                                             -n.node_id))
    return node, lead_on(cluster, owner, node)


def read_your_writes(cluster, clients) -> dict:
    """Step 7's read through a node that does not lead: dcw's raft
    leadership moves off its static leader S (S's member steps down),
    S's raft traffic is held back (the other two nodes' raft messages to
    S fail; its scans still answer), keys are acked through the new
    leader L, L's scans are slowed past the hedge floor, and the third
    node T reads once, with no wait. The read must hold every acked key
    and no key that was never written, and T must have fired no hedge
    (one came due, and was suppressed: a hedge would read a follower).
    The lag it forced is logged: S's applied index against L's at the
    read, and the acked keys S's own replica lacks. → the step's
    JSON."""
    from cnosdb_tpu_torch.parallel.net import rpc_call

    owner = "cnosdb.dcw"
    (rs,) = replica_sets(cluster.nodes[0], (owner,))
    gid = str(rs["id"])
    by_id = {n.node_id: n for n in cluster.nodes}
    s_node = by_id[rs["leader_node_id"]]
    t0 = time.perf_counter()
    stepped = 0
    deadline = time.monotonic() + 60.0
    while True:
        at = live_leaders(cluster, owner).get(gid)
        if at is not None and at[0] != s_node.node_id:
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"{owner}'s leadership stayed on its "
                                 f"static leader node {s_node.node_id}")
        if at is not None:
            stepped += stepdown(s_node, owner, rs, at[1])
        time.sleep(0.2)
    l_node, l_vid = by_id[at[0]], at[1]
    (t_node,) = [n for n in cluster.nodes if n not in (s_node, l_node)]
    deadline = time.monotonic() + 30.0
    while not any(k.startswith(f"{owner}/{gid}#") and m["leader_id"] == l_vid
                  for k, m in json.loads(t_node.http(
                      "GET", "/debug/health"))["raft_members"].items()):
        if time.monotonic() > deadline:
            raise AssertionError(f"node {t_node.node_id} never followed "
                                 f"{owner}'s leader vnode {l_vid}")
        time.sleep(0.05)
    moved_s = time.perf_counter() - t0

    hold = (f"seed={NEMESIS_SEED};rpc.send:fail:if=127.0.0.1:"
            f"{s_node.rpc_port} raft_msg")
    # the live leader's scans answer late, so a hedge comes due at the
    # reader: its other replicas (its own, not yet told of the commit,
    # and the held-back one) lack the new keys
    slow = f"{hold};rpc.server:delay({LEADER_SCAN_DELAY_MS}):if=scan_vnode"
    for n, spec in ((l_node, slow), (t_node, hold)):
        rpc_call(f"127.0.0.1:{n.rpc_port}", "_faults", {"spec": spec},
                 timeout=5.0)
    def hedges():
        return {o: t_node.metric("cnosdb_hedge_total", outcome=o, **kw)
                for o, kw in (("fired", {}),
                              ("suppressed", {"reason": "leader_read"}))}

    try:
        hedged = hedges()
        before = set(clients.acked)
        clients.write(l_node, 10)
        new = clients.acked - before
        if not new:
            raise AssertionError(f"no key acked through node "
                                 f"{l_node.node_id}")
        (s_applied,) = [a for *_r, a in raft_state(s_node,
                                                   (owner,)).values()]
        (l_applied,) = [a for *_r, a in raft_state(l_node,
                                                   (owner,)).values()]
        t = time.perf_counter()
        keys = clients.read(t_node)
        read_ms = (time.perf_counter() - t) * 1e3
        hedged = {o: n - hedged[o] for o, n in hedges().items()}
        # S's own replica, read with the scan RPC without a flag (a read
        # through S's SQL would confirm, and wait for S's apply): the
        # acked keys it lacks (not a client read: the history would take
        # it for a read that went back in time)
        (s_vid,) = [v["id"] for v in rs["vnodes"]
                    if v["node_id"] == s_node.node_id]
        s_keys = replica_keys(s_node, owner, s_vid)
    finally:
        for n in (l_node, t_node):
            rpc_call(f"127.0.0.1:{n.rpc_port}", "_faults",
                     {"spec": f"seed={NEMESIS_SEED}"}, timeout=5.0)
    missing = clients.acked - keys
    written = {f"w{i}" for i in range(clients.n)}
    if missing or not keys <= written:
        raise AssertionError(
            f"node {t_node.node_id}'s read misses {len(missing)} acked "
            f"keys {sorted(missing)[:5]} and holds {sorted(keys - written)} "
            f"never written (the live leader node {l_node.node_id} applied "
            f"{l_applied}, the static leader node {s_node.node_id} "
            f"{s_applied}; the reader's hedges {hedged})")
    if hedged["fired"] or not hedged["suppressed"]:
        raise AssertionError(f"node {t_node.node_id}'s read at the live "
                             f"leader, {LEADER_SCAN_DELAY_MS} ms late: "
                             f"hedges {hedged}, want none fired and the "
                             "hedge that came due suppressed")
    if s_applied >= l_applied:
        raise AssertionError(f"the static leader node {s_node.node_id} "
                             f"applied {s_applied} >= the live leader's "
                             f"{l_applied}: the step forced no lag")
    res = {"static_node": s_node.node_id, "leader_node": l_node.node_id,
           "reader_node": t_node.node_id, "stepdowns": stepped,
           "moved_s": moved_s, "acked_keys": len(clients.acked),
           "new_keys": len(new), "static_applied": s_applied,
           "leader_applied": l_applied, "read_ms": read_ms,
           "hedges": hedged, "static_lacks": len(clients.acked - s_keys)}
    log(f"# read-your-writes: {owner}'s raft leadership off its static "
        f"leader node {s_node.node_id} ({stepped} stepdowns, led from node "
        f"{l_node.node_id} after {moved_s:.2f}s), node {s_node.node_id}'s "
        f"raft traffic held back, {len(new)} keys acked through node "
        f"{l_node.node_id}; node {t_node.node_id}'s one read with no wait "
        f"({read_ms:.1f} ms; hedges fired {hedged['fired']}, suppressed "
        f"at the leader {hedged['suppressed']}) holds all "
        f"{len(clients.acked)} acked keys and none never written; forced "
        f"lag at the read: applied index "
        f"{s_applied} on the static leader against {l_applied} on the "
        f"live leader; the static leader's own replica lacked "
        f"{res['static_lacks']} acked keys")
    return res


def write_keys(node, db: str, table: str, keys: list) -> bool:
    """Keys `keys` written into `db`.`table` through the node, sent again
    while raft drops them in a leadership change → whether they were
    acked (False only after five tries)."""
    body = "\n".join(f"{table},k={key} v=1 {BASE_TS + int(key[1:]) * 1000}"
                     for key in keys)
    for _attempt in range(5):
        try:
            node.write_lp(body, db=db)
            return True
        except AssertionError as e:
            if not any(m in str(e) for m in RETRIED_WRITE_ERRORS):
                raise
    return False


def leader_read_counts(node) -> dict:
    """The node's leader-read counters (/debug/health): its reads of
    replicated sets through their raft leaders, the redirects it
    followed and its waits for a leader."""
    return json.loads(node.http("GET", "/debug/health"))["counters"].get(
        "leader_read", {})


def outsider_reads(cluster) -> dict:
    """Step 7's read through a node that holds no member of a group: dcx
    (SHARD 1 REPLICA 2) has one replica set, on two of the three nodes.
    Its raft leadership sits on its static leader S while the third node
    O reads once (O remembers S as the group's leader), then moves to the
    other member L. S's raft traffic is held back: L's raft messages to
    S are delayed by STATIC_RAFT_DELAY_MS (with two members a commit
    needs S's ack, so S holds every acked entry in its log, and applies
    it only when a later message brings the commit). Keys are acked
    through L, and O reads once, with no wait: its scan asks S for a
    leader read and is redirected to L. The read must hold every acked
    key and no key that was never written, and O must have booked a
    redirect. S's applied index lags L's at the read, and the acked keys
    S's own replica lacks are logged. → the step's JSON."""
    from cnosdb_tpu_torch.parallel.net import rpc_call

    owner = "cnosdb.dcx"
    by_id = {n.node_id: n for n in cluster.nodes}
    acked: list = []
    keys_n = [0]

    def write(node, k: int) -> int:
        keys = [f"x{keys_n[0] + i}" for i in range(k)]
        keys_n[0] += k
        if write_keys(node, "dcx", "cx", keys):
            acked.extend(keys)
            return k
        return 0

    write(cluster.nodes[0], 5)
    wait_leaders(cluster, {owner: 1})
    (rs,) = replica_sets(cluster.nodes[0], (owner,))
    members = {v["node_id"]: v["id"] for v in rs["vnodes"]}
    s_node = by_id[rs["leader_node_id"]]
    (l_node,) = [by_id[nid] for nid in members if nid != s_node.node_id]
    (o_node,) = [n for n in cluster.nodes if n.node_id not in members]
    l_vid = members[l_node.node_id]
    t0 = time.perf_counter()
    stepped = lead_on(cluster, owner, s_node)
    first = table_keys(o_node, "dcx", "cx")
    if not set(acked) <= first:
        raise AssertionError(f"node {o_node.node_id}'s read of {owner} led "
                             f"from its static leader misses "
                             f"{sorted(set(acked) - first)}")
    stepped += lead_on(cluster, owner, l_node)
    deadline = time.monotonic() + 30.0
    while not any(k.startswith(f"{owner}/") and m["leader_id"] == l_vid
                  for k, m in json.loads(s_node.http(
                      "GET", "/debug/health"))["raft_members"].items()):
        if time.monotonic() > deadline:
            raise AssertionError(f"node {s_node.node_id} never followed "
                                 f"{owner}'s leader vnode {l_vid}")
        time.sleep(0.05)
    moved_s = time.perf_counter() - t0

    hold = (f"seed={NEMESIS_SEED};rpc.send:delay({STATIC_RAFT_DELAY_MS}):"
            f"if=127.0.0.1:{s_node.rpc_port} raft_msg")
    rpc_call(f"127.0.0.1:{l_node.rpc_port}", "_faults", {"spec": hold},
             timeout=5.0)
    try:
        before = leader_read_counts(o_node)
        t = time.perf_counter()
        new = write(l_node, 10)
        write_ms = (time.perf_counter() - t) * 1e3
        if not new:
            raise AssertionError(f"no key acked through node "
                                 f"{l_node.node_id}")
        (s_applied,) = [a for *_r, a in raft_state(s_node,
                                                   (owner,)).values()]
        (l_applied,) = [a for *_r, a in raft_state(l_node,
                                                   (owner,)).values()]
        t = time.perf_counter()
        keys = table_keys(o_node, "dcx", "cx")
        read_ms = (time.perf_counter() - t) * 1e3
        after = leader_read_counts(o_node)
        # S's own replica, read with the scan RPC without a flag
        s_keys = replica_keys(s_node, owner, members[s_node.node_id], "cx")
    finally:
        rpc_call(f"127.0.0.1:{l_node.rpc_port}", "_faults",
                 {"spec": f"seed={NEMESIS_SEED}"}, timeout=5.0)
    counts = {k: after.get(k, 0) - before.get(k, 0)
              for k in ("read", "redirect", "no_leader")}
    missing = set(acked) - keys
    written = {f"x{i}" for i in range(keys_n[0])}
    if missing or not keys <= written:
        raise AssertionError(
            f"node {o_node.node_id}'s read misses {len(missing)} acked keys "
            f"{sorted(missing)[:5]} and holds {sorted(keys - written)} "
            f"never written (the live leader node {l_node.node_id} applied "
            f"{l_applied}, the static leader node {s_node.node_id} "
            f"{s_applied}; its leader reads {counts})")
    if counts["redirect"] < 1:
        raise AssertionError(f"node {o_node.node_id} booked no redirect: "
                             f"{counts}")
    if s_applied >= l_applied:
        raise AssertionError(f"the static leader node {s_node.node_id} "
                             f"applied {s_applied} >= the live leader's "
                             f"{l_applied}: the step forced no lag")
    wait_caught_up(s_node, (owner,), (l_node,))
    res = {"static_node": s_node.node_id, "leader_node": l_node.node_id,
           "reader_node": o_node.node_id, "stepdowns": stepped,
           "moved_s": moved_s, "acked_keys": len(acked), "new_keys": new,
           "write_ms": write_ms, "static_applied": s_applied,
           "leader_applied": l_applied, "read_ms": read_ms,
           "leader_reads": counts,
           "static_lacks": len(set(acked) - s_keys)}
    log(f"# outsider read: {owner} (SHARD 1 REPLICA 2) on nodes "
        f"{sorted(members)}, node {o_node.node_id} holds no member; its "
        f"raft leadership moved off the static leader node "
        f"{s_node.node_id} to node {l_node.node_id} ({stepped} stepdowns, "
        f"{moved_s:.2f}s), node {s_node.node_id}'s raft traffic delayed "
        f"{STATIC_RAFT_DELAY_MS} ms, {new} keys acked through node "
        f"{l_node.node_id} in {write_ms:.1f} ms; node {o_node.node_id}'s "
        f"one read with no wait ({read_ms:.1f} ms; leader reads {counts}) "
        f"holds all {len(acked)} acked keys and none never written; "
        f"forced lag at the read: applied index {s_applied} on the static "
        f"leader against {l_applied} on the live leader; the static "
        f"leader's own replica lacked {res['static_lacks']} acked keys")
    return res


def read_index_counts(node) -> dict:
    """The node's read-index counters (/debug/health): the reads it served
    as a replicated group's leader, each confirmed or refused, and those
    its members confirmed or refused as followers (the follower read
    index, and its apply wait)."""
    return json.loads(node.http("GET", "/debug/health"))["counters"].get(
        "read_index", {})


def deposed_leader_reads(cluster, clients) -> dict:
    """Step 7's read through a deposed leader: dcw (SHARD 1 REPLICA 3) is
    led on node S, and S's raft is cut both ways (S's raft messages fail,
    and so do the other two nodes' raft messages to S; every scan still
    answers). The other two elect L and keys are acked through L, while
    S, which hears no higher term, still leads in its own view. One
    read through S's HTTP, with no wait: S's read index refuses (its
    round reaches no peer), and the read goes to the other members as a
    leader read. It must hold every acked key and no key that was never
    written, or fail within its deadline (the step prints which), and S
    must book at least one read-index not_leader. The acked keys S's own
    replica lacks are logged. Then the cut heals, S catches up, and no
    vnode is BROKEN in any node's view of meta. → the step's JSON."""
    from cnosdb_tpu_torch.parallel.net import rpc_call

    owner = "cnosdb.dcw"
    owners = ("cnosdb.tsbs", "cnosdb.dcw", "cnosdb.dcx")
    (rs,) = replica_sets(cluster.nodes[0], (owner,))
    gid = str(rs["id"])
    by_id = {n.node_id: n for n in cluster.nodes}
    wait_leaders(cluster, {owner: 1})
    s_id, s_vid = live_leaders(cluster, owner)[gid]
    s_node = by_id[s_id]
    others = [n for n in cluster.nodes if n is not s_node]
    cut = {s_node: f"seed={NEMESIS_SEED};rpc.send:fail:if=raft_msg"}
    cut.update({n: f"seed={NEMESIS_SEED};rpc.send:fail:if=127.0.0.1:"
                   f"{s_node.rpc_port} raft_msg" for n in others})

    def faults(specs: dict) -> None:
        for n, spec in specs.items():
            rpc_call(f"127.0.0.1:{n.rpc_port}", "_faults", {"spec": spec},
                     timeout=5.0)

    def s_member() -> dict:
        (m,) = [m for k, m in json.loads(s_node.http(
            "GET", "/debug/health"))["raft_members"].items()
            if k.startswith(f"{owner}/{gid}#")]
        return m

    t0 = time.perf_counter()
    faults(cut)
    try:
        deadline = time.monotonic() + 60.0
        while True:
            at = live_leaders(cluster, owner).get(gid)
            if at is not None and at[0] != s_node.node_id:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"the two nodes cut off from node "
                                     f"{s_node.node_id} elected no leader "
                                     f"of {owner}")
            time.sleep(0.1)
        elected_s = time.perf_counter() - t0
        l_node = by_id[at[0]]
        before = set(clients.acked)
        clients.write(l_node, 10)
        new = clients.acked - before
        if not new:
            raise AssertionError(f"no key acked through node "
                                 f"{l_node.node_id}")
        s_raft = s_member()
        ri0, lr0 = read_index_counts(s_node), leader_read_counts(s_node)
        stream = f"r{s_node.node_id}"
        e = clients.rec.invoke(stream, "read", durable=False, mono=True)
        t = time.perf_counter()
        try:
            keys, failed = table_keys(s_node), None
            clients.rec.ok(stream, e, keys=sorted(keys))
        except AssertionError as ex:
            keys, failed = None, str(ex)[-300:]
            clients.rec.fail(stream, e, failed[:200])
        read_ms = (time.perf_counter() - t) * 1e3
        ri1, lr1 = read_index_counts(s_node), leader_read_counts(s_node)
        # S's own replica (S's own reads never scan it: it refuses)
        s_keys = replica_keys(s_node, owner, s_vid)
    finally:
        faults({n: f"seed={NEMESIS_SEED}" for n in cluster.nodes})
    refused = {k: ri1.get(k, 0) - ri0.get(k, 0)
               for k in ("confirmed", "not_leader", "apply_waits",
                         "rounds", "wait_us")}
    redirected = {k: lr1.get(k, 0) - lr0.get(k, 0)
                  for k in ("read", "redirect", "no_leader")}
    where = (f"node {s_node.node_id} (deposed leader of {owner}, raft "
             f"{s_raft['role']} in term {s_raft['term']}; node "
             f"{l_node.node_id} leads)")
    if s_raft["role"] != "leader":
        raise AssertionError(f"{where}: it no longer led in its own view "
                             "at the read, so no deposed leader was read")
    if refused["not_leader"] < 1:
        raise AssertionError(f"{where}: its read index refused no read: "
                             f"{refused}")
    written = {f"w{i}" for i in range(clients.n)}
    if keys is not None:
        missing = clients.acked - keys
        if missing or not keys <= written:
            raise AssertionError(
                f"{where}: its read misses {len(missing)} acked keys "
                f"{sorted(missing)[:5]} and holds {sorted(keys - written)} "
                f"never written (read index {refused}, leader reads "
                f"{redirected})")
    lacks = len(new - s_keys)
    if not lacks:
        raise AssertionError(f"{where}: its own replica holds every key "
                             "acked through the new leader: the cut forced "
                             "no lag")
    caught_s = wait_caught_up(s_node, owners, others)
    check_no_marks(cluster, owners, f"node {s_node.node_id}'s raft cut "
                   "healed")
    res = {"deposed_node": s_node.node_id, "leader_node": l_node.node_id,
           "elected_s": elected_s, "acked_keys": len(clients.acked),
           "new_keys": len(new), "read_ms": read_ms,
           "read": "answered" if failed is None else "failed",
           "read_error": failed, "read_index": refused,
           "leader_reads": redirected, "deposed_lacks": lacks,
           "caught_up_s": caught_s}
    log(f"# deposed leader read: {owner}'s leader node {s_node.node_id} "
        f"cut off from raft both ways (its scans up), node "
        f"{l_node.node_id} elected after {elected_s:.2f}s, {len(new)} keys "
        f"acked through it; node {s_node.node_id} still led in its own "
        f"view (term {s_raft['term']}); its one read with no wait "
        + (f"({read_ms:.1f} ms) holds all {len(clients.acked)} acked keys "
           "and none never written"
           if failed is None else
           f"failed within its deadline after {read_ms:.1f} ms: {failed}")
        + f"; its read index {refused}, its leader reads {redirected}; "
        f"its own replica lacked {lacks} acked keys; healed, caught up "
        f"in {caught_s:.2f}s, no vnode BROKEN")
    print(json.dumps({"deposed_leader_reads": res}), flush=True)
    return res


def failover_reads(cluster, clients) -> dict:
    """Step 7's failover read: dcw (SHARD 1 REPLICA 3) is led on node L,
    and L's raft messages to the follower F are delayed by
    FAILOVER_RAFT_DELAY_MS, so F's replica lags. Keys are acked through
    L, then F's scan RPCs to L's node fail, and one read goes through
    F's HTTP with no wait: its plan names L, L does not answer, and the
    read fails over to the members that confirm it, F's own member first
    (a local replica ranks first). F serves only after its follower read
    index (it asks L over raft, then waits for its apply). The read must
    hold every acked key and no key that was never written; F's
    follower confirmations (or refusals) and its apply wait are booked
    and printed, with the acked keys F's own replica lacked just before
    the read (what an unchecked failover read would have answered). →
    the step's JSON."""
    from cnosdb_tpu_torch.parallel.net import rpc_call

    owner = "cnosdb.dcw"
    (rs,) = replica_sets(cluster.nodes[0], (owner,))
    gid = str(rs["id"])
    by_id = {n.node_id: n for n in cluster.nodes}
    wait_leaders(cluster, {owner: 1})
    l_id, _l_vid = live_leaders(cluster, owner)[gid]
    l_node = by_id[l_id]
    f_node, f_vid = next((by_id[v["node_id"]], v["id"]) for v in rs["vnodes"]
                         if v["node_id"] != l_id)
    wait_caught_up(f_node, (owner,), (l_node,))
    specs = {l_node: f"seed={NEMESIS_SEED};rpc.send:delay("
                     f"{FAILOVER_RAFT_DELAY_MS}):if=127.0.0.1:"
                     f"{f_node.rpc_port} raft_msg"}
    t0 = time.perf_counter()
    try:
        rpc_call(f"127.0.0.1:{l_node.rpc_port}", "_faults",
                 {"spec": specs[l_node]}, timeout=5.0)
        before = set(clients.acked)
        clients.write(l_node, 10)
        new = clients.acked - before
        if not new:
            raise AssertionError(f"no key acked through node {l_id}")
        specs[f_node] = (f"seed={NEMESIS_SEED};rpc.send:fail:if=127.0.0.1:"
                         f"{l_node.rpc_port} scan_vnode")
        rpc_call(f"127.0.0.1:{f_node.rpc_port}", "_faults",
                 {"spec": specs[f_node]}, timeout=5.0)
        (f_applied,) = [a for *_r, a in raft_state(f_node,
                                                   (owner,)).values()]
        (l_applied,) = [a for *_r, a in raft_state(l_node,
                                                   (owner,)).values()]
        f_lacks = len(new - replica_keys(f_node, owner, f_vid))
        ri0, lr0 = read_index_counts(f_node), leader_read_counts(f_node)
        t = time.perf_counter()
        keys = clients.read(f_node)
        read_ms = (time.perf_counter() - t) * 1e3
        ri1, lr1 = read_index_counts(f_node), leader_read_counts(f_node)
    finally:
        for n in specs:
            rpc_call(f"127.0.0.1:{n.rpc_port}", "_faults",
                     {"spec": f"seed={NEMESIS_SEED}"}, timeout=5.0)
    step_s = time.perf_counter() - t0
    confirms = {k: ri1.get(k, 0) - ri0.get(k, 0)
                for k in ("follower_confirmed", "follower_refused",
                          "follower_apply_us", "confirmed", "not_leader")}
    reads = {k: lr1.get(k, 0) - lr0.get(k, 0)
             for k in ("read", "redirect", "no_leader")}
    missing = clients.acked - keys
    written = {f"w{i}" for i in range(clients.n)}
    where = (f"node {f_node.node_id}'s failover read of {owner} (leader "
             f"node {l_id} unreachable for its scans; its own replica "
             f"{FAILOVER_RAFT_DELAY_MS} ms behind over raft, applied "
             f"{f_applied} against the leader's {l_applied})")
    if missing or not keys <= written:
        raise AssertionError(
            f"{where}: misses {len(missing)} acked keys "
            f"{sorted(missing)[:5]} and holds {sorted(keys - written)} "
            f"never written (read index {confirms}, leader reads {reads})")
    if not confirms["follower_confirmed"] + confirms["follower_refused"]:
        raise AssertionError(f"{where}: no follower read index was booked "
                             f"on the node: {confirms}")
    res = {"leader_node": l_id, "reader_node": f_node.node_id,
           "raft_delay_ms": FAILOVER_RAFT_DELAY_MS,
           "acked_keys": len(clients.acked), "new_keys": len(new),
           "reader_applied": f_applied, "leader_applied": l_applied,
           "reader_replica_lacked": f_lacks, "read_ms": read_ms,
           "read_index": confirms, "leader_reads": reads, "step_s": step_s}
    log(f"# failover read: {where}; {len(new)} keys acked through node "
        f"{l_id}, its own replica lacked {f_lacks} of them at the read; "
        f"its one read with no wait ({read_ms:.1f} ms) holds all "
        f"{len(clients.acked)} acked keys and none never written; its "
        f"read index {confirms}, its leader reads {reads}; step "
        f"{step_s:.2f}s")
    print(json.dumps({"failover_reads": res}), flush=True)
    return res


def check_history(cluster, clients, where: str) -> int:
    """The client history so far against every node's key set once the
    node holds every acked key (or at the timeout) → operations."""
    from cnosdb_tpu_torch.chaos.checker import run_client_checks
    from cnosdb_tpu_torch.chaos.history import History

    hist = History.load(clients.path)
    for n in cluster.nodes:
        final = wait_keys(n, clients.acked, timeout=90.0)
        bad = [r for r in run_client_checks(hist, final) if not r.ok]
        if bad:
            raise AssertionError(f"{where}: node {n.node_id}: " + "; ".join(
                f"{r.name}: {r.detail}" for r in bad))
    return len(hist.ops)


def first_difference(a: str, b: str) -> str:
    """Where two answer texts part: the row count, or the first row
    that differs in each."""
    ra, rb = csv_rows(a), csv_rows(b)
    for i, (x, y) in enumerate(zip(ra, rb)):
        if x != y:
            return f"row {i}: {x} against {y}"
    return f"{len(ra)} rows against {len(rb)}"


def same_rows(a: str, b: str) -> bool:
    """Two answer texts with the same rows: every field equal, or both
    floats within rtol 1e-12 (a float sum's last bits follow which node
    merged which partials)."""
    ra, rb = csv_rows(a), csv_rows(b)
    if len(ra) != len(rb):
        return False
    for x, y in zip(ra, rb):
        if len(x) != len(y):
            return False
        for u, v in zip(x, y):
            if u != v and not ("." in u and "." in v and np.isclose(
                    float(u), float(v), rtol=1e-12, atol=0)):
                return False
    return True


def cluster_phase(seed: int, rows: int, placement: str | None = None) -> dict:
    """Step 7: the port's server entry point as a three-node cluster
    through the chaos plane. `placement` None puts the nodes and the
    sweep's workloads on the card (the default of every port process);
    anything raises on the first failure."""
    from cnosdb_tpu_torch.chaos import nemesis
    from cnosdb_tpu_torch.parallel.net import rpc_call

    root = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    env = cluster_env(placement)
    cluster = LocalCluster(root, 3, env)
    out: dict = {}
    try:
        # boot
        t = time.perf_counter()
        cluster.start()
        out["boot_s"] = time.perf_counter() - t
        log(f"# cluster: meta + 3 query_tskv nodes up in "
            f"{out['boot_s']:.2f}s (env {CLUSTER_ENV}, placement "
            f"{placement or 'the card'})")
        n1 = cluster.nodes[0]
        n1.sql("CREATE DATABASE tsbs WITH SHARD 4 REPLICA 3", db="public")
        n1.sql("CREATE DATABASE dcw WITH SHARD 1 REPLICA 3", db="public")
        # one replica set on two of the three nodes: the third node's
        # reads of it are leader reads
        n1.sql("CREATE DATABASE dcx WITH SHARD 1 REPLICA 2", db="public")

        # data: line protocol over HTTP, batches spread over the nodes
        data = Data(seed, rows)
        batches = tsbs_lines(data)
        t = time.perf_counter()

        retried = []

        def post(i):
            # a batch that raft did not commit before a leadership change
            # was not acked: the client sends it again (rewriting the same
            # points is idempotent); any other failure ends the phase
            for attempt in range(6):
                try:
                    cluster.nodes[i % 3].write_lp(batches[i], db="tsbs")
                    return
                except AssertionError as e:
                    if attempt == 5 or not any(
                            m in str(e) for m in RETRIED_WRITE_ERRORS):
                        raise
                    retried.append(str(e)[-100:])

        # the first batch creates the replica sets: the rest go three at
        # a time once every set has its leader
        post(0)
        wait_leaders(cluster, {"cnosdb.tsbs": 4})
        with ThreadPoolExecutor(max_workers=3) as pool:
            list(pool.map(post, range(1, len(batches))))
        acked_s = time.perf_counter() - t
        for n in cluster.nodes:
            deadline = time.monotonic() + 300
            while True:
                c = int(csv_rows(n.sql("SELECT count(*) FROM cpu"))[0][0])
                if c == data.rows:
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"node {n.node_id} holds {c} of "
                                         f"{data.rows} rows")
                time.sleep(0.5)
        seen_s = time.perf_counter() - t
        for n in cluster.nodes:
            n.sql("FLUSH")
            n.sql("COMPACT DATABASE tsbs")
        out["ingest_rows_per_s"] = data.rows / acked_s
        log(f"# cluster ingest: {data.rows} rows in {len(batches)} "
            f"batches of {LP_BATCH} lines over HTTP, acked in "
            f"{acked_s:.2f}s ({data.rows / acked_s:.0f} rows/s; "
            f"{len(retried)} sent again after a leadership change "
            f"{retried[:2]}), on every "
            f"replica after {seen_s:.2f}s, flushed and compacted")

        # baseline: every query on every node against the oracle. Scans
        # follow the live raft leaders. The node holding tsbs's static
        # leaders (home) reads first, with every set led from it, so its
        # reads are all-local as they were when scans read the static
        # leaders: a node whose first reads took remote splits answers
        # later all-local reads on the legacy path a few ulps off the
        # mesh lane (the partials its legacy reads cached). Then the sets'
        # leadership is spread so that every other node leads one and
        # decodes its own files on its first read
        home = static_leaders_node(cluster, "cnosdb.tsbs")
        moved = lead_on(cluster, "cnosdb.tsbs", home)
        baseline: dict = {}
        ms_of: dict = {}
        spread = None
        for n in [home] + [n for n in cluster.nodes if n is not home]:
            if n is not home and spread is None:
                spread = spread_leaders(cluster, "cnosdb.tsbs")
            baseline[n.node_id] = {}
            for name, q in CLUSTER_SQL.items():
                t = time.perf_counter()
                text = n.sql(q)
                ms_of[n.node_id, name] = (time.perf_counter() - t) * 1e3
                check_cluster_answer(name, text, data)
                baseline[n.node_id][name] = text
        out["query_ms"] = {name: [round(ms_of[n.node_id, name], 1)
                                  for n in cluster.nodes]
                           for name in CLUSTER_SQL}
        log(f"# cluster baseline: tsbs's raft leaders on node "
            f"{home.node_id} ({moved} stepdowns) for its reads, then "
            f"spread over the nodes ({spread} stepdowns); "
            f"{list(CLUSTER_SQL)} on every node, each against the numpy "
            f"oracle; ms by node (cold) "
            f"{out['query_ms']}; distinct answer texts across the nodes "
            + str({name: len({baseline[n.node_id][name]
                              for n in cluster.nodes})
                   for name in CLUSTER_SQL}))
        dd0 = {n.node_id: n.metric("cnosdb_device_decode_total",
                                   lane="device", reason="ok")
               for n in cluster.nodes}
        log(f"# cluster device decode pages (lane device, ok) by node: "
            f"{dd0}")
        if placement is None:
            # in a container nvidia-smi may list its processes under
            # other pids than the container's: a node shows its CUDA
            # context by the NVIDIA device files it holds open
            fds = {n.node_id: nvidia_fds(n.proc.pid) for n in cluster.nodes}
            if not all(fds.values()):
                raise AssertionError(f"a node holds no NVIDIA device file "
                                     f"open: {fds}")
            log("# cluster nodes on the card: /dev/nvidia* files open by "
                f"node {fds}; cached device uploads by node (bytes) "
                + str({n.node_id: n.metric("cnosdb_memory_pool_bytes",
                                           pool="device_uploads")
                       for n in cluster.nodes})
                + f"; nvidia-smi compute apps: {gpu_apps()}")
        if not all(dd0.values()):
            raise AssertionError(f"a node's cold scan decoded no page on "
                                 f"the device lane: {dd0}")

        # device_loss on a node whose mesh lane engages, clients on
        owners = ("cnosdb.tsbs", "cnosdb.dcw")
        clients = Clients(os.path.join(root, "history.jsonl"))
        clients.write(n1, 10)
        plan = nemesis.generate_plan(NEMESIS_SEED, n_nodes=3, steps=3,
                                     kinds=("device_loss",))
        ctx = nemesis.describe(plan, NEMESIS_SEED)
        losses = []
        # the all-local answer: byte-identical wherever every scan is
        # local, whichever lane merges it. Scans follow the live raft
        # leaders, so only the node that leads every tsbs set reads
        # all-local: the sets' leadership is gathered on home again, and
        # held there before each all-local read
        local_ref = None
        moved = 0
        for ev in plan:
            moved += lead_on(cluster, "cnosdb.tsbs", home)
            victim, answers = engaging_node(cluster, ev.node, data)
            if victim is None:
                raise AssertionError(f"{ctx} step {ev.step}: no node's mesh "
                                     "lane engages")
            local_ref = local_ref or answers
            if answers != local_ref:
                raise AssertionError(f"{ctx} step {ev.step}: node "
                                     f"{victim.node_id}'s all-local answers "
                                     "differ from the first ones")
            vspec, ospec = nemesis.event_specs(
                ev, f"127.0.0.1:{victim.rpc_port}", NEMESIS_SEED)
            assert ospec == "", ospec
            # scans local: a split that a moved raft leader took to a peer
            # fails over to the victim's own replica, and the lane engages
            vspec += ";" + SCANS_LOCAL
            off0 = victim.metric("cnosdb_mesh_total", reason="off_mesh")
            rpc_call(f"127.0.0.1:{victim.rpc_port}", "_faults",
                     {"spec": vspec}, timeout=5.0)
            try:
                # every answer whose collective died (device_loss booked:
                # its scans were all local) must be the all-local answer,
                # byte for byte; one that a remote split kept off the
                # lane is held to the oracle
                tries = lost = 0
                while lost < len(CLUSTER_SQL):
                    tries += 1
                    if tries > 10:
                        off = victim.metric("cnosdb_mesh_total",
                                            reason="off_mesh") - off0
                        raise AssertionError(
                            f"{ctx} step {ev.step}: device_loss never "
                            f"booked (node {victim.node_id} declined "
                            f"off_mesh {off} times since it was armed)")
                    for name, q in CLUSTER_SQL.items():
                        before = victim.metric("cnosdb_mesh_total",
                                               reason="device_loss")
                        text = victim.sql(q)
                        check_cluster_answer(name, text, data)
                        if victim.metric("cnosdb_mesh_total",
                                         reason="device_loss") == before:
                            continue
                        lost += 1
                        if text != local_ref[name]:
                            raise AssertionError(
                                f"{ctx} step {ev.step}: node "
                                f"{victim.node_id} {name} differs from the "
                                "all-local answer, "
                                + first_difference(text, local_ref[name]))
                healthy = [n for n in cluster.nodes if n is not victim]
                clients.write(healthy[0], 5)
                for n in cluster.nodes:
                    clients.read(n)
            finally:
                rpc_call(f"127.0.0.1:{victim.rpc_port}", "_faults",
                         {"spec": nemesis.heal_spec(NEMESIS_SEED, ev)},
                         timeout=5.0)
            check_no_marks(cluster, owners, f"{ctx} step {ev.step} healed")
            moved += lead_on(cluster, "cnosdb.tsbs", home)
            healed, answers = engaging_node(cluster, ev.node, data)
            if healed is None or answers != local_ref:
                raise AssertionError(f"{ctx} step {ev.step}: the lane "
                                     "stayed declined after heal, or its "
                                     "answers changed")
            losses.append((victim.node_id, tries, lost))
        out["device_loss"] = {
            n.node_id: n.metric("cnosdb_mesh_total", reason="device_loss")
            for n in cluster.nodes}
        out["mesh_engaged"] = {
            n.node_id: n.metric("cnosdb_mesh_total", reason="engaged")
            for n in cluster.nodes}
        log(f"# device_loss ({ctx}): tsbs's raft leaders held on node "
            f"{home.node_id} ({moved} stepdowns); victims (node, rounds of "
            f"the 3 queries, answers with device_loss booked) {losses}; those "
            f"answers byte-identical to the all-local ones, every answer "
            f"oracle-checked; no vnode BROKEN in any node's view of meta "
            f"and the lane engaged again after each heal with the same "
            f"answers; cnosdb_mesh_total device_loss "
            f"{out['device_loss']}, engaged {out['mesh_engaged']}")

        # read-your-writes through a node that does not lead
        out["read_your_writes"] = read_your_writes(cluster, clients)
        # read-your-writes through a node that holds no member
        out["outsider_reads"] = outsider_reads(cluster)
        # read-your-writes through a leader cut off from raft
        out["deposed_leader_reads"] = deposed_leader_reads(cluster, clients)
        # a failover read: the leader unreachable for the reader's scans,
        # its own replica lagging, served only once it confirms
        out["failover_reads"] = failover_reads(cluster, clients)

        # partition: a symmetric partition around one node. The other two
        # answer every query (a group the cut-off node led elects a new
        # leader first) and take the clients' writes. The cut-off node
        # can confirm no read of a replicated group: its read index, as a
        # leader or a follower, reaches no peer, and no other member
        # answers it, so each of its queries either holds every acked row
        # or fails with the leader-read error within LEADERLESS_READ_S
        # and a second, a refusal booked on the node (`victim_refused`);
        # its replicas are never read unconfirmed. After the heal no
        # replica stays shunned (no mark in any node's view of meta), so
        # the node holding tsbs's live raft leaders reads all-local, its
        # lane engaging on the first pass
        from cnosdb_tpu_torch.parallel.coordinator import LEADERLESS_READ_S

        refusal_limit_s = LEADERLESS_READ_S + REFUSAL_SLACK_S
        ev = nemesis.generate_plan(NEMESIS_SEED, n_nodes=3, steps=1,
                                   kinds=("partition",))[0]
        victim = cluster.nodes[ev.node]
        survivors = [n for n in cluster.nodes if n is not victim]
        vspec, ospec = nemesis.event_specs(
            ev, f"127.0.0.1:{victim.rpc_port}", NEMESIS_SEED)
        t = time.perf_counter()
        try:
            for n in cluster.nodes:
                rpc_call(f"127.0.0.1:{n.rpc_port}", "_faults",
                         {"spec": vspec if n is victim else ospec},
                         timeout=5.0)
            # the survivors, then the victim (its scan and raft RPCs
            # fail: a failed reach to each peer)
            part_ms, refused = {}, {}
            for n in survivors + [victim]:
                for name, q in CLUSTER_SQL.items():
                    t1 = time.perf_counter()
                    ri0 = read_index_counts(n)
                    try:
                        text = n.sql(q)
                    except AssertionError as ex:
                        ms = (time.perf_counter() - t1) * 1e3
                        ri1 = read_index_counts(n)
                        booked = {k: ri1.get(k, 0) - ri0.get(k, 0)
                                  for k in ("not_leader",
                                            "follower_refused")}
                        if n is not victim or "no raft leader of the " \
                                "replica set" not in str(ex) or \
                                not sum(booked.values()) or \
                                ms > refusal_limit_s * 1e3:
                            raise
                        refused[name] = {"ms": round(ms, 1),
                                         "refusals": booked,
                                         "error": str(ex)[-200:]}
                    else:
                        check_cluster_answer(name, text, data)
                    part_ms.setdefault(name, []).append(
                        round((time.perf_counter() - t1) * 1e3, 1))
            reach = {k: b["consecutive_failures"] for k, b in json.loads(
                victim.http("GET", "/debug/health"))["breakers"].items()}
            failed0 = clients.failed
            clients.write(survivors[0], 5)
            for n in survivors:
                clients.read(n)
        finally:
            for n in cluster.nodes:
                rpc_call(f"127.0.0.1:{n.rpc_port}", "_faults",
                         {"spec": nemesis.heal_spec(NEMESIS_SEED, ev)},
                         timeout=5.0)
        cut_s = time.perf_counter() - t
        check_no_marks(cluster, owners, f"partition of node "
                       f"{victim.node_id} healed")
        leader, moved = leaders_node(cluster, "cnosdb.tsbs")
        healed, answers = engaging_node(cluster,
                                        cluster.nodes.index(leader), data)
        if healed is not leader or answers != local_ref:
            raise AssertionError(
                f"partition of node {victim.node_id} healed: the live "
                f"leaders' node {leader.node_id}'s lane did not engage "
                "first, or its answers differ from the all-local ones "
                f"(engaged: {healed and healed.node_id})")
        for n in cluster.nodes:
            clients.read(n)
        n_ops = check_history(cluster, clients, f"partition of node "
                              f"{victim.node_id} healed")
        victim_ms = {name: ms[-1] for name, ms in part_ms.items()}
        out["partition"] = {"node": victim.node_id, "cut_s": cut_s,
                            "query_ms": part_ms, "victim_ms": victim_ms,
                            "victim_failed": reach,
                            "victim_refused": refused,
                            "leaders_node": leader.node_id,
                            "stepdowns": moved}
        log(f"# partition (nemesis seed={NEMESIS_SEED}, "
            f"{ev.kind}@n{ev.node}): node {victim.node_id} cut off from "
            f"its peers both ways for {cut_s:.2f}s; nodes "
            f"{[n.node_id for n in survivors]} answered every query, each "
            f"against the oracle; node {victim.node_id} answered "
            f"{sorted(set(CLUSTER_SQL) - set(refused))} against the oracle "
            f"and refused {sorted(refused)} with the leader-read error, "
            f"each within {refusal_limit_s:.1f}s (victim ms {victim_ms}; "
            f"refusals {refused or 'none'}) (ms by node {part_ms}; "
            f"the victim's RPCs failed in a row, by peer: {reach}); 5 keys "
            f"written "
            f"through node {survivors[0].node_id} "
            f"({clients.failed - failed0} writes failed by a leadership "
            f"change); after the heal no vnode BROKEN in any node's view "
            f"of meta, the live leaders' node {leader.node_id} ({moved} "
            f"stepdowns to gather them) engaged its lane first with the "
            f"all-local answers, and the history "
            f"checker ({n_ops} operations) green on every node")

        # crash_restart: SIGKILL, clients keep going, restart, cold scan
        ev = nemesis.generate_plan(NEMESIS_SEED, n_nodes=3, steps=1,
                                   kinds=("crash_restart",))[0]
        victim = cluster.nodes[ev.node]
        others = [n for n in cluster.nodes if n is not victim]
        t_kill = time.perf_counter()
        victim.kill()
        for i in range(3):
            clients.write(others[i % 2], 5)
            for n in others:
                clients.read(n)
        t = time.perf_counter()
        victim.start()
        victim.wait_ready()
        restart_s = time.perf_counter() - t
        # leader-follow routing sends a restarted follower's scans to the
        # replica leaders, whose caches are warm: fail its scan RPCs to
        # its peers, so that every split fails over to its own replica
        # and its first read is its own cold scan, as it comes back
        scans_local(victim, True)
        try:
            # catch-up: rounds of the three queries while raft brings the
            # node's replicas up to date; tsbs did not change while the
            # node was down, so every answer holds to the oracle
            overlap0 = victim.metric("cnosdb_decode_fallback_total",
                                     reason="memcache_overlap")
            rounds, first_s, dd_first, behind = 0, None, None, 0
            while True:
                state = raft_state(victim, owners)
                behind += not caught_up(state)
                for name, q in CLUSTER_SQL.items():
                    check_cluster_answer(name, victim.sql(q), data)
                    if first_s is None:
                        first_s = time.perf_counter() - t_kill
                rounds += 1
                if dd_first is None:
                    dd_first = victim.metric("cnosdb_device_decode_total",
                                             lane="device", reason="ok")
                    overlap = victim.metric(
                        "cnosdb_decode_fallback_total",
                        reason="memcache_overlap") - overlap0
                if (caught_up(state) and rounds >= 2) or rounds >= 20:
                    break
            if dd_first <= 0 or overlap:
                raise AssertionError(
                    f"node {victim.node_id}'s first read after the restart "
                    f"decoded {dd_first} pages on the device lane and sent "
                    f"{overlap} pages to the memcache-overlap host path")
            caught_up_s = wait_caught_up(victim, owners, others)
            mem = victim.metric("cnosdb_memory_pool_bytes", pool="memcache")
            if mem >= MEMCACHE_LIMIT:
                raise AssertionError(f"node {victim.node_id} holds {mem} B "
                                     "in its memory cache after catch-up")
            answers = {name: victim.sql(q)
                       for name, q in CLUSTER_SQL.items()}
        finally:
            scans_local(victim, False)
        # reading only its own replicas, the caught-up node must give
        # the all-local answer, byte for byte
        for name, text in answers.items():
            check_cluster_answer(name, text, data)
            if text != local_ref[name]:
                raise AssertionError(
                    f"node {victim.node_id} {name} after the restart "
                    "differs from the all-local answer")
        check_no_marks(cluster, owners, f"node {victim.node_id} restarted")
        dd = victim.metric("cnosdb_device_decode_total", lane="device",
                           reason="ok")
        for n in cluster.nodes:
            clients.read(n)
        out["restart_s"], out["crash_to_first_answer_s"] = restart_s, first_s
        out["catch_up"] = {"rounds": rounds, "rounds_behind": behind,
                           "caught_up_s": caught_up_s, "memcache_bytes": mem}
        log(f"# crash_restart node {victim.node_id}: SIGKILL, 15 writes "
            f"through the other two, restarted in {restart_s:.2f}s, first "
            f"answer {first_s:.2f}s after the kill with no flush or "
            f"compaction ({dd_first} pages decoded on the device lane, "
            f"{overlap} sent to the memcache-overlap host path); "
            f"{rounds} rounds of the 3 queries during catch-up "
            f"({behind} with a replica behind), every answer HTTP 200 and "
            f"oracle-checked; its replica sets caught up "
            f"{caught_up_s:.2f}s after the rounds with {mem} B in its "
            f"memory cache; its reads on its own replicas (scan RPCs to "
            f"its peers failed), answers byte-identical to the all-local "
            f"ones, no vnode BROKEN in any node's view of meta; device "
            f"decode pages (lane device, ok) {dd}")

        # the client history against every node's final state
        clients.rec.close()
        n_ops = check_history(cluster, clients, "end")
        log(f"# client checks: {n_ops} recorded operations, "
            f"{len(clients.acked)} acked keys, {clients.failed} writes "
            f"failed by a leadership change; no lost acked write, no "
            "resurrection, read-your-writes, monotonic reads on every node")
        out["read_index"] = {n.node_id: read_index_counts(n)
                             for n in cluster.nodes}
        out["leader_read"] = {n.node_id: leader_read_counts(n)
                              for n in cluster.nodes}
        log(f"# reads served as a replicated group's leader, by node "
            f"(read index): {out['read_index']}; leader reads by "
            f"node: {out['leader_read']}")

        # the CLI against HTTP, then --dump-ddl replayed
        cli = [sys.executable, "-m", "cnosdb_tpu_torch.client.cli",
               "--port", str(n1.http_port)]
        q = CLUSTER_SQL["double_groupby_1"]
        r = subprocess.run(cli + ["-d", "tsbs", "-c", q, "--format", "csv"],
                           cwd=REPO_DIR, env=env, capture_output=True,
                           text=True, timeout=300)
        cli_rows = csv_rows(r.stdout)
        http_text = n1.sql(q)
        if r.returncode != 0 or not same_rows(r.stdout, http_text):
            raise AssertionError(f"CLI rc {r.returncode}: its rows differ "
                                 f"from HTTP's; {r.stderr[-2000:]}")
        check_cluster_answer("double_groupby_1", r.stdout, data)
        r = subprocess.run(cli + ["--dump-ddl"], cwd=REPO_DIR, env=env,
                           capture_output=True, text=True, timeout=300)
        ddl = [ln.rstrip(";") for ln in r.stdout.splitlines() if ln.strip()]
        if r.returncode != 0 or not any("tsbs.cpu" in s for s in ddl):
            raise AssertionError(f"--dump-ddl rc {r.returncode}: "
                                 f"{r.stdout[-1000:]} {r.stderr[-1000:]}")
        for s in ddl:
            cluster.nodes[1].sql(s, db="public")
        log(f"# CLI: -c double_groupby_1 --format csv gives the HTTP "
            f"answer's {len(cli_rows)} rows (byte-identical: "
            f"{cli_rows == csv_rows(http_text)}), oracle-checked; "
            f"--dump-ddl gave {len(ddl)} statements, replayed on node 2")
        for n in cluster.nodes:
            n.alive()
    except BaseException:
        for p in cluster.nodes + [cluster.meta]:
            log(f"# {p.name} log tail:\n{p.log_tail()}")
        raise
    finally:
        cluster.stop()
    # the crash sweep, its workload subprocesses with this environment
    out["sweep"] = crash_sweep(root, env)
    shutil.rmtree(root, ignore_errors=True)
    return out


def crash_sweep(root: str, env: dict) -> dict:
    """chaos.sweep over FAST_POINTS: one probe, then one crash at the
    first crossing of each point; every run must die with the crash code,
    recover and pass the checker. → point → MTTR s."""
    from cnosdb_tpu_torch.chaos import sweep

    base = os.path.join(root, "sweep")
    saved = dict(os.environ)
    os.environ.clear()
    os.environ.update(env)          # the workloads inherit this
    os.environ.pop("CNOSDB_FAULTS", None)
    try:
        t = time.perf_counter()
        hits = sweep.probe(base, seed=7, points=list(sweep.FAST_POINTS))
        probe_s = time.perf_counter() - t
        if not all(hits.values()):
            raise AssertionError(f"the probe missed a point: {hits}")
        mttr = {}
        for p in sweep.FAST_POINTS:
            r = sweep.run_one(base, p, 1, seed=7)
            if not (r["crashed"] and r.get("ok")):
                raise AssertionError(
                    f"crash at {p}: rc {r['rc']}, repro {r['repro']}, "
                    f"{r.get('results', r.get('error'))}")
            mttr[p] = r["mttr_s"]
    finally:
        os.environ.clear()
        os.environ.update(saved)
    log(f"# crash sweep (workloads on the caller's placement): probe "
        f"{probe_s:.2f}s, crossings {hits}; every point crashed (rc "
        f"{sweep.CRASH_RC}), recovered and passed the checker; MTTR s "
        f"{mttr} in {time.perf_counter() - t:.2f}s")
    return {"hits": hits, "mttr_s": mttr}


# ---------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--rows", type=int, default=10_000_000)
    # a tenth of ClickBench's 99,997,497 rows would not fit the run's time
    # limit beside the other phases (every query runs three times); 4.5 M
    # still takes the all-rows DISTINCT past the 4,194,304-row chunk
    ap.add_argument("--hits-rows", type=int, default=4_500_000)
    # TSBS devops cpu-only at scale 100 for one day (10 s points)
    ap.add_argument("--cluster-rows", type=int, default=864_000)
    # phase 6b: bench_suites.py's IoT-shaped table at TSBS's
    # --scale=4000 trucks, 10 s apart for 4 h (1,440 readings a truck);
    # log search takes suite_rows // 4 spans, the dashboard and the cold
    # scan 10 steps of suite_rows // 100 and suite_rows // 50 rows. Both
    # depths are cut so that the whole script keeps its margin under the
    # 1,200 s limit beside phase 6c
    ap.add_argument("--iot-scale", type=int, default=4000)
    ap.add_argument("--iot-points", type=int, default=1440)
    ap.add_argument("--suite-rows", type=int, default=6_000_000)
    # phase 6c: the mesh sweep over 32 hosts x 48 one-hour buckets, a
    # tenth of bench.py's 100 M rows as the TSBS phases take
    ap.add_argument("--mesh-rows", type=int, default=10_000_000)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import cnosdb_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import cnosdb_tpu_torch: {e}",
              file=sys.stderr)
        return 2
    os.environ["CNOSDB_SERVING"] = "0"   # repeats reach the operators
    # the main path is the legacy per-vnode path on any number of cards;
    # the mesh phase turns the lane on for its own queries
    os.environ["CNOSDB_MESH"] = "0"
    import bench_suites_torch as bst
    from cnosdb_tpu_torch.ops import cuda_build
    from cnosdb_tpu_torch.ops import device_decode as dd
    from cnosdb_tpu_torch.ops import fused
    from cnosdb_tpu_torch.ops import pallas_kernels as pk
    from cnosdb_tpu_torch.ops.placement import scan_device
    from cnosdb_tpu_torch.parallel.coordinator import Coordinator
    from cnosdb_tpu_torch.parallel.meta import MetaStore
    from cnosdb_tpu_torch.sql.executor import QueryExecutor, Session
    from cnosdb_tpu_torch.storage import native
    from cnosdb_tpu_torch.storage.engine import TsKv
    from cnosdb_tpu_torch.utils.memory_pool import MemoryPool

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"# card: {smi}")
    dev = scan_device()
    if dev.type != "cuda":
        raise AssertionError(f"scan device is {dev}, not cuda")

    # 2. build the kernels (and the native host codecs beside them)
    t0 = time.perf_counter()
    native_ok = {}
    th = threading.Thread(target=lambda: native_ok.setdefault(
        "ok", native.available()))
    th.start()
    secs = cuda_build.build_all()
    th.join()
    log(f"# build: {time.perf_counter() - t0:.2f}s wall; nvcc "
        + ", ".join(f"{k} {v:.2f}s" for k, v in secs.items())
        + f"; native host codecs {'ok' if native_ok.get('ok') else 'absent'}")
    for name, text in cuda_build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"# ptxas {name}: {line.strip()}")

    data = Data(args.seed, args.rows)
    d = tempfile.mkdtemp(prefix="chip_smoke_")
    coord = None
    try:
        meta = MetaStore(d + "/meta.json")
        pool = MemoryPool(32 << 30)
        coord = Coordinator(meta, TsKv(d + "/data"), memory_pool=pool)
        ex = QueryExecutor(meta, coord, memory_pool=pool)
        s = Session(database="public")
        ex.execute_one(f"ALTER DATABASE public SET SHARD {SHARDS}", s)

        # 3 + 4. the main path, counts zeroed just before it
        pk.launches = 0
        pk.launch_shapes.clear()
        dd.xor_launches = 0
        dd.xor_launch_shapes.clear()
        fused_before = fused.launch_count
        ingest_s, compact_s = ingest(coord, data)
        log(f"# ingest: {data.rows} rows in {ingest_s:.2f}s "
            f"({data.rows / ingest_s:.0f} rows/s); compaction "
            f"{compact_s:.2f}s")

        def run(name, sql, check, clear=False):
            if clear:
                bst.clear_scan_cache(coord)
            k1, k2 = pk.launches, dd.xor_launches
            t = time.perf_counter()
            rs = ex.execute_one(sql, s)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            check(rs)
            log(f"# query {name}: {ms:.1f} ms, {len(rs.columns[0])} rows, "
                f"K1 +{pk.launches - k1}, K2 +{dd.xor_launches - k2}, "
                "matches the numpy oracle")
            base = name.split(" ")[0]
            if name.endswith("(warm)") and base in SQL:
                # the legacy answer the mesh phase is held against
                legacy.setdefault(base, (rs, []))[1].append(round(ms, 3))
            return pk.launches - k1, dd.xor_launches - k2

        legacy: dict = {}
        checks = {
            "double_groupby_1":
                lambda rs: check_groupby(rs, data, {"m": data.user}),
            "double_groupby_all":
                lambda rs: check_groupby(rs, data, {"mu": data.user,
                                                    "ms": data.syst}),
            "last_loc": lambda rs: check_last(rs, data)}
        dg1, dga = checks["double_groupby_1"], checks["double_groupby_all"]
        _k1, k2_cold = run("double_groupby_1 (cold)",
                           SQL["double_groupby_1"], dg1, clear=True)
        run("double_groupby_1 (warm)", SQL["double_groupby_1"], dg1)
        run("double_groupby_1 (warm)", SQL["double_groupby_1"], dg1)
        run("double_groupby_all (first)", SQL["double_groupby_all"], dga)
        run("double_groupby_all (warm)", SQL["double_groupby_all"], dga)
        sql8, lo, hi, hosts = cpu_max_sql(data)
        c8 = lambda rs: check_cpu_max(rs, data, lo, hi, hosts)  # noqa
        run("cpu_max_all_8 (first)", sql8, c8)
        k1_warm, _k2 = run("cpu_max_all_8 (warm)", sql8, c8)
        run("cpu_max_all_8 (warm)", sql8, c8)
        run("last_loc (warm)", SQL["last_loc"], checks["last_loc"])
        launches = {"K1": pk.launches, "K2": dd.xor_launches}
        k1_shapes, k2_shapes = dict(pk.launch_shapes), \
            dict(dd.xor_launch_shapes)
        fused_launches = fused.launch_count - fused_before

        # 9 (main-path half). what the run must have gone through
        outcomes = dd.outcomes_snapshot()
        log(f"# main path: fused launches {fused_launches}, K1 launches "
            f"{launches['K1']} {k1_shapes}, K2 launches {launches['K2']} "
            f"{k2_shapes}, decode outcomes {outcomes}")
        if fused_launches <= 0:
            raise AssertionError("the fused program never launched")
        if k1_warm <= 0:
            raise AssertionError("K1 did not run on the warm cpu_max_all_8")
        if k2_cold <= 0:
            raise AssertionError("K2 did not run on the cold scan")
        if outcomes.get(("host", "kernel_error"), 0):
            raise AssertionError("device decode booked kernel_error pages")

        # where the time goes (after the counts were read)
        for name, sql, clear in (
                ("double_groupby_1 (cold)", SQL["double_groupby_1"], True),
                ("double_groupby_1 (warm)", SQL["double_groupby_1"], False),
                ("cpu_max_all_8 (warm)", sql8, False),
                ("last_loc (warm)", SQL["last_loc"], False)):
            log(f"# profile {name}:")
            profile_query(ex, s, sql,
                          prepare=(lambda: bst.clear_scan_cache(coord))
                          if clear else None)

        # 5. the mesh lane, its own counts zeroed just before it
        mesh_run = mesh_phase(ex, s, coord, data, legacy, checks)

        # 5b. the invariant-analysis plane against the card's sync reports
        analysis_run = analysis_phase(ex, s, coord, checks, sql8, c8)

        # 5c. the graft entry points, their own counts zeroed just before
        graft_run = graft_phase()

        # 5d. both SQL golden corpora, their own counts zeroed just before
        slt_run = sqllogic_phase()

        # 5e. device semantics at size, its own counts zeroed just before
        sem_run = semantics_phase(args.seed, SEM_ROWS)

        # 6. the ClickBench hits path, its own counts zeroed just before it
        t = time.perf_counter()
        hits = build_hits(coord, args.seed, args.hits_rows)
        log(f"# hits ingest: {args.hits_rows} rows (18 BIGINT + 5 STRING "
            f"fields, one series) written, flushed and compacted in "
            f"{time.perf_counter() - t:.2f}s")
        queries, probes = hits_statements(hits)
        t = time.perf_counter()
        hits_run = hits_phase(ex, s, queries, probes)
        log(f"# hits phase: {time.perf_counter() - t:.2f}s for both routes")
        sql_of = {name: sql for name, sql, _c in queries + probes}
        for kind, name in (("probe", "q05d"), ("hits", "q16")):
            log(f"# profile {kind} {name} (device route, warm):")
            profile_query(ex, s, sql_of[name])
    finally:
        if coord is not None:
            coord.close()
        shutil.rmtree(d, ignore_errors=True)

    # 6b. the data-plane suites, their own counts zeroed just before
    torch.cuda.empty_cache()
    suites_run = suites_phase(args.seed, args.iot_scale, args.iot_points,
                              args.suite_rows)

    # 6c. the serving, gray-failure, governance and mesh-sweep suites,
    # their own counts zeroed just before
    torch.cuda.empty_cache()
    suites2_run = suites2_phase(args.seed, args.mesh_rows)

    # 7. the port's server entry point: a three-node cluster on the card,
    # through the chaos plane
    torch.cuda.empty_cache()
    t = time.perf_counter()
    cluster_run = cluster_phase(args.seed, args.cluster_rows)
    log(f"# cluster phase: {time.perf_counter() - t:.2f}s")

    # 8. each kernel at its main-path shape against its plain version
    k1_shape = _most_launched(k1_shapes)
    k2_shape = _most_launched(k2_shapes)
    # the window holds 12 h of each selected host: 4320 rows per series
    k1_series = max(1, k1_shape[0] // (12 * 360))
    r1 = compare_k1(k1_shape, args.seed, dev, n_series=k1_series)
    r2 = compare_k2(k2_shape, args.seed, dev)
    log(f"# K1 at {k1_shape}: ms {r1['ms']:.4f} (CUDA entry on device "
        f"rows, layout staged), kernel_ms {r1['kernel_ms']:.4f} (launch "
        f"alone), call_ms {r1['call_ms']:.4f} (host wrapper, numpy in to "
        f"numpy out), plain {r1['plain_ms']:.4f} ms, library "
        f"{r1['library_ms']:.4f} ms (index_add_ + scatter_reduce_), bound "
        f"{r1['bound_ms']:.6f} ms for {r1['bytes']} B; max |sum - plain| "
        f"{r1['max_abs_err']:.3g}; count/min/max exact, sum rtol 1e-12; "
        "bit-stable over two runs")
    log(f"# K2 at {k2_shape}: ms {r2['ms']:.4f} (gorilla_decode, planes "
        f"in), kernel_ms {r2['kernel_ms']:.4f} (launch alone), scan_ms "
        f"{r2['scan_ms']:.4f} (xor_scan, words in), plain "
        f"{r2['plain_ms']:.4f} ms, bound {r2['bound_ms']:.5f} ms for "
        f"{r2['bytes']} B ({100 * r2['bound_ms'] / r2['ms']:.1f} % of it); "
        "bit-exact; bit-stable over two runs")
    r2b = compare_k2((2, 262144), args.seed + 2, dev)
    log(f"# K2 at (2, 262144): ms {r2b['ms']:.4f}, kernel_ms "
        f"{r2b['kernel_ms']:.4f}, scan_ms {r2b['scan_ms']:.4f}, plain "
        f"{r2b['plain_ms']:.4f} ms, bound {r2b['bound_ms']:.5f} ms")
    big = (data.rows, N_HOSTS * data.nb, "torch.float64")
    rb = compare_k1(big, args.seed + 1, dev, n_series=N_HOSTS, grouped=True,
                    call=False)
    whole_k1 = {"at": list(big), **{k: rb[k] for k in (
        "ms", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
        "max_abs_err")}}
    log(f"# K1 at {big} (whole table, double_groupby layout; not on the "
        f"main path): ms {rb['ms']:.4f}, kernel_ms {rb['kernel_ms']:.4f} "
        f"(plain {rb['plain_ms']:.4f} ms, library {rb['library_ms']:.4f} "
        f"ms, bound {rb['bound_ms']:.5f} ms for {rb['bytes']} B, "
        f"{100 * rb['bound_ms'] / rb['kernel_ms']:.1f} % of it by "
        "kernel_ms)")
    t = time.perf_counter()
    k1_threads(k1_shape, args.seed, k1_series)
    log(f"# K1 from 8 threads at once, 8 inputs at {k1_shape} x 20 calls: "
        f"all match the plain version, bit-stable "
        f"({time.perf_counter() - t:.2f}s)")

    # K1 at the shape the hits phase gave it most: the whole table, one
    # series, a group key drawn anew for every row, BIGINT values
    hits_k1 = None
    if hits_run["K1_shapes"]:
        at = _most_launched(hits_run["K1_shapes"])
        rh = compare_k1(at, args.seed + 3, dev, scattered=at[1] < pk.W_WIN,
                        call_iters=5)
        hits_k1 = {"at": list(at), "launches_at": hits_run["K1_shapes"][at],
                   **{k: rh[k] for k in ("ms", "kernel_ms", "call_ms",
                                         "plain_ms", "library_ms",
                                         "bound_ms", "max_abs_err")}}
        log(f"# K1 at {at} (hits phase, {hits_k1['launches_at']} of its "
            f"{hits_run['K1']} launches): ms {rh['ms']:.4f}, kernel_ms "
            f"{rh['kernel_ms']:.4f}, call_ms {rh['call_ms']:.4f}, plain "
            f"{rh['plain_ms']:.4f} ms, library {rh['library_ms']:.4f} ms, "
            f"bound {rh['bound_ms']:.5f} ms for {rh['bytes']} B "
            f"({100 * rh['bound_ms'] / rh['kernel_ms']:.1f} % of it by "
            f"kernel_ms); max |sum - plain| {rh['max_abs_err']:.3g}; "
            "count/min/max exact, sum rtol 1e-12; bit-stable over two runs")

    # K1 and K2 at the shapes the suites phases gave them most
    suites_k: dict = {}
    suites2_k: dict = {}
    for phase, run, into, seed_at in (("suites", suites_run, suites_k, 4),
                                      ("suites2", suites2_run, suites2_k,
                                       6)):
        for kid, shapes in (("K1", run["K1_shapes"]),
                            ("K2", run["K2_shapes"])):
            if not shapes:
                continue
            at = _most_launched(shapes)
            if kid == "K1":
                r = compare_k1(at, args.seed + seed_at, dev,
                               scattered=at[1] < pk.W_WIN, call_iters=5)
            else:
                r = compare_k2(at, args.seed + seed_at + 1, dev)
            into[kid] = {"at": list(at), "launches_at": shapes[at],
                         "library_ms": r.get("library_ms"),
                         **{k: r[k] for k in ("ms", "kernel_ms", "plain_ms",
                                              "bound_ms", "max_abs_err")}}
            log(f"# {kid} at {at} ({phase} phase, {shapes[at]} of its "
                f"{run['launches'][kid]} launches): ms {r['ms']:.4f}, "
                f"kernel_ms {r['kernel_ms']:.4f}, plain {r['plain_ms']:.4f} "
                "ms, "
                + (f"library {r['library_ms']:.4f} ms, " if kid == "K1"
                   else "")
                + f"bound {r['bound_ms']:.5f} ms for {r['bytes']} B; max "
                f"|err| {r['max_abs_err']:.3g}; bit-stable over two runs")

    x4 = compare_x4(hits_run, hits, args.seed, dev)
    sums = compare_segment_sum(args.seed, dev)

    kernels = [
        {"name": "K1 segment_window", "route": "cuda",
         "source": "cnosdb_tpu_torch/ops/csrc/segment_window.cu",
         "replaces": "cnosdb_tpu/ops/pallas_kernels.py:129",
         "launches": launches["K1"],
         "mesh_launches": mesh_run["launches"]["K1"],
         "graft_launches": graft_run["launches"]["K1"],
         "sqllogic_launches": slt_run["launches"]["K1"],
         "semantics_launches": sem_run["launches"]["K1"],
         "hits_launches": hits_run["K1"], "hits": hits_k1,
         "suites_launches": suites_run["launches"]["K1"],
         "suites": suites_k.get("K1"),
         "suites2_launches": suites2_run["launches"]["K1"],
         "suites2": suites2_k.get("K1"),
         "whole_table": whole_k1,
         "max_abs_err": max(r1["max_abs_err"], rb["max_abs_err"],
                            hits_k1["max_abs_err"] if hits_k1 else 0.0,
                            suites_k.get("K1", {}).get("max_abs_err", 0.0),
                            suites2_k.get("K1", {}).get("max_abs_err", 0.0)),
         "ms": r1["ms"], "kernel_ms": r1["kernel_ms"],
         "call_ms": r1["call_ms"], "plain_ms": r1["plain_ms"],
         "bound_ms": r1["bound_ms"], "bound_by": "bytes",
         "library_ms": r1["library_ms"]},
        {"name": "K2 gorilla_decode / xor_scan", "route": "cuda",
         "source": "cnosdb_tpu_torch/ops/csrc/xor_scan.cu",
         "replaces": "cnosdb_tpu/ops/device_decode.py:210",
         "launches": launches["K2"],
         "mesh_launches": mesh_run["launches"]["K2"],
         "graft_launches": graft_run["launches"]["K2"],
         "sqllogic_launches": slt_run["launches"]["K2"],
         "hits_launches": hits_run["K2"],
         "suites_launches": suites_run["launches"]["K2"],
         "suites": suites_k.get("K2"),
         "suites2_launches": suites2_run["launches"]["K2"],
         "suites2": suites2_k.get("K2"),
         "max_abs_err": r2["max_abs_err"],
         "ms": r2["ms"], "kernel_ms": r2["kernel_ms"],
         "scan_ms": r2["scan_ms"], "plain_ms": r2["plain_ms"],
         "bound_ms": r2["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
    ]
    log(f"# chip_smoke: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"analysis": analysis_run}), flush=True)
    print(json.dumps({"kernels": kernels, "x4": x4, "segment_sum": sums,
                      "cluster": cluster_run}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
