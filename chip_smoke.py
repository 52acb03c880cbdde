"""Smoke run of cnosdb_tpu_torch on one CUDA card: the TSBS devops grouped
scan-aggregate served end to end, on the legacy per-vnode path and on the
mesh execution lane, and both hand-written kernels held against their
plain PyTorch versions.

    python3 chip_smoke.py [--seed 123] [--rows 10000000]

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
  6. each kernel at the shape the main path gave it, on the card, against
     its plain version (twice, for bit-stable output), with its time, the
     plain version's time and its bound;
  7. assertions: scan device is cuda, the fused program launched, K1 ran on
     the warm cpu_max_all_8, K2 on both paths' cold scans, no
     device-decode kernel_error outcome.

Prints a JSON line of per-kernel numbers, the nvidia-smi line, and as its
last line {"ok": true, "device": {...}}. Exits non-zero, printing no result,
when there is no CUDA device, when the package is missing, or when any
phase fails.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
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
            seed: int, nan: bool, nulls: bool):
    """Storage-shaped K1 inputs: `n_series` series-contiguous runs, each
    with ascending time buckets; seg = bucket (cpu_max_all_8 groups by
    hour only) or, `grouped`, series × buckets + bucket (double_groupby).
    Optional NaNs and NULLs."""
    rng = np.random.default_rng(seed)
    per = -(-n // n_series)
    buckets = ns // n_series if grouped else ns
    within = np.arange(per) * buckets // per
    host = np.repeat(np.arange(n_series), per)[:n]
    seg = (np.tile(within, n_series)[:n]
           + (host * buckets if grouped else 0)).astype(np.int32)
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
               grouped: bool = False, call: bool = True) -> dict:
    """K1 at one shape: against its plain version (three data variants,
    twice each for bit-stable output), then timed: `ms` the CUDA entry on
    device-resident rows with its layout staging, `kernel_ms` the launch
    alone over staged buffers, `call_ms` the host wrapper from numpy in
    to numpy out (what aggregate_column_host pays), `plain_ms`."""
    import torch

    from cnosdb_tpu_torch.ops import pallas_kernels as pk

    n, ns, _dt = shape
    worst = 0.0
    timed = None
    for dtype, nan, nulls in (("float64", False, False),
                              ("float64", True, True),
                              ("int64", False, True)):
        vals, valid, seg = k1_case(n, ns, n_series, grouped, dtype, seed,
                                   nan, nulls)
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
        if timed is None:
            timed = (vals, valid, seg, args, layout)
    vals, valid, seg, args, layout = timed
    ms = cuda_ms(lambda: pk.window_partials(*args, layout, ns))
    launch = pk.prepare(*args, layout, ns)
    kernel_ms = cuda_ms(launch, iters=200)
    plain_ms = cuda_ms(lambda: pk.window_partials_plain(*args, layout, ns))
    call_ms = (host_ms(lambda: pk.segment_partials_pallas(vals, valid, seg,
                                                          ns))
               if call else None)
    moved = (n * (8 + 1 + 4)                      # values, valid, seg ids
             + layout.bases.nbytes + layout.slot_off.nbytes
             + layout.fold_pos.nbytes + layout.seg_start.nbytes
             + ns * (4 + 8 * 3))                   # count/sum/min/max out
    return {"ms": ms, "kernel_ms": kernel_ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "max_abs_err": worst,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bytes": moved}


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


def _most_launched(shapes: dict):
    return max(shapes.items(), key=lambda kv: (kv[1], kv[0][0]))[0]


def profile_query(ex, session, sql: str) -> None:
    """One run of `sql` under the stage profiler and torch.profiler: the
    host stage breakdown, the card's busy time against wall time, and the
    kernels that took it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cnosdb_tpu_torch.utils import stages

    qp = stages.QueryProfile()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with stages.profile_scope(qp):
            ex.execute_one(sql, session)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    snap = {k: round(v, 3) for k, v in qp.snapshot().items()
            if k.endswith("_ms")}
    dev = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            # a host op (aten::*) may carry the time of the kernels it
            # launched: count only the device's own events
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            dev.append((us / 1e3, e.key, e.count))
    dev.sort(reverse=True)
    busy = sum(ms for ms, _k, _n in dev)
    log(f"#   stages {snap}")
    if not dev:
        log(f"#   device time: not measured (profiler saw no device "
            f"events); wall {wall:.3f} ms under the profiler")
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


@contextlib.contextmanager
def logical_mesh(devices):
    """Within the block the mesh pool is `devices` (4 × cuda:0: logical
    shards on one card), or the real pool when None."""
    from cnosdb_tpu_torch.ops import placement

    saved = placement.mesh_devices
    if devices is not None:
        placement.mesh_devices = lambda: list(devices)
    try:
        yield
    finally:
        placement.mesh_devices = saved


def mesh_phase(ex, session, coord, data, legacy, checks) -> dict:
    """Step 5: the mesh lane over the ingested table. `legacy` holds the
    pinned path's warm answers and wall times by query name, `checks`
    the oracle checks. Raises on a wrong answer, a decline or a missing
    engagement. → {"launches": {...}, "queries": n}."""
    import torch

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
        with logical_mesh(devices):
            m = mesh.get_mesh()
            log(f"# mesh {label}: {mesh.mesh_size(m)} shards on "
                f"{sorted({str(d) for d in m.devices})}")
            for name, clear in plan:
                if clear:
                    with coord._scan_cache_lock:
                        coord._scan_cache.clear()
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
        ex.execute_one(SQL[name], session)   # its own prep, cached
        profile_query(ex, session, SQL[name])
    for k in MESH_KNOBS:
        os.environ.pop(k, None)
    os.environ["CNOSDB_MESH"] = "0"
    os.environ.pop("CNOSDB_MESH_DEVICES", None)
    return {"launches": launches, "queries": n_queries}


# ---------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--rows", type=int, default=10_000_000)
    args = ap.parse_args(argv)

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
                with coord._scan_cache_lock:
                    coord._scan_cache.clear()
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

        # 7 (main-path half). what the run must have gone through
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
            if clear:
                with coord._scan_cache_lock:
                    coord._scan_cache.clear()
            elif name.startswith("cpu_max"):
                ex.execute_one(sql, s)   # re-warm its own filtered scan
            log(f"# profile {name}:")
            profile_query(ex, s, sql)

        # 5. the mesh lane, its own counts zeroed just before it
        mesh_run = mesh_phase(ex, s, coord, data, legacy, checks)
    finally:
        if coord is not None:
            coord.close()
        shutil.rmtree(d, ignore_errors=True)

    # 6. each kernel at its main-path shape against its plain version
    k1_shape = _most_launched(k1_shapes)
    k2_shape = _most_launched(k2_shapes)
    # the window holds 12 h of each selected host: 4320 rows per series
    k1_series = max(1, k1_shape[0] // (12 * 360))
    r1 = compare_k1(k1_shape, args.seed, dev, n_series=k1_series)
    r2 = compare_k2(k2_shape, args.seed, dev)
    log(f"# K1 at {k1_shape}: ms {r1['ms']:.4f} (CUDA entry on device "
        f"rows, layout staged), kernel_ms {r1['kernel_ms']:.4f} (launch "
        f"alone), call_ms {r1['call_ms']:.4f} (host wrapper, numpy in to "
        f"numpy out), plain {r1['plain_ms']:.4f} ms, bound "
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
    log(f"# K1 at {big} (whole table, double_groupby layout; not on the "
        f"main path): ms {rb['ms']:.4f}, kernel_ms {rb['kernel_ms']:.4f} "
        f"(plain {rb['plain_ms']:.4f} ms, bound {rb['bound_ms']:.5f} ms, "
        f"{100 * rb['bound_ms'] / rb['kernel_ms']:.1f} % of it by "
        "kernel_ms)")
    t = time.perf_counter()
    k1_threads(k1_shape, args.seed, k1_series)
    log(f"# K1 from 8 threads at once, 8 inputs at {k1_shape} x 20 calls: "
        f"all match the plain version, bit-stable "
        f"({time.perf_counter() - t:.2f}s)")

    kernels = [
        {"name": "K1 segment_window", "route": "cuda",
         "source": "cnosdb_tpu_torch/ops/csrc/segment_window.cu",
         "replaces": "cnosdb_tpu/ops/pallas_kernels.py:129",
         "launches": launches["K1"],
         "mesh_launches": mesh_run["launches"]["K1"],
         "max_abs_err": r1["max_abs_err"],
         "ms": r1["ms"], "kernel_ms": r1["kernel_ms"],
         "call_ms": r1["call_ms"], "plain_ms": r1["plain_ms"],
         "bound_ms": r1["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "K2 gorilla_decode / xor_scan", "route": "cuda",
         "source": "cnosdb_tpu_torch/ops/csrc/xor_scan.cu",
         "replaces": "cnosdb_tpu/ops/device_decode.py:210",
         "launches": launches["K2"],
         "mesh_launches": mesh_run["launches"]["K2"],
         "max_abs_err": r2["max_abs_err"],
         "ms": r2["ms"], "kernel_ms": r2["kernel_ms"],
         "scan_ms": r2["scan_ms"], "plain_ms": r2["plain_ms"],
         "bound_ms": r2["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
