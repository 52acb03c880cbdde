"""The eight suites of bench_suites.py run through cnosdb_tpu_torch:
TSBS IoT-13, log search over OTLP spans, a dashboard over a materialized
view, a mixed hot/cold scan over the tiered object store, point queries
through the serving plane, the gray-failure straggler bed, memory
governance under overload, and the mesh lane swept over 1, 2, 4 and 8
devices.

Each keeps the reference's function name, seed, row widths, tags, value
distributions, SQL text, thread counts and phase structure. What
differs:

- sizes are arguments (`n_trucks`/`points`, `n_rows`, `suite_rows`;
  `n_hosts`, `per`, thread and request counts; `iters`, `delay_ms`,
  `rows`, `factors`, the mesh pool); the defaults reproduce
  bench_suites.py's own sizes, so the data is the reference's byte for
  byte;
- the oracles that looped over trucks or masked object arrays per value
  are vectorized (one sort or one bincount over the keys; string
  predicates evaluated once per distinct value), so they finish at
  4,000 trucks; the IoT oracles compare the whole answer (every
  group, every returned column, the ORDER BY) where the reference's
  looked at some rows or columns;
- the log-search oracle counts the last write of a point written twice
  at one (service, time), as the table holds it (the reference counts
  both; at 2,500,000 spans such pairs occur);
- the serving, overload and mesh suites check every answer against a
  numpy oracle over the written arrays (the reference counted them, or
  compared them with one answer of the system); the straggler suite
  also checks the unhedged scan against the healthy one;
- a suite that cannot run raises: no `{"disabled": True}` when its
  plane is off, no error turned into a report line;
- `_run` checks the first (cold) pass as well as the timed ones, and
  every timed window of a query ends with `torch.cuda.synchronize()`
  where the scan device is a card;
- stages come from the port's `utils.stages`; nothing is written to a
  file, every runner returns dicts.

    python3 -c "import bench_suites_torch"   # imports no jax

chip_smoke.py phases 6b and 6c drive them on the card; the CPU tests
are tests/test_torch_suites.py and tests/test_torch_suites_serving.py.
"""
from __future__ import annotations

import contextlib
import math
import os
import shutil
import statistics
import tempfile
import threading
import time

import numpy as np

SUITE_ROWS = 1_000_000       # the reference's default size
DAY_NS = 86_400_000_000_000
BASE_TS = 1_640_995_200_000_000_000  # 2022-01-01


def clear_scan_cache(coord) -> None:
    """Empty the coordinator's scan cache and zero its byte count (the
    count bounds what the cache may hold: emptying the dict alone would
    shrink the cache by every cleared byte)."""
    with coord._scan_cache_lock:
        coord._scan_cache.clear()
        coord._scan_cache_bytes = 0


def _sync() -> None:
    from cnosdb_tpu_torch.ops.placement import scan_device

    if scan_device().type == "cuda":
        import torch

        torch.cuda.synchronize()


def _restore_env(saved: dict) -> None:
    """Put back each variable of `saved` ({name: value, None = unset})."""
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def launch_counts() -> dict:
    """K1, K2 and X2 launch counts, as their wrappers keep them."""
    from cnosdb_tpu_torch.ops import device_decode as dd
    from cnosdb_tpu_torch.ops import fused
    from cnosdb_tpu_torch.ops import pallas_kernels as pk

    return {"K1": pk.launches, "K2": dd.xor_launches,
            "X2": fused.launch_count}


def _codes(arr) -> tuple[np.ndarray, list]:
    """Dense codes of an object array in first-seen order, and the
    distinct values."""
    seen: dict = {}
    codes = np.fromiter((seen.setdefault(v, len(seen)) for v in arr),
                        dtype=np.int64, count=len(arr))
    return codes, list(seen)


def _where(arr, pred) -> np.ndarray:
    """pred(value) for every row, evaluated once per distinct value."""
    codes, uniq = _codes(arr)
    return np.array([bool(pred(u)) for u in uniq], dtype=bool)[codes]


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------
def build_readings(coord, tenant, db, *, n_trucks=50, points=None,
                   seed=17):
    """TSBS IoT-shaped truck telemetry: `n_trucks` trucks (TSBS's
    --scale), `points` readings each, 10 s apart (default: the
    reference's max(200, SUITE_ROWS // 4 // n_trucks))."""
    from cnosdb_tpu_torch.models.points import SeriesRows, WriteBatch
    from cnosdb_tpu_torch.models.schema import ValueType
    from cnosdb_tpu_torch.models.series import SeriesKey

    if points is None:
        points = max(200, SUITE_ROWS // 4 // n_trucks)
    rng = np.random.default_rng(seed)
    per = points
    data = {"ts": [], "truck": [], "fleet": [], "velocity": [],
            "fuel_state": [], "current_load": [], "load_capacity": [],
            "latitude": [], "longitude": [], "status": []}
    for t in range(n_trucks):
        fleet = f"fleet_{t % 5}"
        name = f"truck_{t:03d}"
        ts = BASE_TS + (np.arange(per, dtype=np.int64) * 10
                        + rng.integers(0, 3)) * 1_000_000_000
        vel = np.clip(rng.normal(45, 20, per), 0, 100)
        vel[rng.random(per) < 0.2] = 0.0          # parked windows
        fuel = np.clip(1.0 - np.linspace(0, 1.2, per)
                       + rng.normal(0, .02, per), 0, 1)
        cap = float(rng.choice([1500.0, 2000.0, 3000.0]))
        load = np.clip(rng.normal(0.6, 0.3, per), 0, 1) * cap
        lat = 40 + rng.normal(0, 0.5, per).cumsum() * 1e-3
        lon = -105 + rng.normal(0, 0.5, per).cumsum() * 1e-3
        status = (rng.random(per) < 0.05).astype(np.int64)  # 1 = down
        wb = WriteBatch()
        wb.add_series("readings", SeriesRows(
            SeriesKey("readings", {"name": name, "fleet": fleet}), ts,
            {"velocity": (int(ValueType.FLOAT), vel),
             "fuel_state": (int(ValueType.FLOAT), fuel),
             "current_load": (int(ValueType.FLOAT), load),
             "load_capacity": (int(ValueType.FLOAT),
                               np.full(per, cap)),
             "latitude": (int(ValueType.FLOAT), lat),
             "longitude": (int(ValueType.FLOAT), lon),
             "status": (int(ValueType.INTEGER), status)}))
        coord.write_points(tenant, db, wb)
        data["ts"].append(ts)
        data["truck"].append(np.full(per, t))
        data["fleet"].append(np.full(per, t % 5))
        data["velocity"].append(vel)
        data["fuel_state"].append(fuel)
        data["current_load"].append(load)
        data["load_capacity"].append(np.full(per, cap))
        data["latitude"].append(lat)
        data["longitude"].append(lon)
        data["status"].append(status)
    coord.engine.flush_all()
    coord.engine.compact_all()
    return {k: np.concatenate(v) for k, v in data.items()}


def build_spans(coord, tenant, db, n_rows=None, *, seed=7):
    """OTLP-shaped trace/span table: log search is the workload the
    string plane unlocks. Bodies are templated log lines with rare
    needles ('timeout', 'deadline exceeded') so n-gram page skipping has
    something to prune; span/trace ids exercise prefix and exact lanes."""
    from cnosdb_tpu_torch.models.points import SeriesRows, WriteBatch
    from cnosdb_tpu_torch.models.schema import ValueType
    from cnosdb_tpu_torch.models.series import SeriesKey

    rng = np.random.default_rng(seed)
    n = SUITE_ROWS // 4 if n_rows is None else n_rows
    spans = np.array([f"GET /api/v{i}" for i in range(12)] +
                     [f"POST /api/v{i}" for i in range(6)] +
                     ["db.query", "cache.get", "auth.check"], dtype=object)
    bodies = np.array(
        [f"INFO request handled path=/p{i} status=200" for i in range(160)]
        + [f"WARN slow upstream path=/p{i} retry=1" for i in range(24)]
        + ["ERROR upstream timeout path=/p3 attempt=2",
           "ERROR deadline exceeded calling billing",
           "WARN connection reset by peer"], dtype=object)
    body_w = np.concatenate([np.full(160, 1.0), np.full(24, 0.08),
                             np.full(3, 0.004)])
    body_w /= body_w.sum()
    span_idx = rng.integers(0, len(spans), n)
    body_idx = rng.choice(len(bodies), n, p=body_w)
    trace_idx = rng.integers(0, max(n // 8, 2), n)
    dur = rng.integers(50, 500_000, n).astype(np.int64)
    status = np.where(rng.random(n) < 0.97, "OK", "ERROR").astype(object)
    ts = BASE_TS + rng.integers(0, 7 * DAY_NS // 1000, n).astype(
        np.int64) * 1000
    ts.sort()
    CH = 250_000
    for svc in range(4):
        sel = np.flatnonzero(span_idx % 4 == svc)
        key = SeriesKey("trace_spans", {"service": f"svc_{svc}"})
        for off in range(0, len(sel), CH):
            ix = sel[off:off + CH]
            fields = {
                "trace_id": (int(ValueType.STRING),
                             [f"tr-{i:08d}" for i in trace_idx[ix]]),
                "span_name": (int(ValueType.STRING),
                              list(spans[span_idx[ix]])),
                "status_code": (int(ValueType.STRING), list(status[ix])),
                "body": (int(ValueType.STRING), list(bodies[body_idx[ix]])),
                "duration_us": (int(ValueType.INTEGER), dur[ix]),
            }
            wb = WriteBatch()
            wb.add_series("trace_spans", SeriesRows(key, ts[ix], fields))
            coord.write_points(tenant, db, wb)
    coord.engine.flush_all()
    coord.engine.compact_all()
    return {
        "service": np.array([f"svc_{i % 4}" for i in span_idx],
                            dtype=object),
        "trace_id": np.array([f"tr-{i:08d}" for i in trace_idx],
                             dtype=object),
        "span_name": spans[span_idx],
        "status_code": status,
        "body": bodies[body_idx],
        "duration_us": dur,
        "time": ts,
    }


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------
def _run(executor, session, name, sql, check, results, errors,
         stage_out=None, *, clear=None, warm=1, runs=None):
    """The cold pass (after `clear()`, when given), then `warm` timed
    passes; every answer goes through `check`. results[name] is the
    median warm ms; runs[name], when `runs` is given, holds each pass's
    ms and K1/K2/X2 launches and the answer's row count."""
    from cnosdb_tpu_torch.utils import stages as _stages

    try:
        if clear is not None:
            clear()
        # profile the cold pass too: it is the only one the
        # compressed-domain lane and the decoders actually run in — the
        # timed passes below are served from the scan cache
        cold_prof = _stages.QueryProfile() if stage_out is not None else None
        before = launch_counts()
        t0 = time.perf_counter()
        with _stages.profile_scope(cold_prof):
            rs = executor.execute_one(sql, session)
            _sync()
        cold_ms = (time.perf_counter() - t0) * 1e3
        after = launch_counts()
        if check is not None:
            check(rs)
        passes = [{"ms": cold_ms, **{k: after[k] - before[k]
                                     for k in after}}]
        prof = None
        for _ in range(warm):
            prof = _stages.QueryProfile() if stage_out is not None else None
            before = launch_counts()
            t0 = time.perf_counter()
            with _stages.profile_scope(prof):
                rs = executor.execute_one(sql, session)
                _sync()
            dt = time.perf_counter() - t0
            after = launch_counts()
            if check is not None:
                check(rs)
            passes.append({"ms": dt * 1e3, **{k: after[k] - before[k]
                                              for k in after}})
        if prof is not None:
            # aggregation/string-plane stages per query: group
            # cardinality, factorize cost, which DISTINCT path engaged,
            # string predicate routing + pages skipped, top-k routing
            snap = prof.snapshot()
            keep = {k: v for k, v in snap.items()
                    if k in ("factorize_ms", "group_count",
                             "ngram_pages_skipped")
                    or k.startswith(("distinct_path", "string_path",
                                     "topk.", "compressed."))}
            # compressed-domain visibility per query, read from the COLD
            # pass: how many bytes the decode lanes actually touched, and
            # whether the lane engaged at all (pages answered/skipped/
            # masked from encoded form)
            cold = cold_prof.snapshot()
            for k, v in cold.items():
                if k.startswith("compressed."):
                    keep[k] = v
            keep["bytes_materialized"] = int(
                cold.get("compressed.bytes_materialized", 0))
            keep["compressed_path"] = bool(
                cold.get("compressed.pages_answered", 0)
                or cold.get("compressed.pages_skipped", 0)
                or cold.get("compressed.pages_masked", 0))
            stage_out[name] = keep
        results[name] = round(
            statistics.median(p["ms"] for p in passes[1:]), 2)
        if runs is not None:
            runs[name] = {"rows": int(rs.n_rows), "passes": passes}
    except Exception as e:
        errors[name] = f"{type(e).__name__}: {e}"[:160]


def _col(rs, name):
    return rs.columns[rs.names.index(name)]


# ---------------------------------------------------------------------------
# TSBS IoT-13
# ---------------------------------------------------------------------------
def tsbs_queries(a) -> list:
    """The 13 IoT query types (benchmark/tsbs/shell_env.sh QUERY_TYPES)
    as (name, sql, check), each check an oracle over the ingested
    arrays."""
    trucks, tix = np.unique(a["truck"], return_inverse=True)
    n_t = len(trucks)
    # per truck, the row of its newest reading
    order = np.lexsort((a["ts"], tix))
    last_row = order[np.r_[np.flatnonzero(np.diff(tix[order])),
                           len(order) - 1]]

    def per_truck_last(col):
        return dict(zip(trucks.tolist(), col[last_row].tolist()))

    def name_of(t):
        return f"truck_{t:03d}"

    def chk_names(rs, want):
        """The answer's names are exactly `want` (truck numbers), in
        ORDER BY name's order."""
        names = [str(n) for n in _col(rs, "name")]
        assert names == sorted(name_of(t) for t in want), \
            (len(names), len(want))

    q = []
    last_fuel = per_truck_last(a["fuel_state"])
    low_fuel = {t for t, v in last_fuel.items() if v < 0.1}

    def chk_last(rs, col, of):
        """Column `col` holds of[truck] on every row (last() returns a
        stored reading: the reference's 1e-9)."""
        t = [int(n.split("_")[1]) for n in _col(rs, "name")]
        np.testing.assert_allclose(
            np.asarray(_col(rs, col), dtype=np.float64),
            [of[i] for i in t], rtol=0, atol=1e-9, err_msg=col)

    def chk_low_fuel(rs):
        chk_names(rs, low_fuel)
        chk_last(rs, "f", last_fuel)

    q.append(("low-fuel",
              "SELECT name, last(fuel_state) AS f FROM readings GROUP BY "
              "name HAVING last(fuel_state) < 0.1 ORDER BY name",
              chk_low_fuel))

    last_load = per_truck_last(a["current_load"])
    cap_of = per_truck_last(a["load_capacity"])
    high = {t for t in last_load
            if last_load[t] / cap_of[t] > 0.9}

    def chk_high_load(rs):
        chk_names(rs, high)
        chk_last(rs, "l", last_load)
        chk_last(rs, "c", cap_of)

    q.append(("high-load",
              "SELECT name, last(current_load) AS l, last(load_capacity) "
              "AS c FROM readings GROUP BY name "
              "HAVING last(current_load) / last(load_capacity) > 0.9 "
              "ORDER BY name", chk_high_load))

    lat_last = per_truck_last(a["latitude"])
    lon_last = per_truck_last(a["longitude"])

    def chk_loc(rs, want):
        chk_names(rs, want)
        chk_last(rs, "lat", lat_last)
        chk_last(rs, "lon", lon_last)

    q.append(("last-loc",
              "SELECT name, last(latitude) AS lat, last(longitude) AS lon "
              "FROM readings GROUP BY name ORDER BY name",
              lambda rs: chk_loc(rs, trucks.tolist())))

    q.append(("single-last-loc",
              "SELECT name, last(latitude) AS lat, last(longitude) AS lon "
              "FROM readings WHERE name = 'truck_007' GROUP BY name",
              lambda rs: chk_loc(rs, [7])))

    # stationary-trucks: avg velocity < 1 over a 10-minute window
    win_lo = int(a["ts"].min())
    win_hi = win_lo + 600 * 10**9 - 1
    wm = (a["ts"] >= win_lo) & (a["ts"] <= win_hi)
    s = np.bincount(tix[wm], weights=a["velocity"][wm], minlength=n_t)
    c = np.bincount(tix[wm], minlength=n_t)
    with np.errstate(invalid="ignore"):
        v_win = s / np.maximum(c, 1)
    still = (c > 0) & (v_win < 1.0)
    v_still = dict(zip(trucks[still].tolist(), v_win[still].tolist()))

    def chk_stationary(rs):
        chk_names(rs, v_still)
        for nm, v in zip(_col(rs, "name"), _col(rs, "v")):
            np.testing.assert_allclose(v, v_still[int(nm.split("_")[1])],
                                       rtol=1e-9, err_msg=nm)

    q.append(("stationary-trucks",
              f"SELECT name, avg(velocity) AS v FROM readings WHERE time >= "
              f"{win_lo} AND time <= {win_hi} GROUP BY name "
              "HAVING avg(velocity) < 1 ORDER BY name", chk_stationary))

    def chk_fleets(rs, col, want, cmp):
        """Exactly the fleets of `want` ({fleet number: value}), in
        ORDER BY fleet's order, each value held by cmp(got, want)."""
        fleets = [str(f) for f in _col(rs, "fleet")]
        assert fleets == [f"fleet_{f}" for f in sorted(want)], fleets
        for fl, v in zip(fleets, _col(rs, col)):
            cmp(v, want[int(fl.split("_")[1])])

    # avg-load: avg load ratio by fleet
    fleet_ratio = {}
    for f in np.unique(a["fleet"]).tolist():
        m = a["fleet"] == f
        fleet_ratio[f] = float(
            (a["current_load"][m] / a["load_capacity"][m]).mean())

    q.append(("avg-load",
              "SELECT fleet, avg(current_load / load_capacity) AS r "
              "FROM readings GROUP BY fleet ORDER BY fleet",
              lambda rs: chk_fleets(
                  rs, "r", fleet_ratio,
                  lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-9))))

    # daily-activity: readings per day (every day of the data)
    day = ((a["ts"] - BASE_TS) // DAY_NS).astype(np.int64)
    days, per_day = np.unique(day, return_counts=True)
    want_daily = [(BASE_TS + int(d) * DAY_NS, int(n))
                  for d, n in zip(days, per_day)]

    def chk_daily(rs):
        got = [(int(d), int(n)) for d, n in zip(_col(rs, "d"),
                                                 _col(rs, "c"))]
        assert got == want_daily, (got, want_daily)

    q.append(("daily-activity",
              "SELECT date_bin(INTERVAL '24 hours', time) AS d, "
              "count(velocity) AS c FROM readings GROUP BY d ORDER BY d",
              chk_daily))

    # breakdown-frequency: status=1 readings per fleet (a fleet with none
    # has no row)
    down = a["status"] == 1
    fl, n_down = np.unique(a["fleet"][down], return_counts=True)
    bf = dict(zip(fl.tolist(), n_down.tolist()))

    def eq_int(g, w):
        assert int(g) == w, (g, w)

    q.append(("breakdown-frequency",
              "SELECT fleet, count(status) AS c FROM readings "
              "WHERE status = 1 GROUP BY fleet ORDER BY fleet",
              lambda rs: chk_fleets(rs, "c", bf, eq_int)))

    # driving-session families: 10-minute windows with avg velocity > 5
    # (one bincount over truck x window; a truck's rows are contiguous,
    # so each window sums in the reference's per-truck order)
    bucket = ((a["ts"] - BASE_TS) // (600 * 10**9)).astype(np.int64)
    nb = int(bucket.max()) + 1
    key = tix * nb + bucket
    s = np.bincount(key, weights=a["velocity"], minlength=n_t * nb)
    c = np.bincount(key, minlength=n_t * nb)
    with np.errstate(invalid="ignore"):
        active_windows = int(((s / np.maximum(c, 1) > 5) & (c > 0)).sum())

    def chk_sessions(rs):
        assert rs.n_rows == 1, rs.n_rows
        assert int(rs.columns[0][0]) == active_windows

    session_sql = (
        "SELECT count(*) FROM (SELECT name, "
        "date_bin(INTERVAL '10 minutes', time) AS w, avg(velocity) AS v "
        "FROM readings GROUP BY name, w) s WHERE v > 5")
    for qname in ("long-driving-sessions", "long-daily-sessions",
                  "avg-daily-driving-session",
                  "avg-daily-driving-duration"):
        q.append((qname, session_sql, chk_sessions))

    # avg-vs-projected-fuel-consumption
    ratio = float(np.nanmean(a["fuel_state"]))

    def chk_fuel(rs):
        assert rs.n_rows == 1, rs.n_rows
        np.testing.assert_allclose(rs.columns[0][0], ratio, rtol=1e-9)

    q.append(("avg-vs-projected-fuel-consumption",
              "SELECT avg(fuel_state) AS r FROM readings", chk_fuel))
    return q


def run_tsbs(executor, session, a, *, clear=None, warm=1,
             runs=None) -> tuple[dict, dict]:
    """The 13 IoT query types, each oracle-checked over the ingested
    arrays (`_run` for `clear`, `warm` and `runs`)."""
    res: dict = {}
    err: dict = {}
    for name, sql, check in tsbs_queries(a):
        _run(executor, session, name, sql, check, res, err, clear=clear,
             warm=warm, runs=runs)
    return res, err


# ---------------------------------------------------------------------------
# log search
# ---------------------------------------------------------------------------
def logsearch_queries(a) -> list:
    """Log/trace search shapes over the OTLP-style spans table as (name,
    sql, check), each checked against numpy over the ingested arrays
    (the oracle never goes through the string plane). A point written
    twice at one (service, time) holds its last write, so the oracle
    counts only the last row of each such pair: at 2,500,000 spans the
    random microsecond stamps give a few."""
    tr_prefix = a["trace_id"][0][:6]
    svc_codes, _svcs = _codes(a["service"])
    order = np.lexsort((np.arange(len(a["time"])), a["time"], svc_codes))
    dup = (np.diff(a["time"][order]) == 0) & (np.diff(svc_codes[order]) == 0)
    if dup.any():
        keep = np.ones(len(order), dtype=bool)
        keep[order[:-1][dup]] = False
        a = {k: v[keep] for k, v in a.items()}
    body = a["body"]
    span = a["span_name"]
    n_timeout = int(_where(body, lambda s: "timeout" in s).sum())
    n_error = int(_where(body, lambda s: s.startswith("ERROR")).sum())
    em = _where(body, lambda s: "ERROR" in s)
    svc, n_by = np.unique(a["service"][em].astype(str), return_counts=True)
    err_by_svc = dict(zip(svc.tolist(), n_by.tolist()))
    n_span = int((span == "db.query").sum())
    n_trace = int(_where(a["trace_id"],
                         lambda s: s.startswith(tr_prefix)).sum())
    span_codes, span_names = _codes(span)
    span_max = np.full(len(span_names), np.iinfo(np.int64).min)
    np.maximum.at(span_max, span_codes, a["duration_us"])
    maxes = dict(zip(span_names, span_max.astype(float).tolist()))

    def scalar_eq(val):
        def chk(rs):
            got = int(np.asarray(rs.columns[0])[0])
            assert got == val, f"{got} != {val}"
        return chk

    def chk_topdur(rs):
        got = list(zip(_col(rs, "span_name"),
                       (float(v) for v in _col(rs, "d"))))
        assert len(got) == 5, got
        assert all(maxes[s] == v for s, v in got), got
        vals = [v for _s, v in got]
        floor = sorted(maxes.values(), reverse=True)[4]
        assert vals == sorted(vals, reverse=True) and vals[-1] >= floor, got

    def chk_errsvc(rs):
        got = dict(zip(_col(rs, "service"),
                       (int(v) for v in _col(rs, "c"))))
        assert got == err_by_svc, f"{got} != {err_by_svc}"

    return [
        ("ls1_needle",
         "SELECT count(*) FROM trace_spans WHERE body LIKE '%timeout%'",
         scalar_eq(n_timeout)),
        ("ls2_prefix",
         "SELECT count(*) FROM trace_spans WHERE body LIKE 'ERROR%'",
         scalar_eq(n_error)),
        ("ls3_exact",
         "SELECT count(*) FROM trace_spans WHERE span_name LIKE 'db.query'",
         scalar_eq(n_span)),
        ("ls4_err_by_service",
         "SELECT service, count(*) AS c FROM trace_spans "
         "WHERE body LIKE '%ERROR%' GROUP BY service ORDER BY service",
         chk_errsvc),
        ("ls5_slow_spans",
         "SELECT span_name, max(duration_us) AS d FROM trace_spans "
         "GROUP BY span_name ORDER BY d DESC LIMIT 5", chk_topdur),
        ("ls6_trace_prefix",
         f"SELECT count(*) FROM trace_spans "
         f"WHERE trace_id LIKE '{tr_prefix}%'", scalar_eq(n_trace)),
    ]


def run_logsearch(executor, session, a, *, clear=None, warm=1,
                  runs=None) -> tuple[dict, dict, dict]:
    """The six log-search shapes, each oracle-checked, with the string
    plane's stages per query."""
    res: dict = {}
    err: dict = {}
    stg: dict = {}
    for name, sql, check in logsearch_queries(a):
        _run(executor, session, name, sql, check, res, err, stg,
             clear=clear, warm=warm, runs=runs)
    return res, err, stg


# ---------------------------------------------------------------------------
# dashboard steady-state (materialized rollup plane)
# ---------------------------------------------------------------------------
def run_dashboard(executor, coord, tenant, db, session, suite_rows=None, *,
                  seed=23) -> dict:
    """The workload materialized rollups exist for: a dashboard panel
    re-issuing the same full-history time-bucketed group-by as history
    grows 10×. Each step appends a chunk, flushes, advances the view
    watermark deterministically, then times the panel query with the
    subsumption rewrite on vs off (both oracle-checked against numpy
    over the full arrays). With the view, only the unsealed tail is
    scanned raw, so view_ms should stay flat while noview_ms grows
    with history; view_growth is last/first view_ms as the headline.
    The warm no-view pass reuses the scan cache's batches and their
    partial aggregates, so each step also times the no-view query with
    the scan cache emptied first (`noview_scan_ms`: the scan and the
    operator run over the whole history) and through a serving plane of
    its own (`noview_cached_ms`, whose result cache may answer the
    repeat)."""
    from cnosdb_tpu_torch.models.points import SeriesRows, WriteBatch
    from cnosdb_tpu_torch.models.schema import ValueType
    from cnosdb_tpu_torch.models.series import SeriesKey
    from cnosdb_tpu_torch.server.serving import ServingPlane
    from cnosdb_tpu_torch.sql import matview as _mv

    rng = np.random.default_rng(seed)
    n_hosts = 8
    steps = 10
    suite_rows = SUITE_ROWS if suite_rows is None else suite_rows
    chunk = max(1000, suite_rows // 100)      # ×10 over the run
    delay_ns = 10 * 1_000_000_000

    # the dataset is historical (BASE_TS = 2022): the wall-clock
    # background maintainer would seal past the data's end and strand
    # appended rows below the hwm — refresh deterministically instead
    prev_auto = os.environ.get("CNOSDB_MATVIEW_AUTO")
    os.environ["CNOSDB_MATVIEW_AUTO"] = "0"
    try:
        executor.execute_one(
            "CREATE TABLE IF NOT EXISTS dash (value DOUBLE, TAGS(host))",
            session)
        executor.execute_one(
            "CREATE MATERIALIZED VIEW bench_dash WATERMARK DELAY '10s' AS "
            "SELECT date_bin(INTERVAL '1 minute', time) AS t, host, "
            "sum(value) AS s, count(value) AS c FROM dash GROUP BY t, host",
            session)
        me = executor.matview_engine()

        sql = ("SELECT date_bin(INTERVAL '1 minute', time) AS t, host, "
               "sum(value) AS s, count(value) AS c FROM dash "
               "GROUP BY t, host ORDER BY t, host")
        out: dict = {"history_rows": [], "view_ms": [], "noview_ms": [],
                     "noview_scan_ms": [], "noview_cached_ms": []}
        all_ts: list = []
        all_host: list = []
        all_val: list = []
        written = 0
        for _step in range(steps):
            per = chunk // n_hosts
            for h in range(n_hosts):
                ts = BASE_TS + (written // n_hosts + np.arange(
                    per, dtype=np.int64)) * 1_000_000_000
                val = rng.normal(50, 10, per)
                wb = WriteBatch()
                wb.add_series("dash", SeriesRows(
                    SeriesKey("dash", {"host": f"host_{h}"}), ts,
                    {"value": (int(ValueType.FLOAT), val)}))
                coord.write_points(tenant, db, wb)
                all_ts.append(ts)
                all_host.append(np.full(per, h))
                all_val.append(val)
            written += per * n_hosts
            coord.engine.flush_all()
            me.refresh("bench_dash",
                       now_ns=int(max(t[-1] for t in all_ts)) + delay_ns + 1)

            ts_a = np.concatenate(all_ts)
            host_a = np.concatenate(all_host)
            val_a = np.concatenate(all_val)
            bucket = ts_a // 60_000_000_000
            n_groups = len(np.unique(bucket * n_hosts + host_a))

            def check(rs, val_a=val_a, n_groups=n_groups):
                assert rs.n_rows == n_groups, f"group count {rs.n_rows}"
                assert np.isclose(float(np.sum(_col(rs, "s"))),
                                  float(val_a.sum()), rtol=1e-9), \
                    "sum drift"
                assert int(np.sum(_col(rs, "c"))) == len(val_a), \
                    "count drift"

            def timed(check=check, warm_up=True):
                if warm_up:
                    executor.execute_one(sql, session)
                else:
                    clear_scan_cache(coord)
                t0 = time.perf_counter()
                rs = executor.execute_one(sql, session)
                _sync()
                ms = round((time.perf_counter() - t0) * 1e3, 2)
                check(rs)
                return ms

            hits0 = _mv.counters_snapshot().get("rewrite_hit", 0)
            timings = {}
            for mode, enabled in (("view_ms", True), ("noview_ms", False)):
                executor.matview_rewrite_enabled = enabled
                timings[mode] = timed()
            hits = _mv.counters_snapshot().get("rewrite_hit", 0) - hits0
            # still without the view: the scan with no cached batch, then
            # a serving plane's result cache
            out["noview_scan_ms"].append(timed(warm_up=False))
            prev_serving = executor.serving
            executor.serving = ServingPlane(executor)
            try:
                out["noview_cached_ms"].append(timed())
            finally:
                executor.serving = prev_serving
            executor.matview_rewrite_enabled = True
            out["history_rows"].append(written)
            out["view_ms"].append(timings["view_ms"])
            out["noview_ms"].append(timings["noview_ms"])
            out.setdefault("view_hits", []).append(hits)

        # 2 rewriteable queries per step (warm-up + timed) in view mode
        out["view_hit_ratio"] = round(sum(out["view_hits"]) / (2 * steps), 3)
        out["view_growth"] = round(out["view_ms"][-1]
                                   / max(out["view_ms"][0], 1e-6), 2)
        out["noview_growth"] = round(out["noview_ms"][-1]
                                     / max(out["noview_ms"][0], 1e-6), 2)
        executor.execute_one("DROP MATERIALIZED VIEW bench_dash", session)
    finally:
        executor.matview_rewrite_enabled = True
        _restore_env({"CNOSDB_MATVIEW_AUTO": prev_auto})
    return out


# ---------------------------------------------------------------------------
# mixed hot/cold scan (tiered object-store plane)
# ---------------------------------------------------------------------------
def run_coldscan(executor, coord, tenant, db, session, suite_rows=None, *,
                 seed=31) -> dict:
    """Mixed hot/cold scan (tiered object-store plane): half the history
    ages into a LocalStore "bucket", then the same oracle-checked
    group-by runs all-hot, mixed with a cold block cache, and mixed
    warm. Headline: cold_over_hot (acceptance: ≤ 3×) plus the near-data
    pruning counters — pages pruned locally, bytes downloaded vs stored,
    block-cache hit ratio. K2 (and X2) launches of each pass are in
    out["launches"]."""
    from cnosdb_tpu_torch.models.points import SeriesRows, WriteBatch
    from cnosdb_tpu_torch.models.schema import ValueType
    from cnosdb_tpu_torch.models.series import SeriesKey
    from cnosdb_tpu_torch.storage import compressed_domain as _cd
    from cnosdb_tpu_torch.storage import tiering

    rng = np.random.default_rng(seed)
    n_hosts = 4
    suite_rows = SUITE_ROWS if suite_rows is None else suite_rows
    chunk = max(2000, suite_rows // 50)
    per = chunk // n_hosts
    boundary = BASE_TS + 30 * DAY_NS      # old half < boundary < new half

    executor.execute_one(
        "CREATE TABLE IF NOT EXISTS cold_m (value DOUBLE, TAGS(host))",
        session)
    total = {"n": 0, "s": 0.0}
    # old half: 5 sealed files compacted to L1 (what tiers); new half:
    # recent deltas left at L0 so compaction can't merge across the
    # boundary and tiering (level ≥ 1) only ages the old file
    for compact, t0 in ((True, BASE_TS), (False, boundary + DAY_NS)):
        for step in range(5):
            for h in range(n_hosts):
                ts = t0 + (step * per + np.arange(per, dtype=np.int64)) \
                    * 1_000_000_000
                val = rng.normal(50, 10, per)
                wb = WriteBatch()
                wb.add_series("cold_m", SeriesRows(
                    SeriesKey("cold_m", {"host": f"host_{h}"}), ts,
                    {"value": (int(ValueType.FLOAT), val)}))
                coord.write_points(tenant, db, wb)
                total["n"] += per
                total["s"] += float(val.sum())
            coord.engine.flush_all()
        if compact:
            coord.engine.compact_all()

    sql = ("SELECT host, count(value) AS c, sum(value) AS s FROM cold_m "
           "GROUP BY host ORDER BY host")
    launches: dict = {}

    def timed(what=None):
        clear_scan_cache(coord)
        before = launch_counts()
        t0 = time.perf_counter()
        rs = executor.execute_one(sql, session)
        _sync()
        ms = round((time.perf_counter() - t0) * 1e3, 2)
        after = launch_counts()
        if what is not None:
            launches[what] = {k: after[k] - before[k] for k in after}
        assert int(np.sum(_col(rs, "c"))) == total["n"], "count drift"
        assert np.isclose(float(np.sum(_col(rs, "s"))), total["s"],
                          rtol=1e-9), "sum drift"
        return ms

    out: dict = {"rows": total["n"], "launches": launches}
    timed()                                   # warm-up
    out["hot_ms"] = timed("hot")

    bucket = tempfile.mkdtemp(prefix="cnosdb_cold_bench_")
    tiering.configure(bucket)
    tiering.counters_reset()
    tiering.block_cache_clear()
    try:
        vnodes = list(coord.engine.vnodes.values())
        tiered = sum(tiering.tier_vnode(v, boundary_ns=boundary)
                     for v in vnodes)
        out["files_tiered"] = tiered
        snap = tiering.cold_tier_snapshot()
        out["bytes_tiered"] = snap.get(("tier", "bytes_uploaded"), 0)

        tiering.counters_reset()
        out["cold_ms"] = timed("cold")        # cold block cache
        snap = tiering.cold_tier_snapshot()
        out["cold_range_gets"] = snap.get(("fetch", "range_gets"), 0)
        out["cold_pages_fetched"] = snap.get(("fetch", "pages_fetched"), 0)
        out["cold_bytes_downloaded"] = snap.get(
            ("fetch", "bytes_downloaded"), 0)
        out["cold_pages_pruned"] = snap.get(("prune", "pages_pruned"), 0)

        # near-data pruning: a recent-window query must answer without
        # touching the store — every cold page is excluded locally
        tiering.counters_reset()
        clear_scan_cache(coord)
        tiering.block_cache_clear()
        rs = executor.execute_one(
            f"SELECT count(value) AS c FROM cold_m "
            f"WHERE time >= {boundary}", session)
        assert int(np.sum(_col(rs, "c"))) == total["n"] // 2, "window drift"
        snap = tiering.cold_tier_snapshot()
        out["window_pages_pruned"] = snap.get(("prune", "pages_pruned"), 0)
        out["window_bytes_downloaded"] = snap.get(
            ("fetch", "bytes_downloaded"), 0)

        # compressed-domain A/B on the cold half: a stats-answerable
        # aggregate must come back bit-identical with the lane on and
        # off (CNOSDB_COMPRESSED_DOMAIN=0 = the decode-lane oracle), and
        # the lane run must download a fraction of the oracle's bytes —
        # answered pages never leave the object store
        def cold_once(alias):
            # a distinct alias per pass keeps the serving-plane result
            # cache out of the A/B — same SQL text would be served from
            # the token-revalidated cache with zero bytes downloaded
            clear_scan_cache(coord)
            tiering.block_cache_clear()
            tiering.counters_reset()
            before = launch_counts()
            t0 = time.perf_counter()
            rs = executor.execute_one(
                f"SELECT count(value) AS {alias} FROM cold_m", session)
            _sync()
            ms = round((time.perf_counter() - t0) * 1e3, 2)
            after = launch_counts()
            launches[alias] = {k: after[k] - before[k] for k in after}
            snap2 = tiering.cold_tier_snapshot()
            return (int(np.sum(_col(rs, alias))), ms,
                    snap2.get(("fetch", "bytes_downloaded"), 0))

        before_cd = _cd.outcomes_snapshot()
        lane_c, out["compressed_ms"], lane_dl = cold_once("c_lane")
        after_cd = _cd.outcomes_snapshot()
        out["compressed_pages_answered"] = sum(
            n - before_cd.get(k, 0) for k, n in after_cd.items()
            if k[0] in ("meta", "closed", "skip"))
        prev_cd = os.environ.get("CNOSDB_COMPRESSED_DOMAIN")
        os.environ["CNOSDB_COMPRESSED_DOMAIN"] = "0"
        try:
            oracle_c, out["compressed_oracle_ms"], oracle_dl = \
                cold_once("c_oracle")
        finally:
            _restore_env({"CNOSDB_COMPRESSED_DOMAIN": prev_cd})
        assert lane_c == oracle_c == total["n"], "compressed A/B drift"
        out["compressed_bytes_downloaded"] = lane_dl
        out["compressed_oracle_bytes_downloaded"] = oracle_dl
        out["compressed_bytes_ratio"] = round(
            oracle_dl / max(lane_dl, 1), 1)

        timed()                               # refill the block cache
        tiering.counters_reset()
        out["cold_warm_ms"] = timed("cold_warm")  # from the block cache
        snap = tiering.cold_tier_snapshot()
        hits = snap.get(("cache", "hit"), 0)
        misses = snap.get(("cache", "miss"), 0)
        out["block_cache_hit_ratio"] = round(
            hits / max(hits + misses, 1), 3)
        out["warm_bytes_downloaded"] = snap.get(
            ("fetch", "bytes_downloaded"), 0)
        out["cold_over_hot"] = round(
            out["cold_ms"] / max(out["hot_ms"], 1e-6), 2)
    finally:
        # hand the engine back hot so later work never needs the bucket
        for v in list(coord.engine.vnodes.values()):
            tiering.rehydrate_vnode(v)
        tiering.configure(None)
        shutil.rmtree(bucket, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# shared by the serving, overload and mesh suites
# ---------------------------------------------------------------------------
def _threads(bodies) -> float:
    """Run each callable of `bodies` on a thread of its own, all released
    together. → seconds from the release to the last join. The first
    exception of any thread is raised once every thread has joined."""
    gate = threading.Barrier(len(bodies) + 1)
    errors: list = []

    def run(body):
        gate.wait()
        try:
            body()
        except BaseException as e:   # raised below, after the join
            errors.append(e)

    ths = [threading.Thread(target=run, args=(b,)) for b in bodies]
    for t in ths:
        t.start()
    gate.wait()
    t0 = time.perf_counter()
    for t in ths:
        t.join()
    elapsed = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return elapsed


def _pct_ms(seconds, q):
    """The q-th percentile of `seconds` in ms; None when there is none."""
    if not len(seconds):
        return None
    return float(np.percentile(np.asarray(seconds), q)) * 1e3


def host_values(rng, n_hosts: int, per: int) -> np.ndarray:
    """[n_hosts, per] float64 N(50, 10) values, drawn host by host as the
    reference's suites draw them."""
    return np.stack([rng.normal(50, 10, per) for _ in range(n_hosts)])


def _write_hosts(coord, tenant, db, table, field, names, ts, vals) -> None:
    """One series per host, tag `host` = names[h], times ts[h] and FLOAT
    `field` values vals[h], one write each."""
    from cnosdb_tpu_torch.models.points import SeriesRows, WriteBatch
    from cnosdb_tpu_torch.models.schema import ValueType
    from cnosdb_tpu_torch.models.series import SeriesKey

    for h, name in enumerate(names):
        wb = WriteBatch()
        wb.add_series(table, SeriesRows(
            SeriesKey(table, {"host": name}), ts[h],
            {field: (int(ValueType.FLOAT), vals[h])}))
        coord.write_points(tenant, db, wb)


# ---------------------------------------------------------------------------
# point queries through the serving plane
# ---------------------------------------------------------------------------
def check_points(rs, ts, vals, floor=None) -> None:
    """A point query's answer holds exactly the written (time, value)
    rows of its host, those with value > floor where `floor` is given,
    in time order, the values bit for bit."""
    keep = np.ones(len(ts), dtype=bool) if floor is None else vals > floor
    assert list(rs.names) == ["time", "value"], rs.names
    t = np.asarray(_col(rs, "time")).astype(np.int64)
    v = np.asarray(_col(rs, "value"), dtype=np.float64)
    assert len(t) == len(v) == int(keep.sum()), (len(t), int(keep.sum()))
    assert np.array_equal(t, ts[keep]), "times differ"
    assert np.array_equal(v.view(np.int64), vals[keep].view(np.int64)), \
        "values differ"


def run_pointqps(executor, coord, tenant, db, session, *, n_hosts=64,
                 per=64, threads=4, per_thread=5000, fthreads=8, fper=40,
                 seed=47) -> dict:
    """High-QPS serving-plane suite: a closed loop of `threads` threads,
    each re-issuing `per_thread` point queries (one host's rows) against
    an `n_hosts` x `per` table; warm requests land in the result cache.
    A second phase sends `fthreads` x `fper` unique-literal variants
    under forced micro-batching, so the fused path (`_fused_exec`) and
    its width histogram run too. Every answer is held to the written
    rows: each host before and after the closed loop, every request of
    the loop and of the fused phase after its threads joined. Raises
    when the executor has no serving plane, on any wrong answer or
    request error, and when no request was fused. Counters are read as
    deltas (the serving counters are process-global)."""
    from cnosdb_tpu_torch.server import serving as _serving

    sv = executor.serving
    if sv is None:
        raise RuntimeError("run_pointqps needs the executor's serving "
                           "plane (CNOSDB_SERVING=0 turns it off)")
    rng = np.random.default_rng(seed)
    executor.execute_one(
        "CREATE TABLE IF NOT EXISTS pq (value DOUBLE, TAGS(host))",
        session)
    ts = BASE_TS + np.arange(per, dtype=np.int64) * 1_000_000_000
    vals = host_values(rng, n_hosts, per)
    _write_hosts(coord, tenant, db, "pq", "value",
                 [f"host_{h}" for h in range(n_hosts)],
                 np.broadcast_to(ts, vals.shape), vals)
    coord.engine.flush_all()

    qs = [f"SELECT time, value FROM pq WHERE host = 'host_{h}'"
          for h in range(n_hosts)]

    def every_host():
        for h, q in enumerate(qs):
            check_points(executor.execute_one(q, session), ts, vals[h])

    every_host()                        # warms the plan + result caches

    orders = [rng.integers(0, n_hosts, per_thread) for _ in range(threads)]
    lat: list[list[float]] = [[] for _ in range(threads)]
    got: list[list] = [[] for _ in range(threads)]

    def worker(i):
        def body():
            for j in orders[i]:
                t0 = time.perf_counter()
                rs = executor.execute_one(qs[j], session)
                _sync()
                lat[i].append(time.perf_counter() - t0)
                got[i].append(rs)
        return body

    c0 = _serving.counters_snapshot()
    elapsed = _threads([worker(i) for i in range(threads)])
    c1 = _serving.counters_snapshot()
    for i in range(threads):
        for j, rs in zip(orders[i], got[i]):
            check_points(rs, ts, vals[j])
    every_host()

    def delta(layer, outcome, a=c0, b=c1):
        return b.get((layer, outcome), 0) - a.get((layer, outcome), 0)

    hits, misses = delta("result_cache", "hit"), delta("result_cache",
                                                       "miss")
    all_lat = np.concatenate([np.asarray(x) for x in lat])
    total = int(len(all_lat))
    out = {
        "hosts": n_hosts, "points": per,
        "threads": threads,
        "requests": total,
        "point_qps": total / max(elapsed, 1e-9),
        "p50_ms": _pct_ms(all_lat, 50),
        "p99_ms": _pct_ms(all_lat, 99),
        "hit_ratio": hits / max(hits + misses, 1),
        "plan_rebinds": delta("plan_cache", "hit_rebind"),
    }

    # ---- fused micro-batching phase: unique literals defeat the result
    # cache so every request reaches the batch rendezvous
    w0 = _serving.width_histogram()
    prev_force, prev_win = sv.batcher.force, sv.batcher.window_s
    fgot: list[list] = [[] for _ in range(fthreads)]

    def fworker(i):
        def body():
            for k in range(fper):
                u = i * fper + k
                rs = executor.execute_one(
                    f"SELECT time, value FROM pq WHERE "
                    f"host = 'host_{u % n_hosts}' AND value > -{u}.0",
                    session)
                _sync()
                fgot[i].append((u, rs))
        return body

    sv.batcher.force = True
    sv.batcher.window_s = 0.002
    try:
        felapsed = _threads([fworker(i) for i in range(fthreads)])
    finally:
        sv.batcher.force, sv.batcher.window_s = prev_force, prev_win
    w1 = _serving.width_histogram()
    c2 = _serving.counters_snapshot()
    for answers in fgot:
        for u, rs in answers:
            check_points(rs, ts, vals[u % n_hosts], floor=-float(u))
    out["fused_widths"] = {str(k): w1.get(k, 0) - w0.get(k, 0)
                           for k in sorted(w1)
                           if w1.get(k, 0) - w0.get(k, 0)}
    out["fused_requests"] = fthreads * fper
    out["fused_queries"] = delta("batch", "fused", c1, c2)
    out["fused_qps"] = fthreads * fper / max(felapsed, 1e-9)
    out["answers_checked"] = 2 * n_hosts + total + fthreads * fper
    if out["fused_queries"] <= 0:
        raise AssertionError(
            f"pointqps: no request was fused ({out['fused_widths']})")
    return out


# ---------------------------------------------------------------------------
# gray-failure tail latency (the straggler bed)
# ---------------------------------------------------------------------------
def run_straggler(*, iters=60, delay_ms=120.0, rows=4000) -> dict:
    """Gray-failure tail-latency suite (parallel/health.py plane): a
    2-replica straggler bed (chaos/straggler.py: real wire, real engine,
    synthetic placement) of `rows` rows, scanned `iters` times in each of
    three phases:

      * healthy, hedging on: `healthy_hedges` fired should be 0;
      * the pinned primary browned out by `delay_ms`, hedging on: a short
        unmeasured adaptation stage first (`adaptation_hedges`,
        `adapt_p99_ms`), then the measured window, every scan's first
        attempt on the straggler and rescued by the hedge lane
        (`hedged_p99_ms` about the hedge trigger plus the healthy
        replica's latency);
      * the same brownout with CNOSDB_HEDGE=0: the unprotected tail (p99
        about the injected delay).

    The hedged and the unhedged scan must each return the healthy
    scan's batch byte for byte (`batch_bytes`), else it raises. The bed
    lives in a directory of its own, removed at the end."""
    from cnosdb_tpu_torch.chaos.straggler import StragglerBed, batch_bytes
    from cnosdb_tpu_torch.parallel import health

    prev_hedge = os.environ.pop("CNOSDB_HEDGE", None)
    root = tempfile.mkdtemp(prefix="cnosdb_straggler_")
    out: dict = {"iters": iters, "straggle_delay_ms": delay_ms,
                 "rows": rows}
    bed = None

    def phase(tag, n):
        lat = []
        for i in range(n):
            t0 = time.perf_counter()
            bed.scan_once(qid=f"{tag}-{i}")
            _sync()
            lat.append(time.perf_counter() - t0)
        return _pct_ms(lat, 50), _pct_ms(lat, 99)

    def hedge_counts():
        hedge, _ = health.counters_snapshot()
        agg: dict = {}
        for (outcome, _reason), v in hedge.items():
            agg[outcome] = agg.get(outcome, 0) + v
        return {k: agg.get(k, 0)
                for k in ("fired", "won", "lost", "cancelled",
                          "suppressed")}

    def parity(qid, what):
        if batch_bytes(bed.scan_once(qid=qid)) != ref:
            raise AssertionError(
                f"straggler: the {what} scan drifted from the healthy one")

    try:
        bed = StragglerBed(root, rows=rows)
        ref = batch_bytes(bed.scan_once(qid="warm-ref"))
        health.SCORER.reset()
        bed.warm_replicas()               # honest warm samples everywhere
        phase("warm", 12)                 # real p95s in the sketches
        health.reset_counters()
        out["healthy_p50_ms"], out["healthy_p99_ms"] = phase(
            "healthy", iters)
        out["healthy_hedges"] = hedge_counts()

        # brown out the pinned primary (the split targets the leader
        # first, for read-your-writes, so health never re-routes the
        # first attempt): every scan must be hedge-rescued
        victim = bed.replicas[0]
        victim.delay_s = delay_ms / 1e3
        health.reset_counters()
        _, out["adapt_p99_ms"] = phase("adapt", 8)
        time.sleep(delay_ms / 1e3 + 0.05)   # hedge-loser replies land,
        out["adaptation_hedges"] = hedge_counts()   # scorer sees them
        health.reset_counters()
        out["hedged_p50_ms"], out["hedged_p99_ms"] = phase(
            "straggle", iters)
        out["hedged"] = hedge_counts()
        parity("parity", "hedged")

        os.environ["CNOSDB_HEDGE"] = "0"
        health.SCORER.reset()
        out["nohedge_p50_ms"], out["nohedge_p99_ms"] = phase(
            "legacy", iters)
        parity("parity-nohedge", "unhedged")

        out["straggler_over_healthy"] = \
            out["hedged_p99_ms"] / max(out["healthy_p99_ms"], 1e-6)
        out["nohedge_over_healthy"] = \
            out["nohedge_p99_ms"] / max(out["healthy_p99_ms"], 1e-6)
    finally:
        _restore_env({"CNOSDB_HEDGE": prev_hedge})
        if bed is not None:
            bed.close()
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# memory governance under overload
# ---------------------------------------------------------------------------
def storm_sql(u: int) -> str:
    """The overload suite's storm: the u-varying predicate matches every
    row (no host is 'zzN'), so the answer is the same but a fresh query
    text defeats the result cache."""
    return (f"SELECT host, count(DISTINCT value), sum(value), "
            f"min(value), max(value) FROM ov WHERE host <> 'zz{u}' "
            f"GROUP BY host")


def storm_oracle(names, vals):
    """→ check(rows): a storm's rows are one per host of `names`, each
    with count(DISTINCT), min and max of vals[h] exactly and the sum
    within rel 1e-12 of math.fsum."""
    want = {n: (int(np.unique(v).size), math.fsum(v.tolist()),
                float(v.min()), float(v.max()))
            for n, v in zip(names, vals)}

    def check(rows):
        got: dict = {}
        for r in rows:
            assert len(r) == 5, r
            assert r[0] not in got, f"host {r[0]} twice"
            got[r[0]] = r[1:]
        assert set(got) == set(want), (sorted(set(want) - set(got))[:3],
                                       sorted(set(got) - set(want))[:3])
        for host, (c, s, mn, mx) in got.items():
            wc, ws, wmn, wmx = want[host]
            assert int(c) == wc, (host, c, wc)
            assert float(mn) == wmn and float(mx) == wmx, (host, mn, mx)
            assert abs(float(s) - ws) <= 1e-12 * abs(ws), (host, s, ws)
    return check


def run_overload(executor, coord, tenant, db, session, *, n_hosts=256,
                 per=200, factors=(0.5, 1.0, 2.0), seed=53) -> dict:
    """Memory-governance overload suite (server/memory.py plane): a
    closed-loop mix of ingest writers and wide count(DISTINCT) group-by
    storms, run once per factor with the broker budget set so the same
    workload sits at that factor of its measured footprint. Per phase it
    reports the degradation ladder's actions from the broker counters
    (pool reclaims, delayed, backpressure-shed and fail-closed writes,
    queued-query sheds, group-state spills) and client p99s and rejects.

    Every storm answer is held to a numpy oracle over the written
    arrays (`storm_oracle`). `bit_identical` compares each with the
    first, cold `CNOSDB_MEMORY=0` answer, as the reference does;
    `spill_identical` with a warm `CNOSDB_MEMORY=0` repeat taken right
    after it, so a route difference between the cold and the warm scan
    is not read as governance changing an answer; `route_identical`
    holds each row to the cold or the warm row of its host (the broker's
    reclaims empty the scan cache, so a storm may scan cold). A write or
    query refused by the ladder's typed errors is counted
    (`write_rejects`, `query_shed`); any other error is raised. Raises
    when governance is off, on any wrong answer, when a phase answers no
    storm, and when a phase at 2x or more books no spill and unspill."""
    from cnosdb_tpu_torch.errors import (AdmissionRejected, MemoryExceeded,
                                         WriteBackpressure)
    from cnosdb_tpu_torch.models.points import SeriesRows, WriteBatch
    from cnosdb_tpu_torch.models.schema import ValueType
    from cnosdb_tpu_torch.models.series import SeriesKey
    from cnosdb_tpu_torch.server import memory as memgov

    if not memgov.enabled():
        raise RuntimeError("run_overload needs memory governance "
                           "(CNOSDB_MEMORY=0 turns it off)")
    rng = np.random.default_rng(seed)
    executor.execute_one(
        "CREATE TABLE IF NOT EXISTS ov (value DOUBLE, TAGS(host))",
        session)
    names = [f"host_{h:03d}" for h in range(n_hosts)]
    ts = BASE_TS + np.arange(per, dtype=np.int64) * 1_000_000_000
    vals = host_values(rng, n_hosts, per)
    _write_hosts(coord, tenant, db, "ov", "value", names,
                 np.broadcast_to(ts, vals.shape), vals)
    coord.engine.flush_all()
    check = storm_oracle(names, vals)

    def governance_off(u):
        prev = os.environ.get("CNOSDB_MEMORY")
        os.environ["CNOSDB_MEMORY"] = "0"
        try:
            rows = executor.execute_one(storm_sql(u), session).rows()
        finally:
            _restore_env({"CNOSDB_MEMORY": prev})
        check(rows)
        return rows

    # oracles of the system: the governance-off path on the static
    # table, cold (the reference's) and warm
    baseline = governance_off(0)
    warm = governance_off(2)

    def ingest_batch(tag: int) -> WriteBatch:
        ts = (BASE_TS + np.arange(64, dtype=np.int64) * 1_000_000
              + tag * 100_000_000_000)
        wb = WriteBatch()
        for s in range(4):
            wb.add_series("ov_ing", SeriesRows(
                SeriesKey("ov_ing", {"host": f"ing_{(tag + s) % 32}"}), ts,
                {"value": (int(ValueType.FLOAT),
                           rng.normal(0, 1, ts.size))}))
        return wb

    # footprint reference: one dry mixed round at the resting budget
    coord.write_points(tenant, db, ingest_batch(0))
    check(executor.execute_one(storm_sql(1), session).rows())
    ref_used = max(memgov.BROKER.used(), 1 << 20)
    # group-state estimate mirrors sql/executor._acc_group_bytes: the
    # count(DISTINCT) sets dominate, 64 + 64*len per group
    est_state = n_hosts * (64 + 16 + 64 + 64 * per + 3 * 24)

    prev_group = memgov.GROUP_BYTES
    prev_delay = memgov.WRITE_DELAY_MS
    memgov.WRITE_DELAY_MS = 100     # keep the shed path fast, not 2s
    q_threads, q_iters = 2, 5
    w_threads, w_iters = 2, 10
    out: dict = {"table_rows": n_hosts * per, "ref_used_bytes": ref_used,
                 "group_state_est_bytes": est_state, "phases": {}}
    all_identical = True
    all_spill_identical = True
    all_route_identical = True
    try:
        for factor in factors:
            budget = max(int(ref_used / factor), 1 << 16)
            gbudget = int(est_state / factor)
            memgov.BROKER.resize(budget)
            memgov.GROUP_BYTES = gbudget
            coord.engine.flush_all()    # comparable resting state
            c0 = memgov.counters_snapshot()
            qlat: list[list[float]] = [[] for _ in range(q_threads)]
            wlat: list[list[float]] = [[] for _ in range(w_threads)]
            rejects = [0] * w_threads
            shed: list[str] = []
            answers: list = []
            tag = int(factor * 10)

            def qworker(i, tag=tag, qlat=qlat, shed=shed, answers=answers):
                def body():
                    for k in range(q_iters):
                        u = tag * 1000 + i * q_iters + k
                        t0 = time.perf_counter()
                        try:
                            rs = executor.execute_one(storm_sql(u), session)
                        except (AdmissionRejected, MemoryExceeded) as e:
                            shed.append(repr(e)[:120])   # the ladder's shed
                            continue
                        _sync()
                        qlat[i].append(time.perf_counter() - t0)
                        answers.append(rs.rows())
                return body

            def wworker(i, tag=tag, wlat=wlat, rejects=rejects):
                def body():
                    for k in range(w_iters):
                        t0 = time.perf_counter()
                        try:
                            coord.write_points(
                                tenant, db,
                                ingest_batch(tag * 1000 + i * w_iters + k))
                        except (WriteBackpressure, MemoryExceeded):
                            rejects[i] += 1   # the ladder's typed shed
                            time.sleep(0.05)
                            continue
                        wlat[i].append(time.perf_counter() - t0)
                return body

            _threads([qworker(i) for i in range(q_threads)]
                     + [wworker(i) for i in range(w_threads)])
            c1 = memgov.counters_snapshot()
            for rows in answers:
                check(rows)

            def delta(pool, action):
                return c1.get((pool, action), 0) - c0.get((pool, action), 0)

            qs = np.concatenate([np.asarray(x) for x in qlat])
            ws = np.concatenate([np.asarray(x) for x in wlat])
            identical = not shed and all(r == baseline for r in answers)
            spill_identical = all(r == warm for r in answers)
            route_identical = all(
                len(r) == len(baseline)
                and all(g in (c, w) for g, c, w in zip(r, baseline, warm))
                for r in answers)
            all_identical = all_identical and identical
            all_spill_identical = all_spill_identical and spill_identical
            all_route_identical = all_route_identical and route_identical
            name = f"{factor:g}x"
            out["phases"][name] = {
                "budget_bytes": budget,
                "group_budget_bytes": gbudget,
                "query_ok": int(qs.size),
                "query_p99_ms": _pct_ms(qs, 99),
                "write_ok": int(ws.size),
                "write_p99_ms": _pct_ms(ws, 99),
                "write_rejects": sum(rejects),
                "spills": delta("query_groups", "spill"),
                "unspills": delta("query_groups", "unspill"),
                "write_delayed": delta("write", "delayed"),
                "write_backpressure_shed": delta("write",
                                                 "backpressure_shed"),
                "write_fail_hard": delta("write", "fail_hard"),
                "queued_shed": delta("admission", "shed_queued"),
                "reclaims": sum(
                    v - c0.get(k, 0) for k, v in c1.items()
                    if k[1] == "reclaim"),
                "query_shed": len(shed),
                "storms_checked": len(answers),
                "bit_identical": identical,
                "spill_identical": spill_identical,
                "route_identical": route_identical,
                **({"query_errors": shed[:3]} if shed else {}),
            }
            ph = out["phases"][name]
            if not answers:
                raise AssertionError(f"overload {name}: no storm answered "
                                     f"({shed[:3]})")
            if factor >= 2 and not (ph["spills"] and ph["unspills"]):
                raise AssertionError(
                    f"overload {name}: the group-state spiller never ran "
                    f"({ph['spills']} spills, {ph['unspills']} unspills)")
    finally:
        memgov.BROKER.resize(0)         # back to config/auto
        memgov.GROUP_BYTES = prev_group
        memgov.WRITE_DELAY_MS = prev_delay
    out["bit_identical"] = all_identical
    out["spill_identical"] = all_spill_identical
    out["route_identical"] = all_route_identical
    out["cold_warm_identical"] = baseline == warm
    return out


# ---------------------------------------------------------------------------
# the mesh lane swept over 1, 2, 4 and 8 devices
# ---------------------------------------------------------------------------
MESH_SQL = ("SELECT host, date_bin(INTERVAL '1 hour', time) AS t, "
            "count(*) AS c, sum(v) AS sv, min(v) AS mn, max(v) AS mx "
            "FROM dg GROUP BY host, t")
HOUR_NS = 3_600_000_000_000


@contextlib.contextmanager
def mesh_pool(devices):
    """Within the block the mesh lane's device pool is `devices` (a list:
    `[cuda:0] * 8` is eight logical shards on one card), or the real pool
    when None. → the pool."""
    from cnosdb_tpu_torch.ops import placement

    saved = placement.mesh_devices
    if devices is not None:
        placement.mesh_devices = lambda: list(devices)
    try:
        yield list(placement.mesh_devices())
    finally:
        placement.mesh_devices = saved


def mesh_table(n_hosts: int, per: int, seed: int = 41):
    """→ (names, ts [n_hosts, per], vals [n_hosts, per]): the mesh
    suite's table, `per` points a host over about 48 one-hour buckets,
    host h's times offset by h ns, as the reference draws it."""
    step = max(48 * HOUR_NS // per, 1)
    rng = np.random.default_rng(seed)
    names = [f"host_{h:02d}" for h in range(n_hosts)]
    ts = np.stack([BASE_TS + np.arange(per, dtype=np.int64) * step + h
                   for h in range(n_hosts)])
    return names, ts, host_values(rng, n_hosts, per)


def mesh_oracle(names, ts, vals):
    """→ check(rs): MESH_SQL's answer has one row per (host, hour) that
    holds data, in any order, with count, min and max exact and the sum
    within rel 1e-12 of math.fsum."""
    n_hosts, per = vals.shape
    hid = np.repeat(np.arange(n_hosts, dtype=np.int64), per)
    t = (ts // HOUR_NS * HOUR_NS).ravel()
    v = vals.ravel()
    order = np.lexsort((t, hid))
    hid, t, v = hid[order], t[order], v[order]
    starts = np.flatnonzero(np.r_[True, (np.diff(hid) != 0)
                                  | (np.diff(t) != 0)])
    w_h, w_t = hid[starts], t[starts]
    w_c = np.diff(np.r_[starts, len(v)])
    w_mn = np.minimum.reduceat(v, starts)
    w_mx = np.maximum.reduceat(v, starts)
    w_s = np.array([math.fsum(p.tolist()) for p in np.split(v, starts[1:])])
    index = {n: i for i, n in enumerate(names)}

    def check(rs):
        assert list(rs.names) == ["host", "t", "c", "sv", "mn", "mx"], \
            rs.names
        g_h = np.array([index[str(n)] for n in _col(rs, "host")],
                       dtype=np.int64)
        g_t = np.asarray(_col(rs, "t")).astype(np.int64)
        assert len(g_h) == len(w_h), (len(g_h), len(w_h))
        o = np.lexsort((g_t, g_h))
        assert np.array_equal(g_h[o], w_h) and np.array_equal(g_t[o], w_t), \
            "groups differ"
        assert np.array_equal(
            np.asarray(_col(rs, "c")).astype(np.int64)[o], w_c), "count"
        for col, want in (("mn", w_mn), ("mx", w_mx)):
            assert np.array_equal(
                np.asarray(_col(rs, col), dtype=np.float64)[o], want), col
        got_s = np.asarray(_col(rs, "sv"), dtype=np.float64)[o]
        assert np.all(np.abs(got_s - w_s) <= 1e-12 * np.abs(w_s)), "sum"
    return check


def run_mesh(executor, coord, tenant, db, session, *, rows=1_000_000,
             iters=5, n_hosts=32, devices=None, seed=41) -> dict:
    """Mesh execution plane sweep (ops/mesh_exec.py +
    parallel/distributed_agg.py): the TSBS `double_groupby` shape (host x
    1 h bucket, count/sum/min/max) over an 8-shard table of `rows` rows,
    swept across 1, 2, 4 and 8 mesh devices through CNOSDB_MESH_DEVICES
    (each width takes the first d entries of the pool), plus the
    CNOSDB_MESH=0 legacy per-batch kernels and host merge as the
    baseline. Timings are warm steady state (two untimed runs first).

    `devices` is the pool: None is placement.mesh_devices(), a list is
    used as given (`[cuda:0] * 8`: eight logical shards on one card).
    `cards` is the number of distinct devices in it; where it is below
    8, `speedup_8x` is labelled as logical shards (`speedup_8x_of`), not
    scaling. Every answer is held to a numpy oracle (`mesh_oracle`);
    `bit_identical` reports whether every width's answer repr-equals
    the legacy one. Raises on a wrong answer, and unless every engaged
    query booked the collective merge and no host merge
    (`zero_host_merges`)."""
    from cnosdb_tpu_torch.parallel import mesh
    from cnosdb_tpu_torch.sql.executor import Session
    from cnosdb_tpu_torch.utils import stages as _stages

    executor.execute_one(
        "CREATE DATABASE IF NOT EXISTS meshbench WITH SHARD 8 REPLICA 1",
        session)
    ms = Session(database="meshbench")
    per = max(64, rows // n_hosts)
    names, ts, vals = mesh_table(n_hosts, per, seed)
    _write_hosts(coord, tenant, "meshbench", "dg", "v", names, ts, vals)
    coord.engine.flush_all()
    coord.engine.compact_all()
    check = mesh_oracle(names, ts, vals)
    del ts, vals

    def norm(rs):
        return (rs.names, [repr(c.tolist()) for c in rs.columns],
                [str(c.dtype) for c in rs.columns])

    keep_stages = ("kernel_ms", "merge_ms", "finalize_ms",
                   "mesh.plan_ms", "mesh.upload_ms", "mesh.collective_ms",
                   "mesh.assemble_ms", "mesh.plan_cache_hit",
                   "mesh.plan_cache_miss")

    def timed_pass():
        """→ (p50_ms, p99_ms, mean per-stage ms, outcome deltas, norm)."""
        for _ in range(2):              # scan + prep caches, then settled
            check(executor.execute_one(MESH_SQL, ms))
        c0 = mesh.outcomes_snapshot()
        lat, snaps, answers = [], [], []
        for _ in range(iters):
            prof = _stages.QueryProfile()
            t0 = time.perf_counter()
            with _stages.profile_scope(prof):
                rs = executor.execute_one(MESH_SQL, ms)
                _sync()
            lat.append(time.perf_counter() - t0)
            snaps.append(prof.snapshot())
            answers.append(rs)
        c1 = mesh.outcomes_snapshot()
        for rs in answers:
            check(rs)
        stg = {}
        for k in keep_stages:
            tot = sum(s.get(k, 0) for s in snaps)
            if tot:
                stg[k] = tot / iters
        outcomes = {f"{lane}:{reason}": v - c0.get((lane, reason), 0)
                    for (lane, reason), v in c1.items()
                    if v - c0.get((lane, reason), 0)}
        return (_pct_ms(lat, 50), _pct_ms(lat, 99), stg, outcomes,
                norm(answers[-1]))

    knobs = ("CNOSDB_MESH", "CNOSDB_MESH_DEVICES",
             "CNOSDB_MESH_MIN_DEVICES", "CNOSDB_MESH_MIN_ROWS")
    prev_env = {k: os.environ.get(k) for k in knobs}
    prev_serving = executor.serving
    # repeats must reach the aggregate path, not the serving result cache
    executor.serving = None
    out: dict = {"rows": n_hosts * per, "hosts": n_hosts, "iters": iters,
                 "host_cores": len(os.sched_getaffinity(0)), "devices": {}}
    identical = True
    zero_host = True
    try:
        with mesh_pool(devices) as pool:
            avail = len(pool)
            cards = len({str(d) for d in pool})
            out.update(devices_available=avail, cards=cards,
                       pool=[str(d) for d in pool])
            os.environ["CNOSDB_MESH_MIN_ROWS"] = "0"
            os.environ["CNOSDB_MESH_MIN_DEVICES"] = "1"

            # legacy host-merge baseline: per-batch kernels + vec merge
            os.environ["CNOSDB_MESH"] = "0"
            p50, p99, stg, outc, oracle = timed_pass()
            if outc.get("exec:engaged", 0):
                raise AssertionError(f"mesh: the legacy pass engaged {outc}")
            out["legacy"] = {"p50_ms": p50, "p99_ms": p99, "stages": stg}

            os.environ["CNOSDB_MESH"] = "1"
            for d in (1, 2, 4, 8):
                if d > avail:
                    out["devices"][str(d)] = {
                        "skipped": f"only {avail} devices in the pool"}
                    continue
                os.environ["CNOSDB_MESH_DEVICES"] = str(d)
                p50, p99, stg, outc, got = timed_pass()
                engaged = outc.get("exec:engaged", 0)
                ok = engaged == iters \
                    and outc.get("merge:collective", 0) == engaged \
                    and not outc.get("merge:host", 0)
                zero_host = zero_host and ok
                identical = identical and got == oracle
                out["devices"][str(d)] = {
                    "p50_ms": p50, "p99_ms": p99, "stages": stg,
                    "outcomes": outc, "bit_identical": got == oracle}
        d1 = out["devices"].get("1", {}).get("p50_ms")
        d8 = out["devices"].get("8", {}).get("p50_ms")
        if d1 and d8:
            out["speedup_8x"] = d1 / d8
            out["speedup_8x_of"] = (
                "8 cards" if cards >= 8 else
                f"8 logical shards on {cards} device(s): not scaling")
            out["speedup_vs_host_merge"] = out["legacy"]["p50_ms"] / d8
    finally:
        executor.serving = prev_serving
        _restore_env(prev_env)
    out["bit_identical"] = identical
    out["zero_host_merges"] = zero_host
    if not zero_host:
        raise AssertionError(
            "mesh: a query did not merge through the collective: "
            + str({d: r.get("outcomes") for d, r in out["devices"].items()}))
    return out
