"""TSBS devops data, queries and line protocol, generated from a seed.

Everything here is numpy and the standard library: the node under test
and the plain reference (reference.py) are handed the same arrays. A
configuration file (configs/<name>.json) gives the schema, the scale and
the span; a traffic mix (traffic/<name>.json) gives the query shape.

TSBS's devops generator (github.com/timescale/tsbs, devops use case):
each host draws its ten tags once from fixed value sets; each cpu field
is a random walk that starts uniform in [0, 100), steps N(0, 1) every
log interval and is clamped to [0, 100]. The walks here follow that
rule with numpy's PCG64, not Go's math/rand, so the values differ from
TSBS's files and the distribution does not.
"""
from __future__ import annotations

import numpy as np

NS = 10**9
WALK_CHUNK = 512          # time steps generated per numpy call


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of one seed (any whole number)."""
    return np.random.default_rng([seed % 2**64, *stream])


# ---------------------------------------------------------------- fleet
def host_tags(cfg: dict, seed: int) -> list[dict]:
    """Each host's tags, in TSBS's order (hostname first)."""
    g = rng(seed, 1)
    n = cfg["scale"]
    cols: dict[str, list] = {}
    for name, rule in cfg["tags"].items():
        if "format" in rule:
            cols[name] = [rule["format"].format(i=i) for i in range(n)]
        elif "choice" in rule:
            vals = rule["choice"]
            cols[name] = [vals[k] for k in g.integers(0, len(vals), n)]
        elif "choice_by" in rule:
            by = cols[rule["choice_by"]]
            pick = g.random(n)
            cols[name] = [rule["values"][b][int(p * len(rule["values"][b]))]
                          for b, p in zip(by, pick)]
        elif "int_below" in rule:
            cols[name] = [str(k) for k in g.integers(0, rule["int_below"], n)]
        else:
            raise ValueError(f"tag {name}: unknown rule {rule}")
    return [{k: cols[k][i] for k in cols} for i in range(n)]


def points(cfg: dict) -> int:
    return cfg["span_s"] // cfg["log_interval_s"]


def timestamps(cfg: dict) -> np.ndarray:
    step = cfg["log_interval_s"] * NS
    return cfg["start_ns"] + np.arange(points(cfg), dtype=np.int64) * step


def walk(cfg: dict, g: np.random.Generator, steps: int,
         width: int) -> np.ndarray:
    """`width` clamped random walks of `steps` points: [steps, width]."""
    w = cfg["walk"]
    lo, hi = w["low"], w["high"]
    x = lo + (hi - lo) * g.random(width)
    out = np.empty((steps, width))
    for t0 in range(0, steps, WALK_CHUNK):
        t1 = min(t0 + WALK_CHUNK, steps)
        d = g.normal(w["step_mean"], w["step_stddev"], (t1 - t0, width))
        for k in range(t1 - t0):
            x += d[k]
            np.clip(x, lo, hi, out=x)
            out[t0 + k] = x
    return out


def history(cfg: dict, seed: int) -> np.ndarray:
    """The preloaded values: [fields, hosts, points] float64."""
    nf, nh = len(cfg["fields"]), cfg["scale"]
    v = walk(cfg, rng(seed, 2), points(cfg), nf * nh)
    return np.ascontiguousarray(v.T).reshape(nf, nh, -1)


# ---------------------------------------------------------------- queries
def query_stream(cfg: dict, query: dict, seed: int, stream: int):
    """Endless query parameters for one client (`stream`), TSBS's draws:
    a window of `window_s` starting uniformly at random (ns) inside the
    preloaded span, and `hosts` distinct random hosts (0: the fleet)."""
    g = rng(seed, 3, stream)
    lo = cfg["start_ns"]
    hi = lo + cfg["span_s"] * NS - query["window_s"] * NS
    while True:
        start = int(lo + g.integers(0, hi - lo))
        hosts = (sorted(int(h) for h in g.permutation(cfg["scale"])
                        [:query["hosts"]]) if query["hosts"] else [])
        yield {"lo": start, "hi": start + query["window_s"] * NS,
               "hosts": hosts}


def query_fields(cfg: dict, query: dict) -> list[str]:
    return cfg["fields"][:query["fields"]]


def sql(cfg: dict, query: dict, p: dict) -> str:
    """The SQL text of one query (TSBS's intent, CnosDB's dialect)."""
    b = query["bin_s"]
    interval = "1 hour" if b == 3600 else f"{b} seconds"
    aggs = ", ".join(f"{query['agg']}({f}) AS {f}"
                     for f in query_fields(cfg, query))
    keys = "t, hostname" if query["by_host"] else "t"
    where = f"time >= {p['lo']} AND time < {p['hi']}"
    if p["hosts"]:
        names = ", ".join(f"'{cfg['tags']['hostname']['format'].format(i=h)}'"
                          for h in p["hosts"])
        where = f"hostname IN ({names}) AND {where}"
    return (f"SELECT date_bin(INTERVAL '{interval}', time) AS t"
            f"{', hostname' if query['by_host'] else ''}, {aggs} "
            f"FROM {cfg['measurement']} WHERE {where} GROUP BY {keys}")


# ---------------------------------------------------------------- live ingest
def live_start(cfg: dict) -> int:
    return cfg["start_ns"] + cfg["span_s"] * NS


def live_steps(cfg: dict, batch_rows: int) -> int:
    steps = batch_rows // cfg["scale"]
    if steps * cfg["scale"] != batch_rows:
        raise ValueError(f"batch of {batch_rows} rows is not whole steps of "
                         f"{cfg['scale']} hosts")
    return steps


def live_values(cfg: dict, seed: int, template: int,
                batch_rows: int) -> np.ndarray:
    """One live template's values: [steps, hosts, fields] float64."""
    nf, nh = len(cfg["fields"]), cfg["scale"]
    steps = live_steps(cfg, batch_rows)
    return walk(cfg, rng(seed, 4, template), steps, nh * nf).reshape(
        steps, nh, nf)


def live_times(cfg: dict, batch: int, batch_rows: int) -> np.ndarray:
    """The timestamps of global batch `batch`: [steps] ns."""
    steps = live_steps(cfg, batch_rows)
    k = np.arange(batch * steps, (batch + 1) * steps, dtype=np.int64)
    return live_start(cfg) + k * cfg["log_interval_s"] * NS


def series_prefixes(cfg: dict, tags: list[dict]) -> list[str]:
    return [cfg["measurement"] + "," + ",".join(f"{k}={v}"
                                                for k, v in t.items())
            for t in tags]


def template_rows(cfg: dict, tags: list[dict], values: np.ndarray) -> list:
    """Line protocol rows of one template without their timestamps, in
    TSBS load's order (time-major, host-minor): each ends in a space."""
    pre = series_prefixes(cfg, tags)
    steps, nh, _nf = values.shape
    txt = values.astype(str)
    names = [f + "=" for f in cfg["fields"]]
    rows = []
    for k in range(steps):
        for h in range(nh):
            rows.append(pre[h] + " " + ",".join(
                n + v for n, v in zip(names, txt[k, h])) + " ")
    return rows


def batch_body(rows: list, times: np.ndarray, nh: int) -> bytes:
    """A template's rows with the timestamps of one batch."""
    ts = [str(int(t)) + "\n" for t in times]
    return "".join(r + ts[i // nh] for i, r in enumerate(rows)).encode()
