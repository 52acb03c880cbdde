"""The plain reference: TSBS answers from the generated arrays, in numpy.

It imports numpy and the benchmark's generator only: nothing of the
program. `dtype` is the precision it computes in: float64 is the
reference; float32 is the control (the nearest precision below the
configuration's DOUBLE), which the comparison must fail; its answers keep
that precision, as a float32 program's would.
"""
from __future__ import annotations

import numpy as np

from . import tsbs

NS = tsbs.NS


def window_index(cfg: dict, lo: int, hi: int) -> tuple[int, int]:
    """The points of the preloaded span with lo <= time < hi."""
    step = cfg["log_interval_s"] * NS
    i0 = max(0, -(-(lo - cfg["start_ns"]) // step))
    i1 = min(tsbs.points(cfg), -(-(hi - cfg["start_ns"]) // step))
    return i0, i1


def answer(cfg: dict, query: dict, p: dict, hist: np.ndarray,
           dtype=np.float64) -> dict:
    """One query's answer over the preloaded history: {"host": [groups]
    (-1 where not grouped by host), "t": [groups] bin start ns,
    <field>: [groups]}, ordered by (host, t)."""
    i0, i1 = window_index(cfg, p["lo"], p["hi"])
    step = cfg["log_interval_s"] * NS
    bin_ns = query["bin_s"] * NS
    t = cfg["start_ns"] + np.arange(i0, i1, dtype=np.int64) * step
    b = t - t % bin_ns                       # date_bin from the epoch
    starts = np.flatnonzero(np.r_[True, b[1:] != b[:-1]])
    bins = b[starts]
    counts = np.diff(np.r_[starts, len(b)])
    hosts = np.asarray(p["hosts"] or range(cfg["scale"]), dtype=np.int64)
    out = {}
    for fi, f in enumerate(tsbs.query_fields(cfg, query)):
        x = hist[fi][hosts, i0:i1].astype(dtype)
        if query["agg"] == "avg":
            s = np.add.reduceat(x, starts, axis=1, dtype=dtype)
            v = s / counts.astype(dtype)
        elif query["agg"] == "max":
            v = np.maximum.reduceat(x, starts, axis=1)
        elif query["agg"] == "min":
            v = np.minimum.reduceat(x, starts, axis=1)
        elif query["agg"] == "sum":
            v = np.add.reduceat(x, starts, axis=1, dtype=dtype)
        else:
            raise ValueError(f"aggregate {query['agg']}")
        if not query["by_host"]:
            v = (v.max(axis=0) if query["agg"] == "max" else
                 v.min(axis=0) if query["agg"] == "min" else None)
            if v is None:
                raise ValueError("an ungrouped avg or sum over hosts is "
                                 "not a TSBS devops query")
            v = v[None, :]
        out[f] = v.ravel()
    nh = len(hosts) if query["by_host"] else 1
    out["host"] = (np.repeat(hosts, len(bins)) if query["by_host"]
                   else np.full(len(bins), -1, dtype=np.int64))
    out["t"] = np.tile(bins, nh)
    return out


def batch_rows(cfg: dict, values: np.ndarray, times: np.ndarray) -> dict:
    """The rows of one live batch: {"host", "t", <field>...} ordered by
    (host, t), as the readback returns them once sorted."""
    steps, nh, nf = values.shape
    out = {"host": np.repeat(np.arange(nh, dtype=np.int64), steps),
           "t": np.tile(times, nh)}
    for fi, f in enumerate(cfg["fields"]):
        out[f] = values[:, :, fi].T.ravel()
    return out


def host_totals(cfg: dict, values_of, batches: list, batch_rows_n: int,
                dtype=np.float64) -> dict:
    """Per host, over the acknowledged live batches: the row count and
    each field's sum. `values_of(batch)` gives a batch's values."""
    nh, nf = cfg["scale"], len(cfg["fields"])
    steps = tsbs.live_steps(cfg, batch_rows_n)
    sums = np.zeros((nh, nf), dtype=dtype)
    for b in batches:
        sums += values_of(b).astype(dtype).sum(axis=0, dtype=dtype)
    return {"count": np.full(nh, steps * len(batches), dtype=np.int64),
            "sum": sums}
