"""The comparison that decides `correct`: the program's answers, as the
HTTP API returned them (CSV), against the plain reference's.

A gap is |program - reference| / max(|reference|, 1): relative for the
TSBS values in (1, 100], absolute below, so that a walk clamped at 0
gives no division by zero.
"""
from __future__ import annotations

import numpy as np


def parse_csv(text: str) -> dict:
    """{column: [str]} of a CSV answer with no quoted cells."""
    lines = text.rstrip("\n").split("\n")
    names = lines[0].split(",")
    rows = [ln.split(",") for ln in lines[1:]]
    if any(len(r) != len(names) for r in rows):
        raise ValueError("a CSV row of another width than its header")
    return {n: [r[i] for r in rows] for i, n in enumerate(names)}


def cell(v) -> str:
    """One value as the node's CSV renders it (server/http.py _cell, for
    the types an answer here holds): a float32 by its shortest float32
    text, a float64 by repr, 0.0 unsigned, an integer as is."""
    if isinstance(v, (float, np.floating)) and v == 0.0:
        return repr(0.0)
    if isinstance(v, np.float32):
        return str(v)
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    if isinstance(v, np.integer):
        return str(int(v))
    return str(v)


def render_csv(columns: dict) -> str:
    """{name: values} as a CSV answer: what the control puts in the
    program's place, so that it is read back as the program's is."""
    names = list(columns)
    rows = zip(*(columns[n] for n in names))
    return "\n".join([",".join(names)]
                     + [",".join(cell(v) for v in r) for r in rows]) + "\n"


def host_names(cfg: dict, idx) -> list:
    return [cfg["tags"]["hostname"]["format"].format(i=int(i)) for i in idx]


def host_index(names: list) -> np.ndarray:
    """TSBS hostnames (host_<i>) to i."""
    return np.array([int(h[5:]) for h in names], dtype=np.int64)


def answer_arrays(text: str, fields: list, time_col: str = "t") -> dict:
    """A CSV answer as the reference's arrays ({"host", "t", fields})."""
    c = parse_csv(text)
    n = len(c[time_col])
    out = {"host": (host_index(c["hostname"]) if "hostname" in c
                    else np.full(n, -1, dtype=np.int64)),
           "t": np.array(c[time_col], dtype=np.int64)}
    for f in fields:
        out[f] = np.array([float(v) if v else np.nan for v in c[f]])
    return out


def _sorted(a: dict) -> dict:
    order = np.lexsort((a["t"], a["host"]))
    return {k: np.asarray(v)[order] for k, v in a.items()}


def gap(got: np.ndarray, want: np.ndarray) -> float:
    if len(want) == 0:
        return 0.0
    d = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    d[np.isnan(d)] = np.inf          # a NaN where a value is due
    return float(d.max())


def compare(got: dict, want: dict, fields: list) -> dict:
    """Groups (or rows) keyed by (host, t): how many are missing, extra
    or duplicated (`keys_wrong`), and the widest gap over the rest."""
    g, w = _sorted(got), _sorted(want)
    same = (len(g["t"]) == len(w["t"]) and np.array_equal(g["host"], w["host"])
            and np.array_equal(g["t"], w["t"]))
    if same:
        return {"keys_wrong": 0,
                "gap": max((gap(g[f], w[f]) for f in fields), default=0.0),
                "values_differ": int(sum(np.count_nonzero(g[f] != w[f])
                                         for f in fields))}
    gkeys = list(zip(g["host"].tolist(), g["t"].tolist()))
    wkeys = list(zip(w["host"].tolist(), w["t"].tolist()))
    gi = {k: i for i, k in enumerate(gkeys)}
    wi = {k: i for i, k in enumerate(wkeys)}
    both = [k for k in wi if k in gi]
    wrong = (len(gkeys) - len(gi)) + len(set(gi) ^ set(wi))
    a = np.array([gi[k] for k in both], dtype=np.int64)
    b = np.array([wi[k] for k in both], dtype=np.int64)
    return {"keys_wrong": int(wrong),
            "gap": max((gap(g[f][a], w[f][b]) for f in fields), default=0.0),
            "values_differ": int(sum(np.count_nonzero(g[f][a] != w[f][b])
                                     for f in fields))}


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """Each compared number beside its limit: correct when none exceeds
    its limit (a number may equal it). Returns (correct, lines)."""
    ok = True
    lines = []
    for name, value in numbers.items():
        lim = limits[name]
        passed = value <= lim
        ok &= passed
        lines.append(f"{name} {value!r} limit {lim!r}"
                     f"{'' if passed else ' FAILED'}")
    return ok, lines
