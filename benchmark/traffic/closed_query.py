"""Closed-loop query clients: each sends its next TSBS query over HTTP
(/api/v1/sql) when the answer to its last one has come, from the start
of the window to its end. The mix's "readers" block gives the number of
clients and the query shape; each client draws its own query stream
from the seed. Every answer is kept, then held to the plain reference.
"""
from __future__ import annotations

import http.client
import json
import os
import threading
import time

import numpy as np

from benchmark import check, clients, reference, tsbs

PROFILE_HEADER = "X-CnosDB-Profile"
SUMMARY_HEADER = "X-CnosDB-Profile-Summary"
WARM_STREAM = 1 << 20           # the warm-up's queries: no client's stream


def specs(job: dict) -> list:
    return [(readers, 0)]


def sql_path(cfg: dict) -> str:
    return f"/api/v1/sql?db={cfg['database']}"


def send_query(conn, cfg: dict, text: str, profile: bool):
    headers = {"Content-Type": "text/plain", "Accept": "application/csv"}
    if profile:
        headers[PROFILE_HEADER] = "1"
    conn.request("POST", sql_path(cfg), body=text.encode(), headers=headers)
    r = conn.getresponse()
    return r.status, r.read(), r.getheader(SUMMARY_HEADER)


def readers(_k: int, job: dict, shared) -> dict:
    """Every client of the mix, each a thread of this one process (the
    clients wait on the node; one process keeps their load steady), and
    the host probe beside them."""
    port, t0, t1 = clients.wait_go(shared)
    out: list = []
    probe: list = []
    threads = [threading.Thread(target=lambda c=c: out.extend(
        reader(c, job, port, t0, t1)))
        for c in range(job["mix"]["readers"]["clients"])]
    threads.append(threading.Thread(target=clients.probe_host,
                                    args=(t0, t1, probe)))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {"queries": out, "probe": probe}


def reader(c: int, job: dict, port: int, t0: float, t1: float) -> list:
    """One client's closed loop; its answers go to files in the run's
    work directory, named by client and query number."""
    cfg, q = job["cfg"], job["mix"]["readers"]["query"]
    stream = tsbs.query_stream(cfg, q, job["seed"], c)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    recs = []
    clients.sleep_until(t0)
    i = 0
    while time.monotonic() < t1:
        text = tsbs.sql(cfg, q, next(stream))
        start = time.monotonic()
        try:
            status, body, summary = send_query(conn, cfg, text, job["trace"])
        except (OSError, http.client.HTTPException) as e:
            status, body, summary = 0, repr(e).encode(), None
            conn.close()
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
        done = time.monotonic()
        path = os.path.join(job["workdir"], f"q{c}_{i}.csv")
        with open(path, "wb") as f:
            f.write(body)
        recs.append({"client": c, "i": i, "start": start, "done": done,
                     "ok": status == 200, "status": status, "file": path,
                     "profile": json.loads(summary) if summary else None})
        i += 1
    conn.close()
    return recs


def warm(job: dict, port: int, shared=None) -> dict:
    """A few queries of the cell's own shape from a stream no client
    uses, so the window finds plans and kernels ready."""
    cfg, q = job["cfg"], job["mix"]["readers"]["query"]
    stream = tsbs.query_stream(cfg, q, job["seed"], WARM_STREAM)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    for _ in range(job["mix"]["readers"]["warm"]):
        status, body, _s = send_query(conn, cfg, tsbs.sql(cfg, q, next(stream)),
                                      False)
        if status != 200:
            raise RuntimeError(f"warm-up query: HTTP {status} "
                               f"{body[:300]!r}")
    conn.close()
    return {}


def _params(job: dict, queries: list) -> list:
    """(record, its query's parameters) for every query, each client's
    stream replayed from the seed in the order it sent them."""
    cfg, q = job["cfg"], job["mix"]["readers"]["query"]
    streams: dict = {}
    out = []
    for r in sorted(queries, key=lambda r: (r["client"], r["i"])):
        s = streams.setdefault(r["client"], tsbs.query_stream(
            cfg, q, job["seed"], r["client"]))
        out.append((r, next(s)))
    return out


def check_answers(job: dict, queries: list, hist: np.ndarray) -> dict:
    """Every answered query, as the HTTP API returned it, against the
    reference (float64)."""
    cfg, q = job["cfg"], job["mix"]["readers"]["query"]
    fields = tsbs.query_fields(cfg, q)
    worst = {"keys_wrong": 0, "gap": 0.0}
    for r, p in _params(job, queries):
        if not r["ok"]:
            continue
        with open(r["file"]) as f:
            got = check.answer_arrays(f.read(), fields)
        c = check.compare(got, reference.answer(cfg, q, p, hist), fields)
        worst["keys_wrong"] += c["keys_wrong"]
        worst["gap"] = max(worst["gap"], c["gap"])
    return worst


def control_answers(job: dict, queries: list, hist: np.ndarray) -> list:
    """The query records with the control's answers in the program's
    place: the float32 reference, rendered as the node's CSV, in files
    beside the program's."""
    cfg, q = job["cfg"], job["mix"]["readers"]["query"]
    out = []
    for r, p in _params(job, queries):
        if r["ok"]:
            low = reference.answer(cfg, q, p, hist, dtype=np.float32)
            cols = {"t": low["t"]}
            if q["by_host"]:
                cols["hostname"] = check.host_names(cfg, low["host"])
            cols.update({f: low[f] for f in tsbs.query_fields(cfg, q)})
            r = {**r, "file": r["file"] + ".control"}
            with open(r["file"], "w") as f:
                f.write(check.render_csv(cols))
        out.append(r)
    return out


def after(job: dict, results: list, port: int) -> dict:
    return {}


def judge(job: dict, results: list, post: dict, hist: np.ndarray) -> dict:
    """The numbers compared for a query-only mix."""
    qs = [r for res in results for r in res.get("queries", [])]
    worst = check_answers(job, qs, hist)
    name = job["mix"]["readers"]["query"]["agg"] + "_gap"
    return {"groups_wrong": worst["keys_wrong"], name: worst["gap"]}


def control(job: dict, results: list, post: dict,
            hist: np.ndarray) -> tuple[list, dict]:
    """(results, post) with the control's answers in the program's."""
    qs = [r for res in results for r in res.get("queries", [])]
    return [{"queries": control_answers(job, qs, hist)}], post
