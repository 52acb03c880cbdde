"""Writers beside readers: live monitoring. The mix's "writers" block
gives the connections (threads over a few processes), the batch size and
the number of value templates; its "readers" block the closed-loop
query clients of closed_query.py.

Each writer connection takes the next global batch number, sends that
batch as line protocol to /api/v1/write and takes the next when the ack
comes, as TSBS load's workers do. Batch b holds the next `batch_rows`
rows of the fleet past the preloaded span in TSBS's time order: its
timestamps follow from b, its values are template b mod `templates`,
built in set-up so that no writer formats values in the window. A
refused batch (HTTP 503 or 429) is sent again until `retry_s` after the
window; the rows of every acknowledged batch are read back after it.
"""
from __future__ import annotations

import http.client
import threading
import time

import numpy as np

from benchmark import check, clients, reference, tsbs
from benchmark.traffic import closed_query as cq

RETRY_STATUS = (429, 503)
RETRY_SLEEP_S = 0.05


def specs(job: dict) -> list:
    return cq.specs(job) + [(writer, k)
                            for k in range(job["mix"]["writers"]["procs"])]


def write_path(cfg: dict) -> str:
    return f"/api/v1/write?db={cfg['database']}&precision=ns"


def templates(job: dict, which) -> dict:
    cfg, w = job["cfg"], job["mix"]["writers"]
    tags = tsbs.host_tags(cfg, job["seed"])
    return {j: tsbs.template_rows(cfg, tags, tsbs.live_values(
        cfg, job["seed"], j, w["batch_rows"])) for j in which}


def send_batch(conn, job: dict, rows: dict, b: int, until: float) -> dict:
    """Send batch `b` until it is acknowledged, refused for good, or
    `until` passes. → its record."""
    cfg, w = job["cfg"], job["mix"]["writers"]
    body = tsbs.batch_body(rows[b % w["templates"]],
                           tsbs.live_times(cfg, b, w["batch_rows"]),
                           cfg["scale"])
    start = time.monotonic()
    attempts, status, waited = 0, 0, 0.0
    while True:
        attempts += 1
        t = time.monotonic()
        try:
            conn.request("POST", write_path(cfg), body=body,
                         headers={"Content-Type": "text/plain"})
            r = conn.getresponse()
            r.read()
            status = r.status
        except (OSError, http.client.HTTPException):
            status = 0
            conn.close()
        waited += time.monotonic() - t
        if status == 200 or (status not in RETRY_STATUS and status != 0) \
                or time.monotonic() > until:
            break
        time.sleep(RETRY_SLEEP_S)
    return {"batch": b, "start": start, "done": time.monotonic(),
            "ok": status == 200, "status": status, "attempts": attempts,
            "rows": w["batch_rows"], "wait_s": waited}


def writer(k: int, job: dict, shared) -> dict:
    """One writer process: its share of the connections, each a thread."""
    w = job["mix"]["writers"]
    rows = templates(job, range(w["templates"]))
    n = w["connections"] // w["procs"] + (k < w["connections"] % w["procs"])
    port, t0, t1 = clients.wait_go(shared)
    recs: list = []
    lock = threading.Lock()

    def connection():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        clients.sleep_until(t0)
        mine = []
        while time.monotonic() < t1:
            mine.append(send_batch(conn, job, rows, clients.next_batch(shared),
                                   t1 + w["retry_s"]))
        conn.close()
        with lock:
            recs.extend(mine)

    threads = [threading.Thread(target=connection) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {"writes": recs, "connections": n}


def warm(job: dict, port: int, shared) -> dict:
    """The readers' warm-up queries, then `warm` batches through the
    write path (batch numbers 0.., acknowledged and read back like any)."""
    cq.warm(job, port)
    w = job["mix"]["writers"]
    rows = templates(job, {b % w["templates"] for b in range(w["warm"])})
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    recs = []
    for _ in range(w["warm"]):
        r = send_batch(conn, job, rows, clients.next_batch(shared),
                       time.monotonic() + w["retry_s"])
        if not r["ok"]:
            raise RuntimeError(f"warm-up write: HTTP {r['status']}")
        recs.append(r)
    conn.close()
    return {"writes": recs}


def _runs(ids: list) -> list:
    """Sorted batch numbers as runs of consecutive ones."""
    out = []
    for b in ids:
        if out and b == out[-1][-1] + 1:
            out[-1].append(b)
        else:
            out.append([b])
    return out


def _span(job: dict, run: list) -> tuple[int, int]:
    cfg, w = job["cfg"], job["mix"]["writers"]
    step = cfg["log_interval_s"] * tsbs.NS
    return (int(tsbs.live_times(cfg, run[0], w["batch_rows"])[0]),
            int(tsbs.live_times(cfg, run[-1], w["batch_rows"])[-1]) + step)


def totals_sql(cfg: dict, lo: int, hi: int) -> str:
    aggs = ", ".join([f"count({f}) AS n_{f}" for f in cfg["fields"]]
                     + [f"sum({f}) AS s_{f}" for f in cfg["fields"]])
    return (f"SELECT hostname, {aggs} FROM {cfg['measurement']} "
            f"WHERE time >= {lo} AND time < {hi} GROUP BY hostname")


def rows_sql(cfg: dict, lo: int, hi: int) -> str:
    return (f"SELECT time, hostname, {', '.join(cfg['fields'])} FROM "
            f"{cfg['measurement']} WHERE time >= {lo} AND time < {hi}")


def acked(results: list) -> list:
    return sorted(r["batch"] for res in results
                  for r in res.get("writes", []) if r["ok"])


def after(job: dict, results: list, port: int) -> dict:
    """Read the acknowledged rows back over SQL: per host, each field's
    count and sum over every run of acknowledged batches, and every row
    of `readback_batches` of them drawn from the seed."""
    cfg, w = job["cfg"], job["mix"]["writers"]
    ids = acked(results)
    g = tsbs.rng(job["seed"], 5)
    sample = sorted(int(b) for b in g.choice(
        ids, min(w["readback_batches"], len(ids)), replace=False))
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    out = {"totals": [], "rows": []}
    for run in _runs(ids):
        status, body, _s = cq.send_query(conn, cfg, totals_sql(
            cfg, *_span(job, run)), False)
        out["totals"].append((run, status, body.decode()))
    for b in sample:
        status, body, _s = cq.send_query(conn, cfg, rows_sql(
            cfg, *_span(job, [b])), False)
        out["rows"].append((b, status, body.decode()))
    conn.close()
    return out


def _values(job: dict):
    """values_of(batch): a batch's values, each template made once."""
    cfg, w = job["cfg"], job["mix"]["writers"]
    made: dict = {}

    def values_of(b):
        j = b % w["templates"]
        if j not in made:
            made[j] = tsbs.live_values(cfg, job["seed"], j, w["batch_rows"])
        return made[j]

    return values_of


def judge(job: dict, results: list, post: dict, hist: np.ndarray) -> dict:
    cfg, w = job["cfg"], job["mix"]["writers"]
    numbers = cq.judge(job, results, post, hist)
    values_of = _values(job)
    nf = len(cfg["fields"])
    missing, gap_ = 0, 0.0
    for run, status, text in post["totals"]:
        want = reference.host_totals(cfg, values_of, run, w["batch_rows"])
        if status != 200:
            missing += int(want["count"].sum()) * nf
            continue
        c = check.parse_csv(text)
        h = check.host_index(c["hostname"])
        n = np.zeros((cfg["scale"], nf), dtype=np.int64)
        s = np.full((cfg["scale"], nf), np.nan)
        for i, f in enumerate(cfg["fields"]):
            n[h, i] = np.array(c[f"n_{f}"], dtype=np.int64)
            s[h, i] = np.array(c[f"s_{f}"], dtype=np.float64)
        missing += int(np.abs(n - want["count"][:, None]).sum())
        gap_ = max(gap_, check.gap(s.ravel(), want["sum"].ravel()))
    wrong = 0
    for b, status, text in post["rows"]:
        want = reference.batch_rows(cfg, values_of(b), tsbs.live_times(
            cfg, b, w["batch_rows"]))
        if status != 200:
            wrong += len(want["t"])
            continue
        got = check.answer_arrays(text, cfg["fields"], time_col="time")
        c = check.compare(got, want, cfg["fields"])
        wrong += c["keys_wrong"] + c["values_differ"]
    numbers.update({"rows_missing": missing, "sum_gap": gap_,
                    "rows_wrong": wrong})
    return numbers


def control(job: dict, results: list, post: dict,
            hist: np.ndarray) -> tuple[list, dict]:
    """(results, post) with the control's answers in the program's: the
    readers' answers, and the read-back totals and rows, from the
    float32 reference rendered as the node's CSV."""
    cfg, w = job["cfg"], job["mix"]["writers"]
    values_of = _values(job)
    hosts = check.host_names(cfg, range(cfg["scale"]))
    totals = []
    for run, status, _text in post["totals"]:
        low = reference.host_totals(cfg, values_of, run, w["batch_rows"],
                                    dtype=np.float32)
        cols = {"hostname": hosts}
        for i, f in enumerate(cfg["fields"]):
            cols[f"n_{f}"] = low["count"]
        for i, f in enumerate(cfg["fields"]):
            cols[f"s_{f}"] = low["sum"][:, i]
        totals.append((run, status, check.render_csv(cols)))
    rows = []
    for b, status, _text in post["rows"]:
        low = reference.batch_rows(cfg, values_of(b).astype(np.float32),
                                   tsbs.live_times(cfg, b, w["batch_rows"]))
        cols = {"time": low["t"], "hostname": check.host_names(cfg, low["host"])}
        cols.update({f: low[f] for f in cfg["fields"]})
        rows.append((b, status, check.render_csv(cols)))
    qs = [r for res in results for r in res.get("queries", [])]
    writes = [r for res in results for r in res.get("writes", [])]
    return ([{"queries": cq.control_answers(job, qs, hist), "writes": writes}],
            {"totals": totals, "rows": rows})
