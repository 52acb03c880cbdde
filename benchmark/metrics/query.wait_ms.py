"""ms a query waits: `queue_ms` (the HTTP executor's queue), plus
`admission_ms` (the admission gate), plus `lock_wait_ms` (its scans'
vnode-lock waits), from the query profile (X-CnosDB-Profile) of the
window's queries (Run.stage_per_query), each part beside the sum.

Beside them, per query, the rest of what its client waits for: the
body's read (`body_ms`) and the turn to resume the handler after its
worker (`resume_ms`), both awaited on the HTTP event loop, the rendering
there (`http.render_ms`), the query itself on the worker (`wall_ms`),
and the clients' own mean and 95th percentile of the same queries
(`client_ms`, `client_p95_ms`): what the parts leave of the clients'
mean is the time before the handler began and the response's send."""
import numpy as np

PARTS = ("queue_ms", "admission_ms", "lock_wait_ms")
BESIDE = ("body_ms", "resume_ms", "http.render_ms")


def read(run):
    recs = [r for r in run.quiet(run.queries) if r.get("profile")]
    if not any("queue_ms" in r["profile"]["stages"] for r in recs):
        return None   # a program whose profile has no waits
    parts = {k: run.stage_per_query(k) for k in PARTS + BESIDE}
    client = [(r["done"] - r["start"]) * 1e3 for r in recs]
    return {"value": sum(parts[k] for k in PARTS), "queries": len(recs),
            **parts,
            "wall_ms": sum(r["profile"].get("wall_ms") or 0.0
                           for r in recs) / len(recs),
            "client_ms": sum(client) / len(client),
            "client_p95_ms": float(np.percentile(client, 95))}
