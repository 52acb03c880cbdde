"""The program's own timeline, as the per-layer metrics of program spans
read it: the node runs in the harness's process, so its spans
(`cnosdb_tpu_torch.utils.stages.GLOBAL_COLLECTOR`, stamped on the
monotonic clock of the window) are read there after the window.

Readers take the spans that ended inside the window and overlapped no
slice the profiler recorded (as `harness.Run.quiet` takes requests);
`last_slice` is the exception. A batch is an `http:write` root span of
that set; a per-batch stage sums, over each batch's trace, the spans of
that name that no span of the same name encloses (a write's usage
counters write again inside it). Everything here returns None where the
program keeps no timeline (a tree before it had one) and where the ring
dropped spans of the window.
"""
from __future__ import annotations

import numpy as np

ROOTS = ("http:", "rpc:")                     # a request's root span
# spans that await on the event loop and leave it to other handlers: a
# request body's read, the turn to resume a handler after its worker
# (`write.body_ms`, `body_ms`, `write.resume_ms`, `resume_ms`)
AWAITS = ("body_ms", "resume_ms")
# waits, not work: those, the executor's queue, the admission gate, the
# vnode lock
WAITS = ("queue_ms", "admission_ms", "lock_wait_ms") + AWAITS


def _timeline():
    """(collector, the timeline clock's map onto the monotonic clock, the
    fields of a span) or None without a timeline."""
    try:
        from cnosdb_tpu_torch.utils import stages

        return stages.GLOBAL_COLLECTOR, stages.monotonic_s, stages.FIELDS
    except (ImportError, AttributeError):
        return None


def _since(lo: float, hi: float = float("inf")) -> list[dict] | None:
    """The spans that ended in [lo, hi] (monotonic s), as dicts whose
    `start` and `end` are monotonic s; None as the module says."""
    tl = _timeline()
    if tl is None:
        return None
    coll, to_s, fields = tl
    recs = coll.window(int(lo * 1e9),
                       int(hi * 1e9) if hi != float("inf") else 2**63)
    if recs is None:
        return None
    out = []
    for r in recs:
        d = dict(zip(fields, r))
        d["start"] = to_s(d["start_ns"])
        d["end"] = to_s(d["end_ns"])
        d["tags"] = d["tags"] or {}
        out.append(d)
    return out


def quiet(run) -> list[dict] | None:
    """The window's spans that overlapped no recorded slice."""
    spans = _since(run.t0, run.t1)
    if spans is None:
        return None
    return [s for s in spans if not any(s["start"] < e and s["end"] > b
                                        for b, e in run.profiled)]


def is_root(s: dict) -> bool:
    return s["name"].startswith(ROOTS)


def batches(run) -> tuple[list[dict], dict] | None:
    """The window's batches, and every span of their traces by trace id."""
    spans = quiet(run)
    if spans is None:
        return None
    roots = [s for s in spans if s["name"] == "http:write"]
    if not roots:
        return None
    traces = {r["trace_id"]: [] for r in roots}
    every = _since(min(r["start"] for r in roots), run.t1)
    if every is None:
        return None
    for s in every:
        if s["trace_id"] in traces:
            traces[s["trace_id"]].append(s)
    return roots, traces


def outermost(spans: list[dict], name: str) -> list[dict]:
    """The spans named `name` that no span of that name encloses."""
    by_id = {s["span_id"]: s for s in spans}
    out = []
    for s in spans:
        if s["name"] != name:
            continue
        p = by_id.get(s["parent_id"])
        while p is not None and p["name"] != name:
            p = by_id.get(p["parent_id"])
        if p is None:
            out.append(s)
    return out


def ms(s: dict) -> float:
    return (s["end_ns"] - s["start_ns"]) / 1e6


def per_batch(run, name: str) -> dict | None:
    """ms of stage `name` a batch, with the batch count and the batches'
    own mean and 95th percentile (root span, handler entry to response)."""
    got = batches(run)
    if got is None:
        return None
    roots, traces = got
    total = sum(ms(s) for spans in traces.values()
                for s in outermost(spans, name))
    own = [ms(r) for r in roots]
    return {"value": total / len(roots), "batches": len(roots),
            "root_ms": sum(own) / len(own),
            "root_p95_ms": float(np.percentile(own, 95))}


def union_s(intervals: list[tuple[float, float]]) -> float:
    """Seconds covered by the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def last_slice(run) -> tuple[float, float, list[dict]] | None:
    """The last recorded slice and every span that overlapped it."""
    if not run.profiled:
        return None
    lo, hi = run.profiled[-1]
    spans = _since(lo)
    if spans is None:
        return None
    return lo, hi, [s for s in spans if s["start"] < hi]
