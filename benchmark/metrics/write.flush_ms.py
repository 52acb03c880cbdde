"""Wall ms of the vnode flushes (`flush_ms` spans, storage/vnode.py
flush) that ended in the window and overlapped no slice, per batch of the
window, with the flushes' count, rows and the count of each trigger
(inline: a write filled its memory cache and waited for the flush;
reclaim: the memory broker; explicit)."""
from benchmark import timeline


def read(run):
    got = timeline.batches(run)
    spans = timeline.quiet(run)
    if got is None or spans is None:
        return None
    flushes = [s for s in spans if s["name"] == "flush_ms"]
    n = len(got[0])
    out = {"value": sum(timeline.ms(s) for s in flushes) / n, "batches": n,
           "flushes": len(flushes),
           "rows": sum(s["tags"].get("rows", 0) for s in flushes)}
    for s in flushes:
        k = f"trigger.{s['tags'].get('trigger', 'none')}"
        out[k] = out.get(k, 0) + 1
    return out
