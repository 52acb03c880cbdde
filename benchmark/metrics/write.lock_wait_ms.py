"""ms a batch in `write.lock_wait_ms`, the vnodes' lock waits of its
writes (storage/vnode.py write), and beside it the same split by the tag
`holder`, the work that held the lock last before it was handed to the
write (VnodeStorage.locked): `write`, `scan`, `flush_ms`, `compact_ms`,
`none` (no named hold yet), or `free` (the lock was free, and the wait,
if any, was for the interpreter lock)."""
from benchmark import timeline


def read(run):
    got = timeline.batches(run)
    if got is None:
        return None
    roots, traces = got
    total, by_holder = 0.0, {}
    for spans in traces.values():
        for s in timeline.outermost(spans, "write.lock_wait_ms"):
            h = s["tags"].get("holder", "free")
            by_holder[h] = by_holder.get(h, 0.0) + timeline.ms(s)
            total += timeline.ms(s)
    n = len(roots)
    return {"value": total / n, "batches": n,
            **{f"holder.{h}": v / n for h, v in sorted(by_holder.items())}}
