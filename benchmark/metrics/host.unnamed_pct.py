"""Share of the last traced slice in which no work span of the program
was open on any of the node's threads: work spans are all but a
request's root span and the waits (`*queue_ms`, `*admission_ms`,
`*lock_wait_ms`). The device idles most of that slice, so this is the
share of its idle time that the program cannot name. Beside it, the
spans recorded a second in the slice and the ring's dropped count."""
from benchmark import timeline


def read(run):
    got = timeline.last_slice(run)
    if got is None:
        return None
    lo, hi, spans = got
    work = [(max(s["start"], lo), min(s["end"], hi)) for s in spans
            if not timeline.is_root(s)
            and not s["name"].endswith(timeline.WAITS)]
    from cnosdb_tpu_torch.utils import stages

    return {"value": 100.0 * (1.0 - timeline.union_s(work) / (hi - lo)),
            "spans_per_s": len(spans) / (hi - lo),
            "dropped": stages.GLOBAL_COLLECTOR.dropped}
