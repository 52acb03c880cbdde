"""ms a batch in `write.queue_ms`, its wait in the HTTP executor's queue
from the hand-off to the first line on a worker (server/http.py): spans
of the program's timeline, over the window's batches. Beside it the
batch's `write.apply_ms` (Coordinator.write_points on the worker), so
that parse + queue + apply can be set against the root span, and the
two waits on the event loop that the root holds besides: the body's read
(`write.body_ms`) and the turn to resume the handler after the worker
(`write.resume_ms`)."""
from benchmark import timeline


def read(run):
    out = timeline.per_batch(run, "write.queue_ms")
    if out is None:
        return None
    for k in ("write.apply_ms", "write.body_ms", "write.resume_ms"):
        out[k.removeprefix("write.")] = timeline.per_batch(run, k)["value"]
    return out
