"""ms a batch in `write.parse_ms`, the line-protocol parse on the HTTP
event loop (server/http.py handle_write): spans of the program's
timeline, over the window's batches (benchmark/timeline.py)."""
from benchmark import timeline


def read(run):
    return timeline.per_batch(run, "write.parse_ms")
