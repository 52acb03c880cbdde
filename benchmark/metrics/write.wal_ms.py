"""ms a batch in `write.wal_ms`, the vnodes' WAL records: encode, append,
sync when asked (storage/vnode.py write): spans of the program's
timeline, over the window's batches."""
from benchmark import timeline


def read(run):
    return timeline.per_batch(run, "write.wal_ms")
