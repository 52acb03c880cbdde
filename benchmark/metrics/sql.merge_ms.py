"""ms a query in `merge_ms` of the query profile (X-CnosDB-Profile): cross-vnode partial merge (sql/executor.py)."""


def read(run):
    return run.stage_per_query("merge_ms")
