"""ms a query in `finalize_ms` of the query profile (X-CnosDB-Profile): finalizers and output rendering (sql/executor.py)."""


def read(run):
    return run.stage_per_query("finalize_ms")
