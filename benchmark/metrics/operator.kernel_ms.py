"""ms a query in `kernel_ms` of the query profile (X-CnosDB-Profile): the segment-aggregate operators, X2 / K1 (ops/tpu_exec.py)."""


def read(run):
    return run.stage_per_query("kernel_ms")
