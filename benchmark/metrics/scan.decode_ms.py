"""ms a query in `decode_ms` of the query profile (X-CnosDB-Profile): TSM read and decode, summed over the decode threads (parallel/coordinator.py, storage/)."""


def read(run):
    return run.stage_per_query("decode_ms")
