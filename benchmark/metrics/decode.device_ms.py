"""ms a query in `device_decode_ms` of the query profile (X-CnosDB-Profile): the device decode lane, X3 + K2 (ops/device_decode.py)."""


def read(run):
    return run.stage_per_query("device_decode_ms")
