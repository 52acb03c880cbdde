"""Rows acknowledged per second of the window, over all writers: each
acknowledged batch counts its rows by the share of its time from first
send to ack that lay in the window (Run.in_window)."""


def read(run):
    if not run.writes:
        return None
    return sum(r["rows"] * run.in_window(r) for r in run.writes) / run.seconds
