"""Queries answered per second of the window, over all clients: each
query counts by the share of its service time (send to answer) that lay
in the window, so that the queries in flight at its edges count for the
work done there (Run.in_window)."""


def read(run):
    return sum(run.in_window(r) for r in run.queries) / run.seconds
