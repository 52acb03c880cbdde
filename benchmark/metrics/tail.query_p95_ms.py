"""95th percentile of the latencies of every query answered in the
window, as its client saw them (send to full answer), with the count; in a
traced run, of those that overlapped no profiled slice (Run.quiet)."""
import numpy as np


def read(run):
    ms = [(r["done"] - r["start"]) * 1e3 for r in run.quiet(run.queries)]
    if not ms:
        return None
    return {"value": float(np.percentile(ms, 95)), "samples": len(ms)}
