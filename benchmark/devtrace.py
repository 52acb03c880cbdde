"""The device trace of a slice of the measured window, in the node's
process: torch.profiler over the card's activity alone (kernels, copies
and sets of the whole process, whichever thread launched them, and the
CUDA runtime calls; no CPU op is recorded), the
program's K1/K2 launch counters beside it, and the trace accepted only
when it kept every launch (yardstick.trace_complete and one kernel
event per counted K1 and K2 launch). A lost trace gives no number.

Recording (`record`) is all that happens inside the window; the trace
is exported and read (`summarise`) once the window has closed, so that
its parsing shares no time with the node. Host-clock metrics leave out
every request that overlapped a recorded slice (harness.Run.quiet).
"""
from __future__ import annotations

import json
import os
import time

from . import yardstick

K1_NAME = "segment_window"        # ops/csrc/segment_window.cu
K2_NAME = "xor_scan"              # ops/csrc/xor_scan.cu
TOP = 10
# a launch counted just outside the traced span, or traced just outside
# the counted one: the counters are read while the profiler runs, and a
# launch and its count are not one step
EDGE = 2
MARK = "benchmark.traced_slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
             "cuda_driver")


def launch_state() -> tuple[dict, dict]:
    """The program's launch counters: by op, and K2's shapes."""
    from cnosdb_tpu_torch.ops import device_decode as dd
    from cnosdb_tpu_torch.ops import kernels
    from cnosdb_tpu_torch.ops import pallas_kernels as pk

    return ({**kernels.x4_launches, "K1": pk.launches, "K2": dd.xor_launches},
            dict(dd.xor_launch_shapes))


def short_name(name: str) -> str:
    """A device op's name without its template and argument lists."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0),
              default=len(name))
    return name[:cut]


def _delta(a: dict, b: dict) -> dict:
    return {k: v - a.get(k, 0) for k, v in b.items() if v != a.get(k, 0)}


def _union(iv: list) -> list:
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _allocations() -> int:
    """The caching allocator's count of device allocations so far: it
    moves whenever the node makes a tensor on the card."""
    import torch

    return torch.cuda.memory_stats(0).get("allocation.all.allocated", 0)


class Slice:
    """One recorded slice: the profiler (not yet read), its span on the
    monotonic clock (start to the profiler's stop), the launches the
    program counted in it, and whether the card did anything there."""

    def __init__(self, prof, start, end, launched, k2_shapes, active):
        self.prof, self.start, self.end = prof, start, end
        self.launched, self.k2_shapes, self.active = (launched, k2_shapes,
                                                      active)


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def warm() -> None:
    """Start and stop the profiler once, in set-up, so that the window
    pays no first start."""
    prof = _profiler()
    prof.start()
    prof.stop()


def record(seconds: float) -> Slice:
    """Trace `seconds` of whatever the node's threads do on the card.
    Only the cheap reads of the program's counters happen here; the
    trace stays in the profiler until `summarise`."""
    import torch
    from torch.profiler import record_function

    start = time.monotonic()
    prof = _profiler()
    prof.start()
    with record_function(MARK):
        c0, k2s0, a0 = *launch_state(), _allocations()
        time.sleep(seconds)
        c1, k2s1, a1 = *launch_state(), _allocations()
        torch.cuda.synchronize()
    prof.stop()
    launched = _delta(c0, c1)
    return Slice(prof, start, time.monotonic(), launched, _delta(k2s0, k2s1),
                 bool(launched) or a1 != a0)


def summarise(sl: Slice, path: str) -> tuple[dict | None, str]:
    """Read a recorded slice through the trace file torch.profiler
    writes (`path`), which keeps every device activity of the process.
    Returns (summary, why): the summary is None where the trace lost
    launches."""
    sl.prof.export_chrome_trace(path)
    sl.prof = None
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    launched = sl.launched
    # the slice: its marker where CPU annotations were kept, else the
    # profiler's own session span
    mark = ([e for e in events if e.get("name") == MARK
             and e.get("cat") == "user_annotation"]
            or [e for e in events if e.get("cat") == "Trace"
                and e.get("ph") == "X"])
    if not mark:
        return None, "no slice marker or session span in the trace"
    lo = float(mark[0]["ts"])
    hi = lo + float(mark[0]["dur"])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        iv = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if e.get("cat") in DEVICE_CATS:
            dev.append((e["name"], *iv))
        elif e.get("cat") in HOST_CATS and e["name"] != MARK:
            host.append((e["name"], *iv))
    uploads = sum(1 for n, *_ in dev if n.startswith("Memcpy HtoD"))
    k1 = [(s, e) for n, s, e in dev if K1_NAME in n]
    k2 = [(s, e) for n, s, e in dev if K2_NAME in n]
    if not dev:
        cats = sorted({e.get("cat") for e in events if e.get("ph") == "X"},
                      key=str)
        return None, f"no device event (launches {launched}; kept {cats})"
    if not yardstick.trace_complete(uploads, launched):
        return None, f"{uploads} uploads for launches {launched}"
    if (abs(len(k1) - launched.get("K1", 0)) > EDGE
            or abs(len(k2) - launched.get("K2", 0)) > EDGE):
        return None, (f"kernel events K1 {len(k1)} K2 {len(k2)} against "
                      f"launches {launched}")
    busy = _union([(max(s, lo), min(e, hi)) for _n, s, e in dev
                   if e > lo and s < hi])
    busy_us = sum(e - s for s, e in busy)
    by_name: dict = {}
    for n, s, e in dev:
        k = short_name(n)
        by_name[k] = by_name.get(k, 0.0) + (e - s) / 1e6
    edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]
    idle = []
    for length, start in gaps:
        mid = start + length / 2
        cover = [(e - s, n) for n, s, e in host if s <= mid <= e]
        idle.append([min(cover)[1] if cover else "no host op recorded",
                     length / 1e6])
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy_us / 1e6,
        "launched": launched,
        "k2": {"events": len(k2), "launches": launched.get("K2", 0),
               "seconds": sum(e - s for s, e in k2) / 1e6,
               "shapes": sl.k2_shapes},
        "device_ops": sorted(([n, s] for n, s in by_name.items()),
                             key=lambda x: -x[1])[:TOP],
        "idle_gaps": idle,
    }, "complete"
