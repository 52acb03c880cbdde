"""Client processes of a run: spawned before the node's set-up, held
until the window opens, and each handing its records back at the end.

A client is a function `fn(index, job, shared) -> dict` in a traffic
module; it calls `wait_go(shared)` for the node's port and the window,
and returns its records, which the parent collects from one queue.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time
import traceback

GO_POLL_S = 1.0
PROBE_EVERY_S = 1.0


class Shared:
    """What the parent and its clients share: the node's port, the
    window on the monotonic clock (system-wide on Linux), the go and
    stop signals, a global batch counter and the results queue."""

    def __init__(self, ctx):
        self.port = ctx.Value("i", 0)
        self.t0 = ctx.Value("d", 0.0)
        self.t1 = ctx.Value("d", 0.0)
        self.go = ctx.Event()
        self.stop = ctx.Event()
        self.batch = ctx.Value("q", 0)
        self.results = ctx.Queue()


def wait_go(shared) -> tuple[int, float, float]:
    parent = os.getppid()
    while not shared.go.wait(GO_POLL_S):
        if shared.stop.is_set() or os.getppid() != parent:
            raise SystemExit(1)
    if shared.stop.is_set():
        raise SystemExit(1)
    return shared.port.value, shared.t0.value, shared.t1.value


def sleep_until(t: float) -> None:
    d = t - time.monotonic()
    if d > 0:
        time.sleep(d)


def probe_host(t0: float, t1: float, out: list) -> None:
    """Time a fixed piece of work (numpy's sort of 2**18 floats) once a
    second through the window, into `out`: how fast the shared host ran
    while the node served, read from a process that mostly waits."""
    import numpy as np

    x = np.random.default_rng(0).random(1 << 18)
    t = t0
    while t < t1:
        sleep_until(t)
        s = time.perf_counter()
        np.sort(x)
        out.append(time.perf_counter() - s)
        t += PROBE_EVERY_S


def next_batch(shared) -> int:
    with shared.batch.get_lock():
        b = shared.batch.value
        shared.batch.value = b + 1
    return b


def _io() -> dict:
    with open("/proc/self/io") as f:
        return {k: int(v) for k, v in (ln.split(": ") for ln in f)}


def _main(fn, index: int, job: dict, shared) -> None:
    try:
        out = fn(index, job, shared)
        out["io"] = _io()
        shared.results.put(("ok", index, out))
    except SystemExit:
        shared.results.put(("stopped", index, {}))
    except BaseException:
        shared.results.put(("error", index, traceback.format_exc()))
        raise


class Clients:
    """The run's client processes (spawned: no state inherited)."""

    def __init__(self, specs: list, job: dict):
        ctx = mp.get_context("spawn")
        self.shared = Shared(ctx)
        self.procs = [ctx.Process(target=_main, args=(fn, i, job, self.shared),
                                  name=f"bench-{fn.__name__}-{i}", daemon=True)
                      for fn, i in specs]
        for p in self.procs:
            p.start()

    def open_window(self, port: int, seconds: float, lead: float) -> tuple:
        s = self.shared
        s.port.value = port
        s.t0.value = time.monotonic() + lead
        s.t1.value = s.t0.value + seconds
        s.go.set()
        return s.t0.value, s.t1.value

    def collect(self, deadline: float) -> list:
        """Every client's records (drained before any join); raises if a
        client failed or the deadline passes."""
        out = []
        while len(out) < len(self.procs):
            try:
                status, i, rec = self.shared.results.get(
                    timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise RuntimeError(f"{len(self.procs) - len(out)} client(s) "
                                   f"gave no records by the deadline")
            if status != "ok":
                raise RuntimeError(f"client {i}: {status}: {rec}")
            out.append(rec)
        return out

    def stop(self) -> None:
        self.shared.stop.set()
        self.shared.go.set()
        for p in self.procs:
            p.join(10)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
