"""Per-node query admission gate.

The reference bounds concurrent query execution with its dispatcher's
`query_limit` semaphore (query_server dispatcher/manager.rs) on top of
the per-tenant request limiters. This is the rebuild's equivalent: a
bounded running-set plus a bounded FIFO-ish wait queue in front of the
SQL endpoint.

  * up to `max_concurrent` queries execute at once;
  * up to `max_queued` more wait, each for at most its own request
    deadline (a queued request that cannot finish in time is shed NOW,
    not after burning its whole budget in line);
  * everything beyond that is shed immediately with AdmissionRejected,
    which the HTTP layer maps to 503 + Retry-After — deliberately
    distinct from the per-tenant token-bucket LimiterError (429): 429
    means "you specifically are over YOUR budget", 503 means "the node
    is saturated for everyone, back off and retry".

Rejection taxonomy (each failure names its actor and its remedy):

  ====  ==========================  =================================
  code  error (counter)             meaning / client remedy
  ====  ==========================  =================================
  429   LimiterError                this tenant exceeded ITS bucket
        (rate_limited)              — slow down, others unaffected
  503   AdmissionRejected           node saturated for everyone —
        (shed)                      back off per Retry-After
  503   WriteBackpressure           memory broker shedding WRITES
        (backpressured)             while flushes drain; Retry-After
                                    derives from observed flush
                                    progress (server/memory.py)
  504   DeadlineExceeded            the request ran out of ITS OWN
        (deadline)                  time budget mid-flight
  413   MemoryExceeded              this query/write is too big for
        (memory)                    its byte budget — shrink it;
                                    retrying unchanged cannot help
  ====  ==========================  =================================

The memory broker's degradation ladder (server/memory.py) also sheds
QUEUED — never running — queries via `shed_queued()` when reclaiming
caches alone cannot get back under the soft watermark: a queued query
holds no partial state yet, so shedding it frees future memory at zero
wasted work.

Acquisition happens on a worker of the event loop's default executor,
which every HTTP request shares (min(32, CPUs + 4) threads), so waiting
here holds a worker and blocks no event loop. Counters and
queue-depth/wait gauges feed /metrics via `stats()`.
"""
from __future__ import annotations

import threading
import time

from ..errors import AdmissionRejected
from ..utils import deadline as deadline_mod
from ..utils import lockwatch


class AdmissionGate:
    def __init__(self, max_concurrent: int = 64, max_queued: int = 128):
        self.max_concurrent = max(1, int(max_concurrent))
        self.max_queued = max(0, int(max_queued))
        self._cond = threading.Condition(lockwatch.RLock("admission.gate"))
        self._running = 0
        self._queued = 0
        # memory-pressure shed generation: shed_queued() bumps the epoch
        # and every waiter queued BEFORE the bump sheds itself
        self._shed_epoch = 0
        self._shed_retry_after = 1.0
        # cumulative counters (cnosdb_requests_*_total)
        self.admitted_total = 0
        self.queued_total = 0
        self.shed_total = 0
        # wait-time accounting for the queue-wait gauge
        self._wait_sum_ms = 0.0
        self._wait_max_ms = 0.0

    def acquire(self, dl: deadline_mod.Deadline | None = None) -> float:
        """Block until admitted; returns seconds spent queued.

        Raises AdmissionRejected when the queue is full, or when the
        caller's deadline dies while waiting in line."""
        with self._cond:
            if self._running < self.max_concurrent and self._queued == 0:
                self._running += 1
                self.admitted_total += 1
                return 0.0
            if self._queued >= self.max_queued:
                self.shed_total += 1
                raise AdmissionRejected(
                    f"admission queue full "
                    f"({self._running} running, {self._queued} queued)",
                    retry_after=1.0)
            self._queued += 1
            self.queued_total += 1
            start = time.monotonic()
            epoch = self._shed_epoch
            try:
                while True:
                    if self._shed_epoch > epoch:
                        self.shed_total += 1
                        raise AdmissionRejected(
                            "shed while queued: node over memory "
                            "watermark (queued queries shed first, "
                            "running queries finish)",
                            retry_after=self._shed_retry_after)
                    if dl is not None and dl.dead():
                        self.shed_total += 1
                        raise AdmissionRejected(
                            "shed while queued: request deadline "
                            f"{'cancelled' if dl.cancelled else 'expired'} "
                            f"after {time.monotonic() - start:.2f}s in line",
                            retry_after=1.0)
                    if self._running < self.max_concurrent:
                        self._running += 1
                        self.admitted_total += 1
                        waited = time.monotonic() - start
                        self._wait_sum_ms += waited * 1000.0
                        self._wait_max_ms = max(self._wait_max_ms,
                                                waited * 1000.0)
                        return waited
                    rem = dl.remaining() if dl is not None else None
                    self._cond.wait(timeout=min(rem, 0.1)
                                    if rem is not None else 0.1)
            finally:
                self._queued -= 1

    def release(self) -> None:
        with self._cond:
            self._running -= 1
            self._cond.notify()

    def shed_queued(self, retry_after: float = 1.0) -> int:
        """Memory-broker ladder step 2: shed every currently QUEUED
        query with 503 + `retry_after` (the waiters raise on wakeup).
        Running queries are untouched. Returns how many were shed."""
        with self._cond:
            n = self._queued
            if n:
                self._shed_epoch += 1
                self._shed_retry_after = float(retry_after)
                self._cond.notify_all()
            return n

    def pressure(self) -> tuple[int, int]:
        """Dirty-read ``(running, queued)`` for the serving-plane micro-
        batcher's fuse-or-solo decision. Deliberately lock-free: it runs
        on every admitted point query, and a momentarily torn pair only
        mis-sizes one batching window — never correctness."""
        return self._running, self._queued

    def stats(self) -> dict:
        with self._cond:
            n_adm = self.admitted_total
            avg = self._wait_sum_ms / n_adm if n_adm else 0.0
            return {
                "running": self._running,
                "queued": self._queued,
                "admitted_total": n_adm,
                "queued_total": self.queued_total,
                "shed_total": self.shed_total,
                "queue_wait_ms_avg": avg,
                "queue_wait_ms_max": self._wait_max_ms,
            }
