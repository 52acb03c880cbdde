"""Gray-failure tolerance plane: per-node health scoring + hedging state.

The circuit breaker (parallel/coordinator.py) is binary — a node is
either answering connections or it is not — so a *brownout* node (GC
pause, disk stall, overloaded neighbor, lossy NIC) that still accepts
TCP keeps receiving scans and drags every query's tail toward the
deadline. This module is the continuous complement: a process-global
:class:`HealthScorer` fed from every ``rpc_call`` completion in
``net.py`` keeps a decayed latency EWMA plus a bounded quantile sketch
per (peer address, method class), tracks error-rate and deadline-burn
EWMAs, and classifies each node HEALTHY / DEGRADED / BROKEN:

  * HEALTHY  — errors rare, latency within the class's own baseline
  * DEGRADED — answering, but slow (burn or latency outliers) or with an
               elevated error rate: used only when no healthy replica
               holds the vnode, and hedged aggressively
  * BROKEN   — error rate so high the node is effectively down; the
               binary breaker usually agrees and fast-fails it

Consumers (coordinator read path):

  * ``rank()`` orders failover candidates by health — power-of-two-
    choices among HEALTHY replicas (seeded, so a test seed reproduces a
    routing decision), DEGRADED after, BROKEN last;
  * ``hedge_delay()`` returns the adaptive per-class hedge trigger (the
    class p95, floored by config) for `_scan_remote`'s hedged requests;
  * :class:`HedgeLimiter` caps concurrent hedges per coordinator so
    hedging can't storm an already-sick cluster;
  * ``SLOW_START`` ramps a freshly-closed breaker's admitted fraction
    instead of readmitting full blast.

Scope: hedging and health-ranked routing apply ONLY to the read-only
method classes in ``HEDGEABLE`` (scans and quorum probes). Replicated
writes stay raft-ordered — duplicating a write RPC would double-apply
or force dedup machinery the raft log already provides — so the write
path never consults this module for routing.

Everything here is observational bookkeeping: losing a sample or a
counter increment can skew a score, never corrupt a query, so the lock
is a plain leaf mutex and the hot path is O(1) appends.
"""
from __future__ import annotations

import os
import random
import threading
import time

from ..utils import lockwatch

# --------------------------------------------------------------- states
HEALTHY = "healthy"
DEGRADED = "degraded"
BROKEN = "broken"

# read-only RPC methods eligible for hedging / health-ranked routing;
# everything else (raft_msg, write_replica, vnode_install, ...) is
# either replicated-write-ordered or destructive and MUST keep the
# deterministic single-target path
HEDGEABLE = frozenset({
    "scan_vnode", "vnode_token", "vnode_checksum", "matview_partials",
    "tag_values", "series_keys", "replica_progress", "ping", "status",
})

# method → class: scores pool per class so one chatty method (raft
# heartbeats) can't mask a scan-lane brownout
_METHOD_CLASS = {
    "scan_vnode": "scan", "tag_values": "scan", "series_keys": "scan",
    "matview_partials": "scan",
    "vnode_token": "probe", "vnode_checksum": "probe",
    "replica_progress": "probe", "ping": "probe", "status": "probe",
    "write_vnode": "write", "write_replica": "write", "raft_msg": "write",
}

# outcome classes for observe(); "deadline" means OUR budget ran out
# mid-call — evidence of slowness, not of the peer being down
OK = "ok"
UNREACHABLE = "unreachable"
REJECTED = "rejected"
DEADLINE = "deadline"

_SKETCH_CAP = 128          # per-(addr, class) latency ring
_EWMA_ALPHA = 0.2          # latency smoothing
_RATE_ALPHA = 0.1          # error / burn rate smoothing
_DEGRADED_BURN = 0.5       # burn EWMA above this ⇒ DEGRADED
_DEGRADED_ERR = 0.1        # error-rate EWMA above this ⇒ DEGRADED
_BROKEN_ERR = 0.5          # error-rate EWMA above this ⇒ BROKEN
_DECAY_HALF_LIFE = 30.0    # idle seconds for a node's rates to halve


# Hedge knobs ([query] hedge_delay_ms_floor / hedge_max_inflight, env
# CNOSDB_QUERY_* overridable so harness subprocesses inherit them even
# without a config file; configure() applies a loaded QueryConfig)
HEDGE_DELAY_FLOOR_MS = float(os.environ.get(
    "CNOSDB_QUERY_HEDGE_DELAY_MS_FLOOR", "25"))
HEDGE_MAX_INFLIGHT = int(os.environ.get(
    "CNOSDB_QUERY_HEDGE_MAX_INFLIGHT", "8"))


def configure(query_cfg) -> None:
    """Apply [query] hedge knobs (called from server wiring)."""
    global HEDGE_DELAY_FLOOR_MS, HEDGE_MAX_INFLIGHT
    f = getattr(query_cfg, "hedge_delay_ms_floor", None)
    if f is not None:
        HEDGE_DELAY_FLOOR_MS = float(f)
    m = getattr(query_cfg, "hedge_max_inflight", None)
    if m:
        HEDGE_MAX_INFLIGHT = max(1, int(m))


def method_class(method: str) -> str:
    return _METHOD_CLASS.get(method, "admin")


def enabled() -> bool:
    """Master gate: CNOSDB_HEDGE=0 restores byte-identical legacy
    routing (fixed-order failover, no health ranking, no hedges).
    Read per call — harness processes flip it via env."""
    return os.environ.get("CNOSDB_HEDGE", "1") != "0"


class _ClassStats:
    """Latency EWMA + bounded sample ring for one (addr, class) cell."""

    __slots__ = ("ewma_s", "ring", "pos", "n")

    def __init__(self):
        self.ewma_s = 0.0
        self.ring: list[float] = []
        self.pos = 0
        self.n = 0

    def add(self, elapsed_s: float) -> None:
        # cold-start warm-up: the first few samples dominate (alpha
        # 1/(n+1)), so one cold-path outlier can't anchor a
        # rarely-sampled node's baseline for dozens of observations
        alpha = max(_EWMA_ALPHA, 1.0 / (self.n + 1))
        self.ewma_s = elapsed_s if self.n == 0 else (
            alpha * elapsed_s + (1 - alpha) * self.ewma_s)
        if len(self.ring) < _SKETCH_CAP:
            self.ring.append(elapsed_s)
        else:
            self.ring[self.pos] = elapsed_s
            self.pos = (self.pos + 1) % _SKETCH_CAP
        self.n += 1

    def quantile(self, q: float) -> float | None:
        if not self.ring:
            return None
        s = sorted(self.ring)
        return s[min(len(s) - 1, int(q * len(s)))]


class _NodeHealth:
    """All tracked signal for one peer address."""

    __slots__ = ("classes", "err_rate", "burn_rate", "last_seen")

    def __init__(self):
        self.classes: dict[str, _ClassStats] = {}
        self.err_rate = 0.0      # EWMA of {0,1} per completion
        self.burn_rate = 0.0     # EWMA of deadline-budget burn fraction
        self.last_seen = time.monotonic()

    def _decay(self, now: float) -> None:
        # idle decay: a node nobody talks to drifts back toward healthy
        # so a transient storm doesn't blacklist it forever — latency
        # EWMAs decay too (a routed-around node gets no fresh samples,
        # so forgetting is the only way its remembered slowness can
        # clear; one rescue re-marks it if it is in fact still slow)
        dt = now - self.last_seen
        if dt > 1.0:
            f = 0.5 ** (dt / _DECAY_HALF_LIFE)
            self.err_rate *= f
            self.burn_rate *= f
            for cs in self.classes.values():
                cs.ewma_s *= f
        self.last_seen = now

    def state(self) -> str:
        if self.err_rate >= _BROKEN_ERR:
            return BROKEN
        if self.err_rate >= _DEGRADED_ERR or self.burn_rate >= _DEGRADED_BURN:
            return DEGRADED
        return HEALTHY

    def score(self) -> float:
        """Lower is better: error weight dominates, then burn, then
        scan-class latency (the lane hedging cares about)."""
        lat = 0.0
        cs = self.classes.get("scan")
        if cs is not None:
            lat = cs.ewma_s
        return self.err_rate * 10.0 + self.burn_rate * 2.0 + lat


class HealthScorer:
    """Process-global gray-failure signal store (one per process, like
    deadline.CANCELS): RPC completions flow in, routing decisions and
    /debug/health flow out."""

    def __init__(self, seed: int | None = None):
        self._lock = lockwatch.Lock("health.scorer")
        self._nodes: dict[str, _NodeHealth] = {}
        # seeded: the p2c tiebreak is reproducible under a test seed
        self._rng = random.Random(seed if seed is not None else 0xC05)

    # ----------------------------------------------------------- ingest
    def observe(self, addr: str, method: str, elapsed_s: float,
                outcome: str, burn: float | None = None) -> None:
        """One RPC completion. `burn` = elapsed / effective-timeout for
        deadline-carrying calls (1.0 ⇒ the call ate its whole budget);
        None when the call ran without a deadline."""
        mclass = method_class(method)
        now = time.monotonic()
        with self._lock:
            nh = self._nodes.get(addr)
            if nh is None:
                nh = self._nodes[addr] = _NodeHealth()
            nh._decay(now)
            err = 1.0 if outcome == UNREACHABLE else 0.0
            nh.err_rate = _RATE_ALPHA * err + (1 - _RATE_ALPHA) * nh.err_rate
            if outcome in (OK, REJECTED):
                cs = nh.classes.get(mclass)
                if cs is None:
                    cs = nh.classes[mclass] = _ClassStats()
                cs.add(elapsed_s)
            if burn is not None:
                b = min(1.0, max(0.0, burn))
                if outcome == DEADLINE:
                    b = 1.0   # the peer ate the entire remaining budget
                nh.burn_rate = _RATE_ALPHA * b \
                    + (1 - _RATE_ALPHA) * nh.burn_rate

    def observe_censored(self, addr: str, mclass: str,
                         elapsed_s: float) -> None:
        """A *lower bound* on an in-flight call's latency — booked the
        moment a hedge wins against it, so routing sees the loser's
        slowness immediately instead of after the slow reply finally
        lands (back-to-back scans would otherwise keep picking the
        straggler for a full brownout-latency window). Weighted heavily
        (alpha ≥ 0.5): losing a hedge race is strong evidence, and one
        loss should push the node out of the near-tie band that lets
        exploration keep probing it. Feeds the ranking EWMA only — a
        censored sample in the quantile ring would bias the hedge
        trigger's p95 downward."""
        with self._lock:
            nh = self._nodes.get(addr)
            if nh is None:
                nh = self._nodes[addr] = _NodeHealth()
            nh._decay(time.monotonic())
            cs = nh.classes.get(mclass)
            if cs is None:
                cs = nh.classes[mclass] = _ClassStats()
            if elapsed_s > cs.ewma_s:
                alpha = max(0.5, 1.0 / (cs.n + 1))
                cs.ewma_s = elapsed_s if cs.n == 0 else (
                    alpha * elapsed_s + (1 - alpha) * cs.ewma_s)
                cs.n += 1

    # ---------------------------------------------------------- queries
    def state(self, addr: str) -> str:
        with self._lock:
            nh = self._nodes.get(addr)
            if nh is None:
                return HEALTHY   # never seen ⇒ no evidence against it
            nh._decay(time.monotonic())
            return nh.state()

    def score(self, addr: str) -> float:
        with self._lock:
            nh = self._nodes.get(addr)
            if nh is None:
                return 0.0
            nh._decay(time.monotonic())
            return nh.score()

    # trigger cap relative to the median: with few ring samples p95 ==
    # max, so one multi-second cold/startup outlier would push the
    # trigger above any realistic brownout and silently disable hedging
    TRIGGER_P50_MULT = 4.0

    def hedge_delay(self, addr: str, mclass: str = "scan",
                    floor_s: float = 0.01) -> float:
        """Adaptive hedge trigger: the (addr, class) p95 — "this call is
        already slower than 95% of its peers" — capped at
        TRIGGER_P50_MULT × the median (outlier robustness) and floored
        so a microsecond p95 on a warm cache can't fire hedges for
        every call."""
        with self._lock:
            nh = self._nodes.get(addr)
            cs = nh.classes.get(mclass) if nh is not None else None
            p95 = cs.quantile(0.95) if cs is not None else None
            p50 = cs.quantile(0.5) if cs is not None else None
        if p95 is None:
            return floor_s
        if p50 is not None:
            p95 = min(p95, self.TRIGGER_P50_MULT * p50)
        return max(floor_s, p95)

    def rank(self, candidates: list, addr_of) -> list:
        """Order failover candidates by health: HEALTHY first (power-of-
        two-choices among them — sampled pairs compared by score, so a
        stale score self-corrects instead of starving a replica),
        DEGRADED next by score, BROKEN last. `addr_of(candidate)` maps a
        candidate to its peer address (None ⇒ local, always first)."""
        local, tiers = [], {HEALTHY: [], DEGRADED: [], BROKEN: []}
        for c in candidates:
            addr = addr_of(c)
            if addr is None:
                local.append(c)
                continue
            tiers[self.state(addr)].append((self.score(addr), addr, c))
        healthy = [t[2] for t in self._p2c(tiers[HEALTHY])]
        degraded = [t[2] for t in sorted(tiers[DEGRADED],
                                         key=lambda t: t[0])]
        broken = [t[2] for t in sorted(tiers[BROKEN], key=lambda t: t[0])]
        return local + healthy + degraded + broken

    # probability a sampled NEAR-TIE pair emits the other candidate:
    # with few replicas p2c alone degenerates to deterministic
    # best-first, and a node whose last sample was a cold-path outlier
    # would never be re-probed. Exploration is restricted to near-ties
    # (both candidates good) so it costs ~nothing; a clearly-bad node is
    # NOT explored on the critical path — its score recovers through
    # idle decay instead, and one hedge-rescued probe re-marks it.
    EXPLORE = 0.05
    EXPLORE_TIE = 2.0      # "near-tie": worse ≤ TIE × better + 5 ms

    def _p2c(self, tier: list) -> list:
        """Power-of-two-choices ordering: repeatedly sample two
        remaining candidates, emit the better-scored one (the other for
        EXPLORE of near-tie pairs, so a stale score self-corrects
        instead of starving a replica). Degenerates to identity for 0/1
        candidates."""
        out, pool = [], list(tier)
        with self._lock:
            while len(pool) > 1:
                i = self._rng.randrange(len(pool))
                j = self._rng.randrange(len(pool) - 1)
                if j >= i:
                    j += 1
                pick = i if pool[i][0] <= pool[j][0] else j
                near_tie = max(pool[i][0], pool[j][0]) <= (
                    self.EXPLORE_TIE * min(pool[i][0], pool[j][0]) + 0.005)
                if near_tie and self._rng.random() < self.EXPLORE:
                    pick = j if pick == i else i
                out.append(pool.pop(pick))
        out.extend(pool)
        return out

    def snapshot(self) -> dict:
        """/debug/health wire shape: per-node state/score/rates plus
        per-class latency ewma + p50/p95 (ms)."""
        now = time.monotonic()
        with self._lock:
            out = {}
            for addr, nh in self._nodes.items():
                nh._decay(now)
                classes = {}
                for mclass, cs in nh.classes.items():
                    classes[mclass] = {
                        "ewma_ms": round(cs.ewma_s * 1e3, 3),
                        "p50_ms": round((cs.quantile(0.5) or 0.0) * 1e3, 3),
                        "p95_ms": round((cs.quantile(0.95) or 0.0) * 1e3, 3),
                        "samples": cs.n,
                    }
                out[addr] = {"state": nh.state(),
                             "score": round(nh.score(), 4),
                             "err_rate": round(nh.err_rate, 4),
                             "burn_rate": round(nh.burn_rate, 4),
                             "classes": classes}
            return out

    def reset(self) -> None:
        """Test isolation."""
        with self._lock:
            self._nodes.clear()
            self._rng = random.Random(0xC05)


class HedgeLimiter:
    """Per-coordinator in-flight hedge cap: hedges add load precisely
    when the cluster is slow, so an unbounded hedger turns one brownout
    into a self-inflicted storm. Non-blocking acquire — a denied hedge
    is a *suppressed* hedge (booked by the caller), never a wait."""

    def __init__(self, max_inflight: int = 8):
        self.max_inflight = max(1, int(max_inflight))
        self._lock = lockwatch.Lock("health.hedge_limiter")
        self._inflight = 0

    def try_acquire(self, limit: int | None = None) -> bool:
        lim = self.max_inflight if limit is None else max(1, int(limit))
        with self._lock:
            if self._inflight >= lim:
                return False
            self._inflight += 1
            return True

    def release(self) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)

    def inflight(self) -> int:
        with self._lock:
            return self._inflight


class SlowStart:
    """Half-open → closed breaker ramp: a node that just proved itself
    with one probe readmits traffic at a ramped fraction over RAMP_S
    seconds instead of full blast (full traffic on a barely-recovered
    node is how half-open breakers flap). Deterministic admission — a
    call is admitted when admitted_so_far ≤ total_so_far × fraction —
    so tests don't need to mock randomness."""

    RAMP_S = float(os.environ.get("CNOSDB_CB_RAMP_S", "5.0"))
    RAMP_MIN = 0.25   # fraction admitted the instant the breaker closes

    def __init__(self):
        self._lock = lockwatch.Lock("health.slow_start")
        # node_id → [ramp_started_at, admitted, total]
        self._ramps: dict = {}

    def begin(self, node_id) -> None:
        with self._lock:
            self._ramps[node_id] = [time.monotonic(), 0, 0]

    def clear(self, node_id) -> None:
        with self._lock:
            self._ramps.pop(node_id, None)

    def reset(self) -> None:
        """Test isolation."""
        with self._lock:
            self._ramps.clear()

    def admit(self, node_id) -> bool:
        """True ⇒ send the call; False ⇒ caller should treat the node
        as still-cooling (fast-fail to an alternate)."""
        with self._lock:
            st = self._ramps.get(node_id)
            if st is None:
                return True
            started, admitted, total = st
            frac = self.RAMP_MIN + (1.0 - self.RAMP_MIN) * min(
                1.0, (time.monotonic() - started) / max(1e-9, self.RAMP_S))
            if frac >= 1.0:
                del self._ramps[node_id]
                return True
            st[2] = total + 1
            if admitted <= total * frac:
                st[1] = admitted + 1
                return True
            return False

    def ramping(self) -> dict:
        with self._lock:
            return {n: {"admitted": st[1], "total": st[2]}
                    for n, st in self._ramps.items()}


# --------------------------------------------------- plane-wide counters
_ctr_lock = lockwatch.Lock("health.counters")
_counters: dict[tuple, int] = {}


def count_hedge(outcome: str, reason: str = "", n: int = 1) -> None:
    """Hedge-lane accounting (`cnosdb_hedge_total{outcome,reason}`):
    fired / won / lost / cancelled / suppressed(reason). Every early
    exit out of the hedge lane must book one of these — enforced by the
    hedge-accounting lint rule."""
    with _ctr_lock:
        k = (outcome, reason)
        _counters[k] = _counters.get(k, 0) + n


def count_breaker(node, state: str, n: int = 1) -> None:
    """Breaker state-transition accounting
    (`cnosdb_breaker_total{node,state}`): open / half_open / closed."""
    with _ctr_lock:
        k = ("breaker", str(node), state)
        _counters[k] = _counters.get(k, 0) + n


def count_leader_read(outcome: str, n: int = 1) -> None:
    """Leader-read accounting: a read of a replicated group goes to the
    group's raft leader (Coordinator._leader_scan). `read` (one such
    scan), `redirect` (a member that does not lead named the leader, and
    the scan went there), `no_leader` (no leader was named: the scan
    asked another member, or backed off and asked again)."""
    with _ctr_lock:
        k = ("leader_read", outcome, "")
        _counters[k] = _counters.get(k, 0) + n


def leader_read_counters() -> dict:
    """→ {outcome: n} of count_leader_read."""
    with _ctr_lock:
        return {k[1]: v for k, v in _counters.items()
                if len(k) == 3 and k[0] == "leader_read"}


def count_read_index(outcome: str, n: int = 1) -> None:
    """Read-index accounting (raft.RaftNode.read_index, every read of a
    replicated set served as its leader): `confirmed` (a read the leader
    confirmed and applied), `not_leader` (a read refused: the member does
    not lead, or could not confirm it), `apply_waits` (a confirmed read
    that waited for its term's entry to commit or for the index to
    apply), `rounds` (append broadcasts a read asked for; the reads that
    share one count it once), `wait_us` (microseconds spent in the read
    index, confirmed or refused)."""
    with _ctr_lock:
        k = ("read_index", outcome, "")
        _counters[k] = _counters.get(k, 0) + n


def read_index_counters() -> dict:
    """→ {outcome: n} of count_read_index."""
    with _ctr_lock:
        return {k[1]: v for k, v in _counters.items()
                if len(k) == 3 and k[0] == "read_index"}


def counters_snapshot() -> tuple[dict, dict]:
    """→ (hedge counters {(outcome, reason): n},
          breaker counters {(node, state): n})."""
    with _ctr_lock:
        hedge = {k: v for k, v in _counters.items() if len(k) == 2}
        breaker = {(k[1], k[2]): v for k, v in _counters.items()
                   if len(k) == 3 and k[0] == "breaker"}
        return hedge, breaker


def reset_counters() -> None:
    """Test / bench isolation."""
    with _ctr_lock:
        _counters.clear()


SCORER = HealthScorer()
SLOW_START = SlowStart()
