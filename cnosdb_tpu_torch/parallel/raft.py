"""Raft consensus: replication for vnode replica sets and the meta group.

Role-parity with the reference's replication crate (replication/src/:
openraft 0.9 TypeConfig with D=R=Vec<u8> lib.rs:56-66, ApplyStorage trait
:103-112, EntryStorage :114-139, RaftNode raft_node.rs:24, MultiRaft
multi_raft.rs:27) rebuilt from scratch: leader election with randomized
timeouts, log replication with consistency check + conflict truncation,
commit on majority, snapshot install for lagging followers, and a
pluggable transport (in-process for single-host replica sets and tests;
an HTTP transport rides the same messages between nodes).

The log store IS the vnode WAL (storage/wal.py) — same single durable log
per vnode as the reference (wal_store.rs RaftEntryStorage).

Simplifications vs openraft, stated plainly:
- PreVote IS implemented (`_prevote()` below) — a candidate first polls a
  majority without bumping terms, so partitioned nodes cannot depose a
  healthy leader on rejoin;
- reads are linearizable through `RaftNode.read_index` (the raft
  thesis's read index, openraft's ensure_linearizable): the leader
  confirms that it still leads with an append round a majority answers,
  and serves once it has applied the commit index it read. There are no
  leases and no clock assumptions: a leader cut off from its peers keeps
  its role until it hears a higher term, and fails the round. A follower
  serves through the follower read index (the thesis's §6.4 too): it
  asks its leader for that index over raft and serves once it has
  applied it;
- membership changes are single-step (add/remove one voter at a time).
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

import msgpack

from ..utils import stages
from ..errors import ReplicationError
from ..utils import lockwatch


class Role:
    FOLLOWER = "follower"
    CANDIDATE = "candidate"
    LEADER = "leader"


@dataclass
class LogEntry:
    term: int
    index: int
    entry_type: int     # WalEntryType value (RAFT_BLANK for no-ops)
    data: bytes


class StateMachine:
    """ApplyStorage counterpart (replication/src/lib.rs:103-112)."""

    def apply(self, entry: LogEntry) -> None:
        raise NotImplementedError

    def snapshot(self) -> bytes:
        raise NotImplementedError

    def install_snapshot(self, data: bytes, last_index: int, last_term: int) -> None:
        raise NotImplementedError


class LogStore:
    """EntryStorage counterpart (replication/src/lib.rs:114-139)."""

    def append(self, entry: LogEntry) -> None:
        raise NotImplementedError

    def entries_from(self, index: int, limit: int = 512) -> list[LogEntry]:
        raise NotImplementedError

    def entry_at(self, index: int) -> LogEntry | None:
        raise NotImplementedError

    def purge_record_floor(self) -> int:
        """Highest index whose purged-entry term record was evicted (0 =
        none): outcomes at or below it are unknowable, not superseded."""
        return 0

    def purged_term(self, index: int) -> int | None:
        """Remembered term of an applied-then-purged entry, None if not
        recorded. Purge only ever runs below the applied index, and
        applied ⇒ committed, so a remembered term is as authoritative in
        an AppendEntries prev-term check as the entry itself."""
        return None

    def last_index(self) -> int:
        raise NotImplementedError

    def term_at(self, index: int) -> int:
        raise NotImplementedError

    def truncate_from(self, index: int) -> None:
        raise NotImplementedError

    def save_hard_state(self, term: int, voted_for: int | None) -> None:
        raise NotImplementedError

    def load_hard_state(self) -> tuple[int, int | None]:
        raise NotImplementedError


class MemoryLogStore(LogStore):
    """Volatile store for tests and the meta group's cache."""

    def __init__(self):
        self.entries: dict[int, LogEntry] = {}
        self._last = 0
        self._term = 0
        self._voted: int | None = None

    def append(self, entry: LogEntry):
        self.entries[entry.index] = entry
        self._last = max(self._last, entry.index)

    def entries_from(self, index, limit=512):
        out = []
        i = index
        while i <= self._last and len(out) < limit:
            e = self.entries.get(i)
            if e is None:
                break
            out.append(e)
            i += 1
        return out

    def entry_at(self, index):
        return self.entries.get(index)

    def last_index(self):
        return self._last

    def term_at(self, index):
        e = self.entries.get(index)
        return e.term if e else 0

    def truncate_from(self, index):
        for i in list(self.entries):
            if i >= index:
                del self.entries[i]
        self._last = min(self._last, index - 1)

    def save_hard_state(self, term, voted_for):
        self._term, self._voted = term, voted_for

    def load_hard_state(self):
        return self._term, self._voted


class WalLogStore(LogStore):
    """Raft log over the vnode WAL (reference wal_store.rs RaftEntryStorage).

    Entry encoding inside the WAL record: [term u64][payload]; the WAL's
    own seq is the raft index. Hard state rides in a sidecar record file.
    """

    def __init__(self, wal, hard_state_path: str):
        import os

        self.wal = wal
        self._hs_path = hard_state_path
        self._purged_terms_evicted_to = 0
        self._entries: dict[int, LogEntry] = {}
        for we in wal.replay():
            self._entries[we.seq] = LogEntry(we.term, we.seq, we.entry_type,
                                             we.data)
        self._last = max(self._entries) if self._entries else 0
        # stay in sync with WAL GC (vnode flush purges behind the flushed
        # watermark): drop mirrored entries so memory stays bounded and
        # entries_from honestly reports the purge (snapshot path engages)
        wal.purge_listeners.append(self._on_purge)
        self._term = 0
        self._voted = None
        if os.path.exists(self._hs_path):
            with open(self._hs_path, "rb") as f:
                raw = f.read()
            if len(raw) >= 16:
                self._term = int.from_bytes(raw[:8], "little")
                v = int.from_bytes(raw[8:16], "little")
                self._voted = None if v == 2**64 - 1 else v

    def append(self, entry: LogEntry):
        self.wal.append(entry.entry_type, entry.data, seq=entry.index,
                        term=entry.term)
        self._entries[entry.index] = entry
        self._last = max(self._last, entry.index)

    def entries_from(self, index, limit=512):
        out = []
        i = index
        while i <= self._last and len(out) < limit:
            e = self._entries.get(i)
            if e is None:
                break
            out.append(e)
            i += 1
        return out

    def entry_at(self, index):
        return self._entries.get(index)

    def first_index(self) -> int:
        """Index of the oldest entry held (0 when none)."""
        return min(self._entries, default=0)

    def last_index(self):
        return self._last

    def term_at(self, index):
        e = self._entries.get(index)
        return e.term if e else 0

    def truncate_from(self, index):
        self.wal.truncate_from(index)
        for i in list(self._entries):
            if i >= index:
                del self._entries[i]
        self._last = min(self._last, index - 1)

    def purge_to(self, index):
        self.wal.purge_to(index)  # listener prunes _entries

    def _on_purge(self, seq: int):
        self._purge_floor = max(getattr(self, "_purge_floor", 0), seq)
        terms = getattr(self, "_purged_terms", None)
        if terms is None:
            terms = self._purged_terms = {}
        for i in list(self._entries):
            if i < seq:
                # remember the purged entry's TERM: propose() must still
                # distinguish "my applied entry was GC'd" (success) from
                # "a different leader's replacement was GC'd" (lost write)
                terms[i] = self._entries[i].term
                del self._entries[i]
        if len(terms) > 8192:
            evicted = sorted(terms)[:4096]
            # remember HOW FAR records were dropped: a propose() landing in
            # the evicted range must report "outcome unknown", not the
            # definite "superseded" (its entry may well have committed)
            self._purged_terms_evicted_to = max(
                self._purged_terms_evicted_to, evicted[-1])
            for k in evicted:
                del terms[k]

    def purged_term(self, idx: int) -> int | None:
        """Term of a purged (applied + GC'd) entry, if remembered."""
        return getattr(self, "_purged_terms", {}).get(idx)

    def purge_record_floor(self) -> int:
        return self._purged_terms_evicted_to

    def save_hard_state(self, term, voted_for):
        import os

        self._term, self._voted = term, voted_for
        tmp = self._hs_path + ".tmp"
        v = 2**64 - 1 if voted_for is None else voted_for
        with open(tmp, "wb") as f:
            f.write(term.to_bytes(8, "little") + v.to_bytes(8, "little"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._hs_path)

    def load_hard_state(self):
        return self._term, self._voted


class Transport:
    """Message passing between raft peers; send(to, msg) → reply dict|None."""

    def send(self, group_id: str, to: int, msg: dict) -> dict | None:
        raise NotImplementedError


class InProcessTransport(Transport):
    """Single-process cluster wiring (tests + single-host replica sets).

    Fault injection beyond partitions (the faults real gRPC links show and
    the reference exercises only by killing processes): `loss_rate` drops
    messages, `max_delay_s` adds random latency, `reorder_rate` delays a
    message past its successors (message-level reordering). Raft must stay
    safe under all of them — tests drive the knobs."""

    def __init__(self):
        self.nodes: dict[tuple[str, int], "RaftNode"] = {}
        self.partitions: set[frozenset] = set()
        self.lock = lockwatch.Lock("raft.sim_net")
        self.loss_rate = 0.0
        self.max_delay_s = 0.0
        self.reorder_rate = 0.0
        self._rng = random.Random(1234)

    def register(self, node: "RaftNode"):
        self.nodes[(node.group_id, node.node_id)] = node

    def partition(self, a: int, b: int):
        with self.lock:
            self.partitions.add(frozenset((a, b)))

    def heal(self):
        with self.lock:
            self.partitions.clear()

    def chaos(self, loss: float = 0.0, delay_s: float = 0.0,
              reorder: float = 0.0):
        with self.lock:
            self.loss_rate = loss
            self.max_delay_s = delay_s
            self.reorder_rate = reorder

    def send(self, group_id, to, msg):
        with self.lock:
            if frozenset((msg["from"], to)) in self.partitions:
                return None
            loss, delay, reorder = (self.loss_rate, self.max_delay_s,
                                    self.reorder_rate)
            if loss and self._rng.random() < loss:
                return None
            sleep_s = 0.0
            if delay:
                sleep_s = self._rng.random() * delay
            if reorder and self._rng.random() < reorder:
                # hold this message past later ones (same-link reordering)
                sleep_s += delay if delay else 0.01
        if sleep_s:
            time.sleep(sleep_s)
        node = self.nodes.get((group_id, to))
        if node is None or not node.alive:
            return None
        return node.handle_message(msg)


class HttpTransport(Transport):
    """Cross-process raft transport (reference replication/src/
    network_grpc.rs RaftCBServer + network_client.rs client pool): messages
    for peers on this host short-circuit through an embedded
    InProcessTransport; remote peers get msgpack-HTTP `raft_msg` RPCs.

    `resolver(group_id, peer_id) -> "host:port" | None` — None means the
    peer is (or should be) local. Unreachable peers yield None replies,
    which the raft layer already treats as dropped messages."""

    def __init__(self, resolver):
        self.resolver = resolver
        self.local = InProcessTransport()
        self.nodes = self.local.nodes  # registry view for managers

    def register(self, node: "RaftNode"):
        self.local.register(node)

    def send(self, group_id, to, msg):
        if (group_id, to) in self.local.nodes:
            return self.local.send(group_id, to, msg)
        addr = self.resolver(group_id, to)
        if addr is None:
            return None
        from .net import RpcError, RpcUnauthorized, rpc_call

        try:
            # short timeout: raft treats a missing reply as a dropped
            # message and retries next tick; a long block here would stall
            # the concurrent broadcast threads' join window. A follower's
            # read index waits for the leader's round: the read's own
            # budget, which it sends along
            r = rpc_call(addr, "raft_msg",
                         {"group": group_id, "to": to, "msg": msg},
                         timeout=2.0 if msg["type"] != "read_index"
                         else msg["timeout"] + 0.5)
        except RpcUnauthorized as e:
            # permanent misconfiguration (peers disagree on the cluster
            # secret) — swallowing it would look exactly like a network
            # partition forever. Surface it loudly, once per peer.
            flagged = getattr(self, "_auth_flagged", None)
            if flagged is None:
                flagged = self._auth_flagged = set()
            if (group_id, to) not in flagged:
                flagged.add((group_id, to))
                import sys as _sys

                print(f"raft[{group_id}] peer {to}@{addr} rejects the "
                      f"cluster secret: {e} — check CNOSDB_CLUSTER_SECRET "
                      f"on every member", file=_sys.stderr)
            return None
        except RpcError:
            return None
        return r.get("reply")


# A follower that hears no append for a span drawn from this range (s)
# starts an election: a group whose leader is gone elects a new one
# within about the longest span, a prevote and a vote round later
ELECTION_TIMEOUT = (0.15, 0.3)

RAFT_BLANK = 5       # WalEntryType.RAFT_BLANK
RAFT_MEMBERSHIP = 6  # WalEntryType.RAFT_MEMBERSHIP — config-change entries


class RaftNode:
    """One consensus participant for one group (≈ reference RaftNode)."""

    def __init__(self, group_id: str, node_id: int, peers: list[int],
                 log: LogStore, sm: StateMachine, transport: Transport,
                 election_timeout: tuple[float, float] = ELECTION_TIMEOUT,
                 heartbeat_interval: float = 0.05,
                 tick: bool = True, initial_applied: int = 0,
                 on_state=None):
        self.group_id = group_id
        self.node_id = node_id
        self.peers = [p for p in peers if p != node_id]
        self.log = log
        self.sm = sm
        self.transport = transport
        self.election_timeout = election_timeout
        self.heartbeat_interval = heartbeat_interval
        # leadership-change callback (event-driven writers instead of
        # sleep-poll loops; loaded hosts starve pollers into deadlines)
        self.on_state = on_state

        self.term, self.voted_for = log.load_hard_state()
        # adopted-config history: (log index, members) per MEMBERSHIP entry
        # stored — log truncation must revert to the prior configuration
        self._boot_members = sorted({*self.peers, node_id})
        self._config_log: list[tuple[int, list[int]]] = []
        self.role = Role.FOLLOWER
        self.leader_id: int | None = None
        # a state machine that persisted its apply watermark resumes there:
        # replicated meta at its store's, a vnode member at its vnode's
        # (replica._resume_index); 0 = replay the whole log
        self.commit_index = initial_applied
        self.last_applied = initial_applied
        self.next_index: dict[int, int] = {}
        self.match_index: dict[int, int] = {}
        self.alive = True
        self.lock = lockwatch.RLock("raft.node")
        # serializes sm.apply vs sm.snapshot so a shipped snapshot is
        # consistent with the applied index it claims (ordering: self.lock
        # may be held when taking _sm_lock, never the reverse)
        self._sm_lock = lockwatch.Lock("raft.sm")
        self._last_heartbeat = time.monotonic()
        self._election_deadline = self._new_deadline()
        self._stop = threading.Event()
        self._apply_cv = threading.Condition(self.lock)
        # why a group elects or does not, for /debug/health: the ticker's
        # last pass, the prevote rounds this member ran and their last
        # tally, and the prevotes it refused, by reason
        self._last_tick = time.monotonic()
        self.elections = {"prevote_rounds": 0, "prevotes_won": 0,
                          "last_prevote": None, "tick_errors": 0,
                          "refused": {}}
        # the read index: the term whose own entry last committed here (a
        # new leader learns the commit index only then). Append broadcasts
        # are numbered: the newest one asked for, the newest one a send
        # has carried, and per peer the newest one a returned send carried
        # (`_done`) and a reply at its term answered (`_heard`). A peer
        # has one send in flight at a time (`_sending`: its sender runs)
        self._commit_term = 0
        self._bcast_seq = 0
        self._bcast_taken = 0
        self._done: dict[int, int] = {}
        self._heard: dict[int, int] = {}
        self._sending: set[int] = set()
        self._sent_cv = threading.Condition(self.lock)
        if hasattr(transport, "register"):
            transport.register(self)
        self._ticker = None
        if tick:
            self._ticker = threading.Thread(target=self._tick_loop, daemon=True)
            self._ticker.start()

    # ------------------------------------------------------------ lifecycle
    def _new_deadline(self):
        lo, hi = self.election_timeout
        return time.monotonic() + random.uniform(lo, hi)

    def _notify_state(self):
        cb = self.on_state
        if cb is not None:
            try:
                cb(self)
            except Exception:
                stages.count_error("swallow.raft.on_state_cb")

    def stop(self):
        self._stop.set()
        self.alive = False
        if self._ticker:
            self._ticker.join(timeout=1)

    def crash(self):
        """Simulate failure: stop responding (state retained for restart)."""
        self.alive = False

    def restart(self):
        with self.lock:
            self.alive = True
            self.role = Role.FOLLOWER
            self._election_deadline = self._new_deadline()

    def _tick_loop(self):
        while not self._stop.is_set():
            time.sleep(0.01)
            self._last_tick = time.monotonic()
            if not self.alive:
                continue
            try:
                with self.lock:
                    role = self.role
                now = time.monotonic()
                if role == Role.LEADER:
                    # a heartbeat waits for no peer's send: one slow peer
                    # would hold the ticker, and the healthy followers,
                    # hearing nothing past an election timeout, elect
                    if now - self._last_heartbeat >= self.heartbeat_interval:
                        self._broadcast_append(wait=0)
                elif now >= self._election_deadline:
                    self._start_election()
            except Exception:
                # a transient failure (e.g. races at shutdown) must not kill
                # the ticker thread and silently dead-lock the group; it is
                # counted, so one that repeats shows
                if self._stop.is_set():
                    return
                self.elections["tick_errors"] += 1
                stages.count_error("swallow.raft.tick")
                time.sleep(0.05)

    # ------------------------------------------------------------ elections
    def _start_election(self):
        if not self._prevote():
            return
        with self.lock:
            self.term += 1
            self.role = Role.CANDIDATE
            self.leader_id = None
            self.voted_for = self.node_id
            self.log.save_hard_state(self.term, self.voted_for)
            term = self.term
            last_idx = self.log.last_index()
            last_term = self.log.term_at(last_idx)
            self._election_deadline = self._new_deadline()
        # ask all peers concurrently; proceed on majority without waiting
        # for slow/unreachable peers (same rationale as _broadcast_append)
        votes = [1]
        total = len(self.peers) + 1
        vote_lock = lockwatch.Lock("raft.vote")
        settled = threading.Event()

        replied = [0]

        def ask(p):
            reply = None
            try:
                reply = self.transport.send(self.group_id, p, {
                    "type": "request_vote", "from": self.node_id,
                    "term": term, "last_log_index": last_idx,
                    "last_log_term": last_term})
            except Exception:
                reply = None
            # tally BEFORE marking this peer replied: settling first would
            # let the main thread read a stale vote count and fail a round
            # that was actually won
            if reply is not None:
                if reply.get("term", 0) > term:
                    self._step_down(reply["term"])
                    settled.set()
                    return
                if reply.get("granted"):
                    with vote_lock:
                        votes[0] += 1
                        if votes[0] * 2 > total:
                            settled.set()
            with vote_lock:
                replied[0] += 1
                all_in = replied[0] == len(self.peers)
            if all_in:
                # every peer answered (grant/refusal/error): the round is
                # decided — sleeping out the full timeout would turn each
                # split-vote round into a 1s stall (the
                # two-survivors-of-a-dead-leader election flake)
                settled.set()

        threads = [threading.Thread(target=ask, args=(p,), daemon=True)
                   for p in self.peers]
        for t in threads:
            t.start()
        settled.wait(timeout=1.0)
        with self.lock:
            if self.role != Role.CANDIDATE or self.term != term:
                return
            # a round that a silent peer made wait out its second has
            # outlived the deadline drawn at its start: draw it again, or
            # two candidates split the vote round after round in lockstep
            self._election_deadline = self._new_deadline()
            if votes[0] * 2 > len(self.peers) + 1:
                self.role = Role.LEADER
                self.leader_id = self.node_id
                last = self.log.last_index()
                self.next_index = {p: last + 1 for p in self.peers}
                self.match_index = {p: 0 for p in self.peers}
                # commit a blank entry to settle the new term (raft §8)
                self._append_local(RAFT_BLANK, b"")
        if self.role == Role.LEADER:
            self._notify_state()
            self._broadcast_append()

    def _prevote(self) -> bool:
        """PreVote phase (raft §4.2.3): probe a majority WITHOUT touching
        term or voted_for. A partitioned node otherwise inflates its term
        on every timeout and, on heal, disrupts the healthy group with a
        storm of stale-log elections — the classic post-partition
        convergence flake."""
        with self.lock:
            if not self.peers:
                return True
            term = self.term + 1
            last_idx = self.log.last_index()
            last_term = self.log.term_at(last_idx)
            self._election_deadline = self._new_deadline()
        votes = [1]
        total = len(self.peers) + 1
        vote_lock = lockwatch.Lock("raft.vote")
        settled = threading.Event()

        replied = [0]

        def ask(p):
            reply = None
            try:
                reply = self.transport.send(self.group_id, p, {
                    "type": "request_prevote", "from": self.node_id,
                    "term": term, "last_log_index": last_idx,
                    "last_log_term": last_term})
            except Exception:
                reply = None
            if reply is not None and reply.get("granted"):
                with vote_lock:   # tally before the replied mark (above)
                    votes[0] += 1
                    if votes[0] * 2 > total:
                        settled.set()
            with vote_lock:
                replied[0] += 1
                all_in = replied[0] == len(self.peers)
            if all_in:
                settled.set()   # round decided — don't sleep it out

        threads = [threading.Thread(target=ask, args=(p,), daemon=True)
                   for p in self.peers]
        for t in threads:
            t.start()
        settled.wait(timeout=1.0)
        won = votes[0] * 2 > total
        self.elections["prevote_rounds"] += 1
        self.elections["prevotes_won"] += won
        self.elections["last_prevote"] = {
            "term": term, "granted": votes[0] - 1, "replied": replied[0],
            "peers": len(self.peers), "last_log": [last_term, last_idx]}
        return won

    def _on_request_prevote(self, msg):
        with self.lock:
            # leader stickiness: a node that heard from a live leader
            # recently refuses prevotes — heals don't topple a working
            # leader. No term/voted_for mutation here, by design.
            lo, _hi = self.election_timeout
            heard_recently = (time.monotonic()
                              - getattr(self, "_last_append_seen", 0.0)) < lo
            my_last = self.log.last_index()
            my_term = self.log.term_at(my_last)
            up_to_date = (msg["last_log_term"], msg["last_log_index"]) >= \
                (my_term, my_last)
            # a LEADER always refuses: if it can receive this prevote it is
            # alive, and granting would let a healed node assemble a
            # majority to depose it (the disruption PreVote exists to stop)
            granted = (msg["term"] >= self.term and up_to_date
                       and self.role != Role.LEADER
                       and not (heard_recently
                                and self.role == Role.FOLLOWER))
            if not granted:
                why = ("term" if msg["term"] < self.term else
                       "log" if not up_to_date else
                       "leader" if self.role == Role.LEADER else "heard")
                refused = self.elections["refused"]
                refused[why] = refused.get(why, 0) + 1
            return {"term": self.term, "granted": granted}

    def _step_down(self, term: int):
        with self.lock:
            if term > self.term or self.role == Role.LEADER:
                # a new term's leader is unknown until it is heard from:
                # a stale leader_id (this member itself, once it led) is
                # the hint NotLeader and a leader read would follow
                self.leader_id = None
            if term > self.term:
                self.term = term
                self.voted_for = None
                self.log.save_hard_state(self.term, None)
            self.role = Role.FOLLOWER
            self._election_deadline = self._new_deadline()
        self._notify_state()

    # ------------------------------------------------------------ client API
    def propose(self, entry_type: int, data: bytes,
                timeout: float = 5.0) -> int:
        """Append via the leader; blocks until applied. → log index.

        Verifies the applied entry at idx still carries OUR term: after a
        leadership change the slot can hold a different leader's entry
        (ours truncated away) — reporting that as success would tell the
        caller a lost write committed."""
        with self.lock:
            if self.role != Role.LEADER:
                raise NotLeader(self.leader_id)
            idx = self._append_local(entry_type, data)
            term = self.term
        self._broadcast_append()
        deadline = time.monotonic() + timeout
        with self._apply_cv:
            while self.last_applied < idx:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ReplicationError("propose timeout", index=idx)
                self._apply_cv.wait(remaining)
        with self.lock:
            e = self.log.entry_at(idx)
        if e is None:
            # absence = post-apply WAL purge or truncation after
            # leadership loss; the recorded purge-time term disambiguates
            pt = getattr(self.log, "purged_term", lambda i: None)(idx)
            if pt == term:
                return idx
            if pt is None and idx <= self.log.purge_record_floor():
                # purge record evicted: the entry may have committed with
                # our term — a definite "superseded" here would report a
                # real write as lost. Surface the uncertainty instead.
                raise ReplicationError(
                    "outcome unknown: purged-entry term record evicted — "
                    "re-check state before retrying", index=idx)
            raise ReplicationError(
                "entry superseded after leadership change", index=idx)
        if e.term != term:
            raise ReplicationError(
                "entry superseded after leadership change", index=idx)
        return idx

    def read_index(self, timeout: float = 5.0, follow: bool = True) -> int:
        """The read index of the raft thesis (§6.4; openraft's
        ensure_linearizable) → the log index a linearizable read may serve
        at, applied here before it returns. The leader waits for an entry
        of its own term to commit (a new leader learns the commit index
        only then), reads its commit index, and confirms that it still
        leads: a majority, this member included, answers at its term an
        append sent after the read arrived (`_confirm`). A follower
        (with `follow`) takes the follower read index instead
        (`_follower_read_index`). Raises NotLeader when this member does
        not lead and `follow` is off, or cannot confirm the read or apply
        the index within `timeout`: its hint is the leader it follows, or
        a newer leader it heard of, else None."""
        from . import health

        with self.lock:
            leads = self.is_leader()
        if follow and not leads:
            return self._follower_read_index(timeout)
        t0 = time.monotonic()
        deadline = t0 + timeout
        waited = False
        try:
            with self.lock:
                term = self._leading()
            while True:
                with self._apply_cv:
                    self._leading(term)
                    if self._commit_term == term:
                        read_idx = self.commit_index
                        break
                # this term's blank entry has not committed: carry it to
                # the peers again each heartbeat while waiting
                waited = True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise NotLeader(None)
                self._broadcast_append(wait=0)
                with self._apply_cv:
                    if self._commit_term != term:
                        self._apply_cv.wait(min(remaining,
                                                self.heartbeat_interval))
            self._confirm(term, deadline)
            with self._apply_cv:
                while self.last_applied < read_idx:
                    waited = True
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise NotLeader(None)
                    self._apply_cv.wait(remaining)
        except NotLeader:
            health.count_read_index("not_leader")
            raise
        finally:
            health.count_read_index(
                "wait_us", int((time.monotonic() - t0) * 1e6))
        health.count_read_index("confirmed")
        if waited:
            health.count_read_index("apply_waits")
        return read_idx

    def _follower_read_index(self, timeout: float) -> int:
        """The follower read index (raft thesis §6.4) → the leader's read
        index, applied here before it returns. The member asks the leader
        it follows, over its own raft transport, for the leader's read
        index (`_on_read_index`: the leader confirms with its majority
        round), then waits until it has applied that index: every entry
        the group committed before the read arrived. Raises NotLeader
        where the member is a candidate or knows no leader (hint None),
        where the leader does not answer or the apply does not finish
        within `timeout` (hint the leader), and where the leader refuses
        (hint the leader's own hint)."""
        from . import health

        t0 = time.monotonic()
        deadline = t0 + timeout
        t_apply = None
        try:
            with self.lock:
                leader = self.leader_id
                if self.role != Role.FOLLOWER or not self.alive \
                        or leader in (None, self.node_id):
                    raise NotLeader(None)
                term = self.term
            try:
                reply = self.transport.send(self.group_id, leader, {
                    "type": "read_index", "from": self.node_id,
                    "term": term, "timeout": timeout})
            except Exception:
                reply = None
            if reply is None:
                raise NotLeader(leader)
            idx = reply.get("index")
            if idx is None:
                hint = reply.get("hint")
                raise NotLeader(hint if hint != self.node_id else None)
            t_apply = time.monotonic()
            with self._apply_cv:
                while self.last_applied < idx:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise NotLeader(leader)
                    self._apply_cv.wait(remaining)
        except NotLeader:
            health.count_read_index("follower_refused")
            raise
        finally:
            now = time.monotonic()
            health.count_read_index("wait_us", int((now - t0) * 1e6))
            if t_apply is not None:
                health.count_read_index("follower_apply_us",
                                        int((now - t_apply) * 1e6))
        health.count_read_index("follower_confirmed")
        return idx

    def _on_read_index(self, msg) -> dict:
        """A follower's read-index request: the leader's read index, run
        as for a read of its own (a round shared with the reads under
        way), within the follower's timeout → {"term", "index"}; a member
        that does not lead, or cannot confirm, answers index None with
        its hint."""
        try:
            idx = self.read_index(float(msg.get("timeout", 5.0)),
                                  follow=False)
        except NotLeader as e:
            return {"term": self.term, "index": None, "hint": e.leader_id}
        return {"term": self.term, "index": idx}

    def _leading(self, term: int | None = None) -> int:
        """→ this member's term; NotLeader unless it leads (at `term`,
        where given), its hint the leader this member follows (None where
        it knows none). Caller holds self.lock."""
        if self.is_leader() and term in (None, self.term):
            return self.term
        hint = self.leader_id
        raise NotLeader(hint if hint != self.node_id else None)

    def _confirm(self, term: int, deadline: float) -> None:
        """Raise NotLeader unless a majority, this member included,
        answers at `term` an append sent after this call, by `deadline`.
        Any reply at the term counts, whether or not the append took. The
        reads that arrive before any send has carried the newest
        broadcast share it; else a read asks for the next one. A peer
        whose send is in flight (slow, hung, or taking a snapshot) gets
        it once that send returns: reads add no sends beside it. Lost
        once every peer answered the broadcast or failed without a
        majority at the term (a higher term steps this member down)."""
        from . import health

        with self.lock:
            if self._bcast_taken >= self._bcast_seq:
                health.count_read_index("rounds")
                self._broadcast_append(wait=0)
            want = self._bcast_seq
        with self._sent_cv:
            while True:
                self._leading(term)
                peers = list(self.peers)
                acks = 1 + sum(self._heard.get(p, 0) >= want for p in peers)
                if acks * 2 > len(peers) + 1:
                    return
                remaining = deadline - time.monotonic()
                if remaining <= 0 or all(self._done.get(p, 0) >= want
                                         for p in peers):
                    raise NotLeader(None)
                self._sent_cv.wait(remaining)

    def _append_local(self, entry_type: int, data: bytes) -> int:
        idx = self.log.last_index() + 1
        self.log.append(LogEntry(self.term, idx, entry_type, data))
        self.match_index[self.node_id] = idx
        return idx

    # ------------------------------------------------------------ membership
    def change_membership(self, member_ids: list[int],
                          timeout: float = 10.0) -> int:
        """Single-step voter add/remove (reference raft/manager.rs
        add_follower/remove via openraft change_membership). Leader-only.

        The new configuration takes effect at APPEND time on every node
        that stores the entry (raft §6: for one-server deltas the old and
        new majorities always overlap, so append-time adoption is safe).
        Blocks until the entry commits under the NEW configuration.

        Removing the current leader itself is rejected — the commit
        counter includes self; callers stepdown() first and re-issue on
        the new leader."""
        import msgpack as _mp

        with self.lock:
            if self.role != Role.LEADER:
                raise NotLeader(self.leader_id)
            new = sorted({int(p) for p in member_ids})
            cur = sorted({*self.peers, self.node_id})
            delta = set(new) ^ set(cur)
            if not delta:
                return self.commit_index
            if len(delta) > 1:
                raise ReplicationError(
                    f"membership changes one server at a time "
                    f"(current {cur}, requested {new})")
            if self.node_id not in new:
                raise ReplicationError(
                    "cannot remove the current leader: transfer leadership "
                    "first (stepdown), then remove via the new leader")
            data = _mp.packb({"members": new}, use_bin_type=True)
            idx = self._append_local(RAFT_MEMBERSHIP, data)
            term = self.term
            self._adopt_membership(new, index=idx)
        self._broadcast_append()
        deadline = time.monotonic() + timeout
        with self._apply_cv:
            while self.last_applied < idx:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ReplicationError("membership change timeout",
                                           index=idx)
                self._apply_cv.wait(remaining)
        with self.lock:
            e = self.log.entry_at(idx)
        if e is not None and e.term != term:
            raise ReplicationError(
                "membership change superseded after leadership change",
                index=idx)
        return idx

    def _adopt_membership(self, member_ids: list[int],
                          index: int | None = None) -> None:
        """Install a configuration (list of member ids incl. self if still
        a member). Caller holds self.lock. `index` records which log entry
        carried it, so truncation can revert."""
        self.peers = [p for p in member_ids if p != self.node_id]
        if index is not None:
            self._config_log.append((index, sorted(member_ids)))
        last = self.log.last_index()
        for p in self.peers:
            self.next_index.setdefault(p, last + 1)
            self.match_index.setdefault(p, 0)
        for p in list(self.next_index):
            if p not in self.peers:
                del self.next_index[p]
        for p in list(self.match_index):
            if p != self.node_id and p not in self.peers:
                del self.match_index[p]

    def _revert_config_from(self, idx: int) -> None:
        """Log truncation erased entries ≥ idx: any configuration adopted
        from an erased MEMBERSHIP entry must roll back to the latest
        surviving one (or the boot config) — an append-time-adopted but
        never-committed config would otherwise make this node count the
        wrong quorum forever. Caller holds self.lock."""
        if not self._config_log or self._config_log[-1][0] < idx:
            return
        self._config_log = [(i, m) for i, m in self._config_log if i < idx]
        members = (self._config_log[-1][1] if self._config_log
                   else self._boot_members)
        self._adopt_membership(members)

    def stepdown(self) -> None:
        """Voluntarily yield leadership: revert to follower and push this
        node's own election deadline far out so a peer campaigns first
        (used before removing the leader member, and by MOVE VNODE)."""
        with self.lock:
            if self.role == Role.LEADER:
                self.role = Role.FOLLOWER
                self.leader_id = None
                lo, hi = self.election_timeout
                self._election_deadline = time.monotonic() + 4 * hi
        self._notify_state()

    # ------------------------------------------------------------ replication
    def _broadcast_append(self, wait: float = 0.5) -> int:
        """Ask every peer for an append (a heartbeat, the entries it
        lacks, or a snapshot) → the broadcast's number. Each peer has ONE
        send in flight: a peer whose sender is busy gets the newest
        broadcast once its send returns, so a slow, unreachable or
        snapshot-bound peer holds one thread and one send however often
        broadcasts are asked for, and never delays the healthy majority.
        Waits up to `wait` s for every peer's send of this broadcast to
        return, so the fast majority's replies land before commit."""
        with self.lock:
            self._bcast_seq += 1
            seq = self._bcast_seq
            peers = list(self.peers)
            idle = [p for p in peers if p not in self._sending]
            self._sending.update(idle)
        self._last_heartbeat = time.monotonic()
        for p in idle:
            try:
                threading.Thread(target=self._sender, args=(p,),
                                 daemon=True).start()
            except RuntimeError:
                # no thread to send with: the peer misses this broadcast,
                # as a lost message, and the next one starts its sender
                stages.count_error("swallow.raft.send_append")
                with self.lock:
                    self._sending.discard(p)
        if wait:
            until = time.monotonic() + wait
            with self._sent_cv:
                while self.role == Role.LEADER and any(
                        self._done.get(p, 0) < seq for p in peers):
                    remaining = until - time.monotonic()
                    if remaining <= 0:
                        break
                    self._sent_cv.wait(remaining)
        self._advance_commit()
        return seq

    def _sender(self, peer: int):
        """Send `peer` the newest broadcast until it has none newer than
        the one its last send carried, then stop (the next broadcast
        starts it again). A failed send is a dropped message: it never
        unwinds the sender (e.g. stores closing during shutdown)."""
        while True:
            with self.lock:
                seq, term = self._bcast_seq, self.term
                if self.role != Role.LEADER or peer not in self.peers:
                    self._done[peer] = max(self._done.get(peer, 0), seq)
                    self._sending.discard(peer)
                    self._sent_cv.notify_all()
                    return
                self._bcast_taken = max(self._bcast_taken, seq)
            reply = None
            try:
                reply = self._send_append(peer)
            except Exception:
                stages.count_error("swallow.raft.send_append")
            with self._sent_cv:
                self._done[peer] = max(self._done.get(peer, 0), seq)
                if reply is not None and reply.get("term") == term \
                        and self.term == term:
                    self._heard[peer] = max(self._heard.get(peer, 0), seq)
                self._sent_cv.notify_all()
                if self._bcast_seq == seq:
                    self._sending.discard(peer)
                    return

    def _send_append(self, peer: int) -> dict | None:
        """One append (or snapshot) to `peer` → its reply, None when none
        came or this member does not lead."""
        need_snapshot = False
        with self.lock:
            if self.role != Role.LEADER:
                return
            ni = self.next_index.get(peer, self.log.last_index() + 1)
            prev_idx = ni - 1
            prev_term = self.log.term_at(prev_idx)
            entries = self.log.entries_from(ni)
            if prev_idx > 0 and prev_term == 0 and self.log.entry_at(prev_idx) is None:
                # prev purged by WAL GC. Its remembered term substitutes —
                # but only when everything from ni onward is still servable
                # (ni itself retained, or nothing to send): a purged ni
                # means the follower genuinely needs the state, and an
                # empty-entries append would stall it forever instead.
                remembered = self.log.purged_term(prev_idx)
                can_serve = (ni > self.log.last_index()
                             or self.log.entry_at(ni) is not None)
                if remembered and can_serve:
                    prev_term = remembered
                else:
                    need_snapshot = True  # log purged below ni
            msg = None if need_snapshot else {
                "type": "append_entries", "from": self.node_id,
                "term": self.term, "prev_log_index": prev_idx,
                "prev_log_term": prev_term,
                "entries": [[e.term, e.index, e.entry_type, e.data]
                            for e in entries],
                "leader_commit": self.commit_index,
            }
        if need_snapshot:
            # snapshot serialization scans the state machine: NEVER under
            # the raft lock, or heartbeats/votes stall and elections fire
            return self._send_snapshot(peer)
        reply = self.transport.send(self.group_id, peer, msg)
        if reply is None:
            return None
        advanced = False
        with self.lock:
            if reply.get("term", 0) > self.term:
                pass
            elif reply.get("success"):
                if entries:
                    self.match_index[peer] = entries[-1].index
                    self.next_index[peer] = entries[-1].index + 1
                    advanced = True
            else:
                self.next_index[peer] = max(1, min(
                    ni - 1, reply.get("conflict_index", ni - 1)))
                return reply
        if reply.get("term", 0) > self.term:
            self._step_down(reply["term"])
        elif advanced:
            # commit as soon as this reply completes a majority — replies
            # from concurrent broadcast threads must not wait for the next
            # heartbeat tick
            self._advance_commit()
        return reply

    def _send_snapshot(self, peer: int):
        # Capture (snapshot, applied index) consistently WITHOUT holding
        # _sm_lock across serialization: appliers hold self.lock while
        # waiting on _sm_lock, so a long-held _sm_lock would transitively
        # stall heartbeats and trigger elections. Optimistic scheme: the
        # brief _sm_lock acquisitions mean no apply is mid-flight at either
        # index read; equal indices bracket an untorn serialization.
        for attempt in range(10):
            with self._sm_lock:
                a0 = self.last_applied
            try:
                data = self.sm.snapshot()
            except RuntimeError:  # state mutated during iteration
                continue
            with self._sm_lock:
                applied_idx = self.last_applied
            if applied_idx == a0:
                break
        else:
            # heavy churn: take the lock as a last resort for a bounded time
            with self._sm_lock:
                data = self.sm.snapshot()
                applied_idx = self.last_applied
        msg = {"type": "install_snapshot", "from": self.node_id,
               "term": self.term, "data": data,
               "last_index": applied_idx,
               "last_term": self.log.term_at(applied_idx)}
        reply = self.transport.send(self.group_id, peer, msg)
        if reply and reply.get("success"):
            with self.lock:
                self.next_index[peer] = applied_idx + 1
                self.match_index[peer] = applied_idx
        return reply

    def _advance_commit(self):
        with self.lock:
            if self.role != Role.LEADER:
                return
            matches = sorted([self.log.last_index()]
                             + [self.match_index.get(p, 0) for p in self.peers])
            majority_idx = matches[len(matches) // 2] if len(matches) % 2 \
                else matches[len(matches) // 2 - 1]
            # a leader only commits entries from its own term (raft §5.4.2)
            if majority_idx > self.commit_index and \
                    self.log.term_at(majority_idx) == self.term:
                self.commit_index = majority_idx
                self._commit_term = self.term
            self._apply_committed()

    def _apply_committed(self):
        while self.last_applied < self.commit_index:
            e = self.log.entry_at(self.last_applied + 1)
            if e is None:
                break
            with self._sm_lock:
                if e.entry_type not in (RAFT_BLANK, RAFT_MEMBERSHIP):
                    try:
                        self.sm.apply(e)
                    except Exception as exc:
                        # environmental apply failure (state machines raise
                        # through for non-deterministic errors): do NOT
                        # advance last_applied — stall at this index and
                        # retry on the next tick rather than diverge, and
                        # keep the tick/message threads alive. Log once
                        # per stalled index, not once per tick.
                        if getattr(self, "_stall_logged", None) != e.index:
                            self._stall_logged = e.index
                            import sys as _sys

                            print(f"raft[{self.group_id}] apply stalled at "
                                  f"index {e.index}: {exc!r}",
                                  file=_sys.stderr)
                        break
                self.last_applied += 1
        with self._apply_cv:
            self._apply_cv.notify_all()

    # ------------------------------------------------------------ RPC handling
    def handle_message(self, msg: dict) -> dict:
        t = msg["type"]
        if t == "request_prevote":
            return self._on_request_prevote(msg)
        if t == "request_vote":
            return self._on_request_vote(msg)
        if t == "append_entries":
            return self._on_append_entries(msg)
        if t == "install_snapshot":
            return self._on_install_snapshot(msg)
        if t == "read_index":
            return self._on_read_index(msg)
        raise ReplicationError(f"unknown message {t}")

    def _on_request_vote(self, msg):
        with self.lock:
            if msg["term"] > self.term:
                self._step_down(msg["term"])
            granted = False
            if msg["term"] == self.term and self.voted_for in (None, msg["from"]):
                my_last = self.log.last_index()
                my_term = self.log.term_at(my_last)
                up_to_date = (msg["last_log_term"], msg["last_log_index"]) >= \
                    (my_term, my_last)
                if up_to_date:
                    granted = True
                    self.voted_for = msg["from"]
                    self.log.save_hard_state(self.term, self.voted_for)
                    self._election_deadline = self._new_deadline()
            return {"term": self.term, "granted": granted}

    def _on_append_entries(self, msg):
        with self.lock:
            if msg["term"] < self.term:
                return {"term": self.term, "success": False}
            if msg["term"] > self.term:
                self._step_down(msg["term"])
            self.role = Role.FOLLOWER
            changed = self.leader_id != msg["from"]
            self.leader_id = msg["from"]
            if changed:
                self._notify_state()
            self._last_append_seen = time.monotonic()
            self._election_deadline = self._new_deadline()
            prev_idx, prev_term = msg["prev_log_index"], msg["prev_log_term"]
            if prev_idx > 0:
                local_term = self.log.term_at(prev_idx)
                if local_term == 0 and self.log.entry_at(prev_idx) is None:
                    # prev was applied here then GC'd: match against its
                    # remembered term rather than rejecting — a reject
                    # walks the leader's next_index down into its own
                    # purged range and forces a full snapshot install for
                    # state this follower already has
                    local_term = self.log.purged_term(prev_idx) or 0
                if local_term != prev_term:
                    conflict = min(prev_idx, self.log.last_index() + 1)
                    return {"term": self.term, "success": False,
                            "conflict_index": max(1, conflict)}
            for raw in msg["entries"]:
                e = LogEntry(raw[0], raw[1], raw[2], raw[3])
                existing = self.log.entry_at(e.index)
                if existing is not None and existing.term != e.term:
                    self.log.truncate_from(e.index)
                    self._revert_config_from(e.index)
                    existing = None
                if existing is None:
                    self.log.append(e)
                    if e.entry_type == RAFT_MEMBERSHIP:
                        # configuration applies as soon as it is stored
                        import msgpack as _mp

                        self._adopt_membership(
                            _mp.unpackb(e.data, raw=False)["members"],
                            index=e.index)
            if msg["leader_commit"] > self.commit_index:
                self.commit_index = min(msg["leader_commit"],
                                        self.log.last_index())
            self._apply_committed()
            return {"term": self.term, "success": True}

    def _on_install_snapshot(self, msg):
        with self.lock:
            if msg["term"] < self.term:
                return {"term": self.term, "success": False}
            if msg["term"] > self.term:
                self._step_down(msg["term"])
            self.leader_id = msg["from"]
            self._election_deadline = self._new_deadline()
            with self._sm_lock:
                self.sm.install_snapshot(msg["data"], msg["last_index"],
                                         msg["last_term"])
                self.log.truncate_from(1)
                self.log.append(LogEntry(msg["last_term"], msg["last_index"],
                                         RAFT_BLANK, b""))
                self.commit_index = msg["last_index"]
                self.last_applied = msg["last_index"]
            return {"term": self.term, "success": True}

    # ------------------------------------------------------------ info
    def is_leader(self) -> bool:
        return self.role == Role.LEADER and self.alive

    def metrics(self) -> dict:
        return {"term": self.term, "role": self.role,
                "leader": self.leader_id, "commit": self.commit_index,
                "applied": self.last_applied,
                "last_log": self.log.last_index()}

    def election_stats(self) -> dict:
        """The ticker's age, whether another thread holds this member's
        lock, and the prevote tallies (see __init__). Never waits for the
        lock: a member stuck behind it is what this reads."""
        out = dict(self.elections)
        out["refused"] = dict(out["refused"])
        out["tick_age_s"] = round(time.monotonic() - self._last_tick, 3)
        free = self.lock.acquire(blocking=False)
        if free:
            self.lock.release()
        out["lock_held"] = not free
        return out


class NotLeader(ReplicationError):
    def __init__(self, leader_id):
        super().__init__("not leader", leader=leader_id)
        self.leader_id = leader_id


class MultiRaft:
    """Registry of raft groups in one process (reference multi_raft.rs)."""

    def __init__(self):
        self.groups: dict[str, RaftNode] = {}
        self.lock = lockwatch.Lock("raft.multi")

    def add(self, node: RaftNode):
        with self.lock:
            self.groups[node.group_id] = node

    def get(self, group_id: str) -> RaftNode | None:
        return self.groups.get(group_id)

    def remove(self, node: RaftNode):
        with self.lock:
            if self.groups.get(node.group_id) is node:
                del self.groups[node.group_id]

    def stop_all(self):
        with self.lock:
            for n in self.groups.values():
                n.stop()
