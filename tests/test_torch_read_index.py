"""The read index of the port's raft (`RaftNode.read_index`).

A read served as a group's leader is linearizable only if the member
still leads and has applied every entry the group committed before the
read arrived. Two members could serve without that:

- a new leader learns the commit index only when an entry of its own
  term commits, so an entry its predecessor acknowledged can sit in its
  log, not yet in its state machine;
- a leader cut off from its peers keeps its role until it hears a higher
  term, while the others elect a new leader and acknowledge writes.

`read_index` closes both, as the raft thesis's read index (§6.4) and
openraft's ensure_linearizable do: the leader waits for its own-term
entry to commit, reads its commit index, confirms that it still leads
with an append round a majority answers, and returns once it has
applied that index; otherwise it raises NotLeader. The groups here are
three members on the in-process transport with no ticker, so each
election and append round is driven by the test, and a test-side
wrapper of each member's transport drops chosen messages. The entries
come from a numpy seed. The JAX package has no read index (its raft
reads at the leader's state machine), so the tests hold the port to the
guarantee itself.
"""
import threading
import time

import msgpack
import numpy as np
import pytest

from cnosdb_tpu_torch.parallel import health
from cnosdb_tpu_torch.parallel.raft import (InProcessTransport,
                                            MemoryLogStore, NotLeader,
                                            RaftNode, StateMachine)

SEED = 15
DATA = 1             # entry type of a write (any type but BLANK/MEMBERSHIP)


class Rows(StateMachine):
    """A key-value state machine: each entry is one (key, value) pair."""

    def __init__(self):
        self.rows = {}

    def apply(self, entry):
        k, v = msgpack.unpackb(entry.data)
        self.rows[k] = v

    def snapshot(self):
        return msgpack.packb(self.rows)

    def install_snapshot(self, data, last_index, last_term):
        self.rows = dict(msgpack.unpackb(data, strict_map_key=False))


class Link:
    """One member's sends, with the messages `drop(to, msg)` names lost."""

    def __init__(self, net: InProcessTransport):
        self.net = net
        self.drop = lambda to, msg: False

    def send(self, group_id, to, msg):
        if self.drop(to, msg):
            return None
        return self.net.send(group_id, to, msg)


class Group:
    def __init__(self, n: int = 3):
        self.net = InProcessTransport()
        self.nodes = {}
        self.links = {}
        for i in range(1, n + 1):
            node = RaftNode("g", i, list(range(1, n + 1)), MemoryLogStore(),
                            Rows(), self.net, tick=False)
            self.links[i] = node.transport = Link(self.net)
            self.nodes[i] = node
        self.rng = np.random.default_rng(SEED)

    def elect(self, i: int) -> RaftNode:
        node = self.nodes[i]
        node._start_election()
        assert node.is_leader(), f"member {i} was not elected"
        return node

    def entry(self) -> tuple[int, float]:
        k = int(self.rng.integers(1 << 30))
        return k, float(self.rng.standard_normal())

    def write(self, i: int) -> tuple[int, float]:
        k, v = self.entry()
        self.nodes[i].propose(DATA, msgpack.packb([k, v]), timeout=2.0)
        return k, v

    def stop(self):
        for n in self.nodes.values():
            n.stop()


def _appends(msg) -> bool:
    return msg["type"] == "append_entries"


def _read_index() -> dict:
    return health.read_index_counters()


@pytest.fixture
def group():
    g = Group()
    yield g
    g.stop()


def test_a_new_leader_serves_only_once_it_applied_what_was_acked(group):
    """Member 1 leads; member 2 stores an entry, 1 commits it and
    acknowledges the write, and every append that would tell 2 or 3 the
    new commit index is lost. 1 fails; 2 is elected and its own blank
    entry cannot commit (its appends are lost). 2 leads while its state
    machine lacks the acknowledged entry: a read served at its state
    machine then misses it. Its read index returns no index until the
    blank commits, and then only once the entry is applied."""
    g = group
    n1 = g.elect(1)
    n1._broadcast_append()                  # every member has the blank
    # 3 hears nothing more from 1; 2 hears the entry, not its commit
    committed = [n1.commit_index]
    g.links[1].drop = lambda to, msg: _appends(msg) and (
        to == 3 or msg["leader_commit"] > committed[0])
    k, v = g.write(1)
    idx = n1.last_applied
    assert n1.sm.rows == {k: v}
    n2, n3 = g.nodes[2], g.nodes[3]
    assert n2.log.last_index() == idx and n2.commit_index < idx
    assert n3.log.last_index() < idx

    n1.crash()
    time.sleep(n1.election_timeout[1])      # 3 no longer hears 1
    g.links[2].drop = lambda to, msg: _appends(msg)
    g.elect(2)
    assert n2.is_leader() and k not in n2.sm.rows

    before = _read_index()
    got = []

    def read():
        try:
            got.append(n2.read_index(0.3))
        except NotLeader as e:
            got.append(e)

    t = threading.Thread(target=read)
    t.start()
    t.join(5.0)
    assert len(got) == 1 and isinstance(got[0], NotLeader), \
        f"a read index while the blank cannot commit: {got}"
    assert k not in n2.sm.rows

    g.links[2].drop = lambda to, msg: False
    at = n2.read_index(5.0)
    assert at >= idx + 1            # the predecessor's entry, the blank
    assert n2.last_applied >= at and n2.sm.rows == {k: v}
    after = _read_index()
    for key in ("not_leader", "confirmed", "apply_waits"):
        assert after.get(key, 0) > before.get(key, 0), (key, before, after)


def test_a_deposed_leader_cut_off_from_raft_does_not_confirm(group):
    """Member 1 leads and its raft is cut both ways (its sends and the
    sends to it are lost). 2 and 3 elect 2 and acknowledge a write; 1
    still holds its role, without the write. Its read index raises
    NotLeader at once (its round reaches no peer) instead of
    confirming; 2's read index returns with the write applied."""
    g = group
    n1 = g.elect(1)
    n1._broadcast_append()
    g.write(1)
    g.links[1].drop = lambda to, msg: True
    for i in (2, 3):
        g.links[i].drop = lambda to, msg: to == 1
    time.sleep(n1.election_timeout[1])      # 3 no longer hears 1
    n2 = g.elect(2)
    n2._broadcast_append()
    k, v = g.write(2)
    assert n1.is_leader() and k not in n1.sm.rows

    t0 = time.monotonic()
    with pytest.raises(NotLeader) as e:
        n1.read_index(5.0)
    assert time.monotonic() - t0 < 2.0
    assert e.value.leader_id is None
    assert n2.sm.rows[k] == v and n2.read_index(5.0) >= n2.log.last_index()


def test_a_deposed_leader_that_hears_the_new_term_names_its_leader(group):
    """Once 1 hears 2's append at the higher term, it follows 2: a read
    that asks it as the leader (`follow=False`, the scan RPC's
    `leader_read`) refuses with 2 as the hint, and so does a follower's
    read-index request sent to it."""
    g = group
    n1 = g.elect(1)
    n1._broadcast_append()
    g.links[1].drop = lambda to, msg: True
    time.sleep(n1.election_timeout[1])
    n2 = g.elect(2)
    g.links[1].drop = lambda to, msg: False
    n2._broadcast_append()
    assert not n1.is_leader() and n1.leader_id == 2
    with pytest.raises(NotLeader) as e:
        n1.read_index(1.0, follow=False)
    assert e.value.leader_id == 2
    reply = n1.handle_message({"type": "read_index", "from": 3,
                               "term": n1.term, "timeout": 1.0})
    assert reply["index"] is None and reply["hint"] == 2


def test_concurrent_reads_share_a_round(group):
    """Reads that arrive before any send has carried the newest append
    broadcast share it, and a peer has one send in flight: eight
    concurrent reads over a slow link cause at most two sends to each
    peer, and ask for at most three broadcasts (the first, and one after
    each peer's sender took it), and every one returns an index the
    leader has applied."""
    g = group
    n1 = g.elect(1)
    n1._broadcast_append()
    g.write(1)
    slow = g.links[1]
    sends = []

    def send(group_id, to, msg, _send=Link.send):
        sends.append(to)
        time.sleep(0.3)
        return _send(slow, group_id, to, msg)
    slow.send = send
    before = _read_index()
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        n1.read_index(5.0))) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
    assert len(got) == 8 and all(i <= n1.last_applied for i in got)
    rounds = _read_index().get("rounds", 0) - before.get("rounds", 0)
    assert 1 <= rounds <= 3
    time.sleep(0.5)                 # the senders' last sends return
    assert sends.count(2) <= 2 and sends.count(3) <= 2, sends


def test_a_peer_that_needs_a_snapshot_gets_one_however_many_reads(group):
    """Member 1 purged its log, so its append to a lagging member 3
    becomes a snapshot, and 3 takes half a second to install it.
    Sixteen reads, eight one after another and eight at once, confirm
    with member 2 meanwhile: 3 gets one snapshot and one send in flight
    at a time, not a send per read, and then catches up."""
    g = group
    n1 = g.elect(1)
    n1._broadcast_append()
    for _ in range(4):
        g.write(1)
    last = n1.log.last_index()
    for i in range(1, last):        # 1's log purged below its last entry
        del n1.log.entries[i]
    n1.next_index[3] = 2            # 3 needs the purged entries
    link = g.links[1]
    snapshots = []
    flight = {"now": 0, "most": 0}
    flight_lock = threading.Lock()

    def send(group_id, to, msg, _send=Link.send):
        if to != 3:
            return _send(link, group_id, to, msg)
        with flight_lock:
            flight["now"] += 1
            flight["most"] = max(flight["most"], flight["now"])
        try:
            if msg["type"] == "install_snapshot":
                snapshots.append(msg["last_index"])
                time.sleep(0.5)
            return _send(link, group_id, to, msg)
        finally:
            with flight_lock:
                flight["now"] -= 1
    link.send = send

    got = [n1.read_index(5.0) for _ in range(8)]
    threads = [threading.Thread(target=lambda: got.append(
        n1.read_index(5.0))) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
    assert len(got) == 16 and all(i <= n1.last_applied for i in got)
    deadline = time.monotonic() + 5.0
    while n1.match_index.get(3, 0) < last and time.monotonic() < deadline:
        n1._broadcast_append()
    assert n1.match_index[3] >= last
    assert g.nodes[3].sm.rows == n1.sm.rows
    assert len(snapshots) == 1 and flight["most"] == 1, (snapshots, flight)


def test_a_follower_refuses_with_the_leader_it_follows(group):
    """A follower asked as the leader (`follow=False`) refuses with the
    leader it follows as the hint, and so does its follower read index
    when that leader does not answer the request."""
    g = group
    n1 = g.elect(1)
    n1._broadcast_append()
    with pytest.raises(NotLeader) as e:
        g.nodes[3].read_index(1.0, follow=False)
    assert e.value.leader_id == 1
    g.links[3].drop = lambda to, msg: msg["type"] == "read_index"
    with pytest.raises(NotLeader) as e:
        g.nodes[3].read_index(1.0)
    assert e.value.leader_id == 1
