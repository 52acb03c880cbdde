"""Read-your-writes through a node that does not lead, on real raft.

A scan of a replicated group goes to the group's live raft leader: the
leader applies an entry before it acknowledges the write, so its replica
holds every acknowledged row. Meta's static leader (`leader_vnode_id`)
is only where the group was placed; after an election it may be a
follower that has not applied the tail of the log. The planner used to
follow the live leader only on the node whose own member led, and every
other node read the static leader, so a read through a third node could
miss rows the cluster had acknowledged. Each node that holds a member
of the group now follows the leader that member sees. A node with no
member of the group has no view of its leader: its scan is a leader
read, which a member that does not lead answers with a redirect to the
leader it follows (or, while the group elects, with no hint: the read
backs off and asks again).

The clusters here are in-process: every node its own engine,
Coordinator, node RPC service on 127.0.0.1 and raft replica manager
over one MetaStore, so raft's messages and the scans cross the real
wire. A node's raft traffic is held back by the `rpc.send` fault point
armed for its address and the `raft_msg` method alone, so that its
scans still answer. The rows come from a numpy seed. The reference
keeps the static routing (it is not changed), so the tests hold the
port to the guarantee itself.
"""
import itertools
import os
import threading
import time

import numpy as np
import pytest

from cnosdb_tpu_torch import faults
from cnosdb_tpu_torch.errors import (CoordinatorError, DeadlineExceeded,
                                     ReplicationError)
from cnosdb_tpu_torch.models.meta_data import VnodeStatus
from cnosdb_tpu_torch.models.points import SeriesRows, WriteBatch
from cnosdb_tpu_torch.models.predicate import ColumnDomains, TimeRanges
from cnosdb_tpu_torch.models.schema import (DatabaseOptions, DatabaseSchema,
                                            TskvTableSchema, ValueType)
from cnosdb_tpu_torch.models.series import SeriesKey
from cnosdb_tpu_torch.parallel import health
from cnosdb_tpu_torch.parallel.coordinator import Coordinator, PlacedSplit
from cnosdb_tpu_torch.parallel.meta import DEFAULT_TENANT, MetaStore
from cnosdb_tpu_torch.parallel.node_service import DataNodeService
from cnosdb_tpu_torch.storage.engine import TsKv
from cnosdb_tpu_torch.utils import deadline as deadline_mod

SEED = 11
DB = "ryw"
OWNER = f"{DEFAULT_TENANT}.{DB}"
TABLE = "cpu"
HOSTS = [f"h{i}" for i in range(8)]
ROWS = 20            # points a host in each write
WAIT_S = 20.0        # elections, catch-up and plans settling, loaded host
# a write raft did not commit before a leadership change, or not within
# its propose timeout while the group elected (not acked either way)
UNACKED = ("entry superseded after leadership change", "propose timeout",
           "no reachable leader for replica set")
_QIDS = itertools.count()


class RaftCluster:
    def __init__(self, root: str, n_nodes: int, shards: int):
        self.meta = MetaStore(os.path.join(root, "meta.json"))
        self.coords: dict[int, Coordinator] = {}
        self.services: dict[int, DataNodeService] = {}
        for nid in range(1, n_nodes + 1):
            engine = TsKv(os.path.join(root, f"node{nid}"),
                          background_compaction=False)
            coord = Coordinator(self.meta, engine, node_id=nid)
            # placement names other nodes' vnodes: reach them over RPC
            coord.distributed = True
            svc = DataNodeService(coord).start()
            self.meta.register_node(nid, grpc_addr=svc.addr)
            self.coords[nid], self.services[nid] = coord, svc
        self.meta.create_database(DatabaseSchema(
            DEFAULT_TENANT, DB, DatabaseOptions(shard_num=shards,
                                                replica=3)))
        self.meta.create_table(TskvTableSchema.new_measurement(
            DEFAULT_TENANT, DB, TABLE, tags=["host"],
            fields=[("v", ValueType.FLOAT)]))
        self.rng = np.random.default_rng(SEED)
        self.acked: dict = {}
        self.next_ts = 1_000_000
        # the bucket every write lands in, and its replica sets
        self.meta.locate_bucket_for_write(DEFAULT_TENANT, DB, self.next_ts)

    def write(self, nid: int) -> dict:
        """ROWS new points a host, written through node `nid`'s
        coordinator; they join `acked` once the write returns → the
        rows written. A write that raft did not commit, elections under
        way on a loaded host, was not acked: it is sent again, as a
        client does (rewriting the same points is idempotent)."""
        ts = [self.next_ts + i for i in range(ROWS)]
        self.next_ts += ROWS
        wb, rows = WriteBatch(), {}
        for h in HOSTS:
            v = self.rng.standard_normal(ROWS)
            wb.add_series(TABLE, SeriesRows(
                SeriesKey(TABLE, {"host": h}), ts,
                {"v": (int(ValueType.FLOAT), v.tolist())}))
            rows.update({(h, t): x for t, x in zip(ts, v)})
        deadline = time.monotonic() + WAIT_S
        while True:
            try:
                self.coords[nid].write_points(DEFAULT_TENANT, DB, wb)
                break
            except (ReplicationError, CoordinatorError) as e:
                if not any(m in str(e) for m in UNACKED) \
                        or time.monotonic() > deadline:
                    raise
        self.acked.update(rows)
        return rows

    def groups(self) -> list:
        return [rs for b in self.meta.buckets_for(DEFAULT_TENANT, DB)
                for rs in b.shard_group]

    def addr(self, nid: int) -> str:
        return self.services[nid].addr

    def member(self, nid: int, rs):
        """Node `nid`'s raft member of the group, or None."""
        mgr = self.coords[nid]._replica_mgr
        vids = [v.id for v in rs.vnodes if v.node_id == nid]
        if mgr is None or not vids:
            return None
        return mgr.transport.nodes.get((f"{OWNER}/{rs.id}", vids[0]))

    def members(self, rs) -> dict:
        return {v.node_id: self.member(v.node_id, rs) for v in rs.vnodes}

    def wait(self, what: str, cond) -> None:
        deadline = time.monotonic() + WAIT_S
        while not cond():
            if time.monotonic() > deadline:
                raise AssertionError(f"not within {WAIT_S} s: {what}")
            time.sleep(0.02)

    def leader_node(self, rs) -> int | None:
        led = [nid for nid, m in self.members(rs).items()
               if m is not None and m.is_leader()]
        return led[0] if len(led) == 1 else None

    def wait_caught_up(self, rs) -> None:
        """Until one member leads and every member has applied the
        leader's whole log."""
        def done():
            lead = self.leader_node(rs)
            if lead is None:
                return False
            last = self.member(lead, rs).log.last_index()
            return all(m is not None and m.last_applied == last
                       for m in self.members(rs).values())
        self.wait(f"group {rs.id} caught up", done)

    def led_off(self, rs, away: int) -> int | None:
        """The node whose member leads the group, if one does and it is
        not `away`; a member on `away` that leads steps down (on a loaded
        host raft may elect it again at any time)."""
        lead = self.leader_node(rs)
        if lead == away:
            self.member(away, rs).stepdown()
            return None
        return lead

    def lead_off(self, rs, away: int) -> int:
        """Leadership of the group on a node other than `away`, with
        every member following it → the leader's node."""
        led = []

        def settled():
            lead = self.led_off(rs, away)
            if lead is None:
                return False
            lvid = self.member(lead, rs).node_id
            led[:] = [lead]
            return all(m.leader_id == lvid
                       for nid, m in self.members(rs).items() if nid != lead)
        self.wait(f"group {rs.id} led off node {away}, every member "
                  "following", settled)
        return led[0]

    def scan(self, nid: int) -> dict:
        """Node `nid`'s scan of the table → {(host, ts): v}."""
        dl = deadline_mod.Deadline(30.0, qid=f"ryw-{next(_QIDS)}")
        with deadline_mod.scope(dl):
            batches = self.coords[nid].scan_table(DEFAULT_TENANT, DB, TABLE,
                                                  field_names=["v"])
        return _rows(batches)

    def replica_rows(self, reader: int, rs, nid: int) -> dict:
        """The rows node `nid`'s replica of the group holds, read by
        node `reader` over the wire."""
        (vid,) = [v.id for v in rs.vnodes if v.node_id == nid]
        dl = deadline_mod.Deadline(30.0, qid=f"ryw-{next(_QIDS)}")
        with deadline_mod.scope(dl):
            b = self.coords[reader]._scan_remote(PlacedSplit(
                OWNER, vid, TABLE, TimeRanges.all(), ColumnDomains.all(),
                node_id=nid), ["v"])
        return _rows([b] if b is not None else [])

    def routes(self, nid: int) -> dict:
        """Node `nid`'s plan: {replica set: (vnode read, its node)}."""
        by_vnode = {v.id: rs.id for rs in self.groups() for v in rs.vnodes}
        return {by_vnode[s.vnode_id]: (s.vnode_id, s.node_id)
                for s in self.coords[nid].table_vnodes(
                    DEFAULT_TENANT, DB, TABLE, TimeRanges.all(),
                    ColumnDomains.all())}

    def plans_follow(self, rs, away: int) -> bool:
        """Whether one member leads the group, off node `away`, and every
        node plans its read of the group there."""
        lead = self.led_off(rs, away)
        if lead is None:
            return False
        live = (self.member(lead, rs).node_id, lead)
        return all(self.routes(nid)[rs.id] == live for nid in self.coords)

    def close(self):
        for nid, c in self.coords.items():
            self.services[nid].stop()
            c.close()


def _rows(batches) -> dict:
    out = {}
    for b in batches:
        _, vals, valid = b.fields["v"]
        assert valid.all()
        for i in range(b.n_rows):
            host = b.series_keys[b.sid_ordinal[i]].tag_value("host")
            out[(host, int(b.ts[i]))] = float(vals[i])
    return out


def _assert_rows(got: dict, want: dict) -> None:
    missing = sorted(want.keys() - got.keys())
    assert not missing, f"{len(missing)} acked rows missing, {missing[:3]}"
    assert got.keys() == want.keys()
    np.testing.assert_array_equal([got[k] for k in sorted(want)],
                                  [want[k] for k in sorted(want)])


def _hold_raft_to(addr: str) -> None:
    """Raft messages sent to `addr` fail; its scans still answer."""
    faults.configure(f"seed={SEED};rpc.send:fail:if={addr} raft_msg")


@pytest.fixture(autouse=True)
def _clean_plane(monkeypatch):
    # the nodes' scans run on the host here
    monkeypatch.setenv("CNOSDB_TORCH_PLACEMENT", "cpu")
    faults.reset()
    health.SCORER.reset()
    yield
    faults.reset()
    health.SCORER.reset()


@pytest.fixture(params=["hedged", "solo"])
def path(request, monkeypatch):
    """The scan's failover lane: health-ranked and hedged (the default)
    or the fixed-order loop (CNOSDB_HEDGE=0). The hedge delay's floor is
    raised past any scan here, so that the planner's choice alone
    decides which replica answers."""
    monkeypatch.setenv("CNOSDB_HEDGE", "0" if request.param == "solo"
                       else "1")
    monkeypatch.setattr(health, "HEDGE_DELAY_FLOOR_MS", 30_000.0)
    return request.param


@pytest.fixture
def cluster3(tmp_path):
    c = RaftCluster(str(tmp_path), n_nodes=3, shards=1)
    yield c
    c.close()


@pytest.fixture
def cluster4(tmp_path):
    c = RaftCluster(str(tmp_path), n_nodes=4, shards=4)
    yield c
    c.close()


def test_node_that_does_not_lead_reads_what_the_live_leader_acked(
        cluster3, path):
    """Leadership moves off meta's static leader S, S's raft traffic is
    held back, and writes are acknowledged by the new leader L with the
    third node T. One read through T, with no wait, returns every
    acknowledged row, while S's own replica still lacks them."""
    c = cluster3
    (g,) = c.groups()
    s_node = g.leader_node_id
    c.write(s_node)
    c.wait_caught_up(g)
    l_node = c.lead_off(g, s_node)
    (t_node,) = set(c.coords) - {s_node, l_node}
    l_vid = c.member(l_node, g).node_id

    _hold_raft_to(c.addr(s_node))
    try:
        late = c.write(l_node)
        lead, static = c.member(l_node, g), c.member(s_node, g)
        lag = lead.last_applied - static.last_applied
        got = c.scan(t_node)
        route = c.routes(t_node)
        held = c.replica_rows(t_node, g, s_node)
    finally:
        faults.reset()
    assert lag > 0, "the static leader applied every entry: nothing lagged"
    assert late.keys().isdisjoint(held), "S was not held back"
    _assert_rows(got, c.acked)
    assert route == {g.id: (l_vid, l_node)}

    c.wait_caught_up(g)
    for nid in c.coords:
        _assert_rows(c.scan(nid), c.acked)


def test_a_read_at_the_live_leader_is_not_hedged_to_a_follower(
        cluster3, monkeypatch):
    """With every hedge due at once, the read through the third node
    still waits for the live leader: a hedge would read its own or the
    held-back replica, which lack the rows the leader just acked. The
    suppression is booked."""
    monkeypatch.setenv("CNOSDB_HEDGE", "1")
    monkeypatch.setattr(health, "HEDGE_DELAY_FLOOR_MS", 0.0)
    monkeypatch.setattr(health.SCORER, "hedge_delay",
                        lambda *a, **k: 0.0)
    c = cluster3
    (g,) = c.groups()
    s_node = g.leader_node_id
    c.write(s_node)
    c.wait_caught_up(g)
    l_node = c.lead_off(g, s_node)
    (t_node,) = set(c.coords) - {s_node, l_node}
    suppressed = health.counters_snapshot()[0].get(
        ("suppressed", "leader_read"), 0)
    _hold_raft_to(c.addr(s_node))
    try:
        c.write(l_node)
        got = c.scan(t_node)
    finally:
        faults.reset()
    _assert_rows(got, c.acked)
    hedge = health.counters_snapshot()[0]
    assert hedge.get(("suppressed", "leader_read"), 0) > suppressed


def test_every_member_node_follows_the_live_leader(cluster3, path):
    """With leadership off meta's static leader, each node holding a
    member of the group plans its read at the live leader, its own
    member or not; once the leader changes again, the plans follow.
    (The plans are read until they settle: on a loaded host raft may
    elect again between two reads.)"""
    c = cluster3
    (g,) = c.groups()
    s_node = g.leader_node_id
    c.write(s_node)
    c.wait_caught_up(g)
    l_node = c.lead_off(g, s_node)
    c.wait("every node plans its read at the live leader",
           lambda: c.plans_follow(g, away=s_node))
    c.write(s_node)
    c.wait_caught_up(g)
    for nid in c.coords:
        _assert_rows(c.scan(nid), c.acked)

    c.lead_off(g, l_node)
    c.wait("the plans follow the next leader",
           lambda: c.plans_follow(g, away=l_node))


def _outsider(c):
    """A group of the cluster and a node that holds no member of it."""
    return next((rs, nid) for rs in c.groups() for nid in c.coords
                if all(v.node_id != nid for v in rs.vnodes))


def _leader_reads() -> dict:
    return health.leader_read_counters()


def test_node_with_no_member_reads_what_the_live_leader_acked(cluster4,
                                                               path):
    """A node that holds no member of a group has no view of its raft
    leader: its scan asks meta's static leader S for a leader read, and
    S, which no longer leads, redirects it to the live leader L. With
    S's raft traffic held back and rows acked by L, one read through the
    outsider, with no wait, returns every acknowledged row while S's own
    replica lacks them; the redirect is booked. The outsider's next plan
    starts at L, the leader it learned."""
    c = cluster4
    g, outsider = _outsider(c)
    s_node = g.leader_node_id
    c.write(s_node)
    for rs in c.groups():
        c.wait_caught_up(rs)
    l_node = c.lead_off(g, s_node)
    l_vid = c.member(l_node, g).node_id
    assert c.routes(outsider)[g.id] == (g.leader_vnode_id, s_node)
    redirects = _leader_reads().get("redirect", 0)

    _hold_raft_to(c.addr(s_node))
    try:
        late = c.write(l_node)
        lead, static = c.member(l_node, g), c.member(s_node, g)
        lag = lead.last_applied - static.last_applied
        got = c.scan(outsider)
        held = c.replica_rows(l_node, g, s_node)
    finally:
        faults.reset()
    assert lag > 0, "the static leader applied every entry: nothing lagged"
    assert late.keys().isdisjoint(held), "S was not held back"
    _assert_rows(got, c.acked)
    assert _leader_reads().get("redirect", 0) > redirects
    assert c.routes(outsider)[g.id] == (l_vid, l_node)


@pytest.mark.parametrize("leader", ["elected", "never"])
def test_a_leader_read_waits_out_an_election(cluster4, leader):
    """The outsider's read starts at the member that led last, which has
    stepped down while every member's raft traffic is held back: it
    answers not-leader with no hint. The read backs off and asks again;
    once the hold lifts and a leader is elected, it is redirected there
    and answers every acked row. While no leader appears, the read
    fails within its deadline instead of reading a replica."""
    c = cluster4
    g, outsider = _outsider(c)
    c.write(g.leader_node_id)
    for rs in c.groups():
        c.wait_caught_up(rs)
    c.scan(outsider)                  # learns the group's leader
    # no member hears another, so none is elected: the leader steps down
    faults.configure(f"seed={SEED};" + ";".join(
        f"rpc.send:fail:if={c.addr(v.node_id)} raft_msg" for v in g.vnodes))
    c.wait("a leader", lambda: c.leader_node(g) is not None)
    c.member(c.leader_node(g), g).stepdown()
    waits = _leader_reads().get("no_leader", 0)
    if leader == "elected":
        threading.Timer(0.5, faults.reset).start()
        t0 = time.monotonic()
        got = c.scan(outsider)
        assert time.monotonic() - t0 < WAIT_S
        _assert_rows(got, c.acked)
    else:
        dl = deadline_mod.Deadline(1.5, qid=f"ryw-{next(_QIDS)}")
        t0 = time.monotonic()
        with pytest.raises((CoordinatorError, DeadlineExceeded)):
            with deadline_mod.scope(dl):
                c.coords[outsider].scan_table(DEFAULT_TENANT, DB, TABLE,
                                              field_names=["v"])
        assert time.monotonic() - t0 < 1.5 + 1.0
        faults.reset()
    assert _leader_reads().get("no_leader", 0) > waits


def test_an_outsiders_leader_read_is_not_hedged(cluster4, monkeypatch):
    """With every hedge due at once, the outsider's leader read still
    waits for the leader: a hedge would read a follower, the held-back
    static leader among them. The suppression is booked and no hedge
    fires."""
    monkeypatch.setenv("CNOSDB_HEDGE", "1")
    monkeypatch.setattr(health, "HEDGE_DELAY_FLOOR_MS", 0.0)
    monkeypatch.setattr(health.SCORER, "hedge_delay",
                        lambda *a, **k: 0.0)
    c = cluster4
    g, outsider = _outsider(c)
    s_node = g.leader_node_id
    c.write(s_node)
    for rs in c.groups():
        c.wait_caught_up(rs)
    l_node = c.lead_off(g, s_node)
    before = health.counters_snapshot()[0]
    _hold_raft_to(c.addr(s_node))
    try:
        c.write(l_node)
        got = c.scan(outsider)
    finally:
        faults.reset()
    _assert_rows(got, c.acked)
    after = health.counters_snapshot()[0]
    key = ("suppressed", "leader_read")
    assert after.get(key, 0) > before.get(key, 0)
    assert after.get(("fired", ""), 0) == before.get(("fired", ""), 0)


def _read_index() -> dict:
    return health.read_index_counters()


class _Cut:
    """A raft member's transport with every send lost."""

    def send(self, group_id, to, msg):
        return None


def test_a_deposed_leaders_node_reads_what_the_new_leader_acked(cluster3,
                                                                 path):
    """The leader S's raft is cut both ways (its member's sends are lost,
    and raft messages to its node fail; its scans still answer). The
    other two elect L and ack rows; S keeps its role, as no higher term
    reaches it, and its replica lacks them. One read through S, with no
    wait, returns every acked row: S's read index refuses (booked as
    not_leader), and the read goes to the other members as a leader
    read."""
    c = cluster3
    (g,) = c.groups()
    c.write(g.leader_node_id)
    c.wait_caught_up(g)
    s_node = c.leader_node(g)
    s = c.member(s_node, g)
    inner = s.transport
    refused = _read_index().get("not_leader", 0)
    s.transport = _Cut()
    _hold_raft_to(c.addr(s_node))
    try:
        c.wait("the other two elect a leader", lambda: any(
            m.is_leader() for nid, m in c.members(g).items()
            if nid != s_node))
        (l_node,) = [nid for nid, m in c.members(g).items()
                     if nid != s_node and m.is_leader()]
        late = c.write(l_node)
        deposed = s.is_leader()
        got = c.scan(s_node)
        held = c.replica_rows(l_node, g, s_node)
    finally:
        faults.reset()
        s.transport = inner
    assert deposed, "S lost its role: no deposed leader was read"
    assert late.keys().isdisjoint(held), "S was not cut off"
    _assert_rows(got, c.acked)
    assert _read_index().get("not_leader", 0) > refused


def test_a_cut_off_leaders_node_never_reads_the_replica_that_refused(
        cluster3, monkeypatch):
    """As above, but S is cut off from its peers for scans too once the
    other two acked rows through their new leader. A read through S then
    has no member to confirm it: S's read index refuses, and the other
    members do not answer. The read fails with the leader-read error
    within its deadline; it never answers from S's own replica, which
    lacks the acked rows."""
    from cnosdb_tpu_torch.parallel import coordinator

    monkeypatch.setattr(coordinator, "LEADER_READ_TIMEOUT_S", 1.0)
    c = cluster3
    (g,) = c.groups()
    c.write(g.leader_node_id)
    c.wait_caught_up(g)
    s_node = c.leader_node(g)
    s = c.member(s_node, g)
    inner = s.transport
    refused = _read_index().get("not_leader", 0)
    s.transport = _Cut()
    _hold_raft_to(c.addr(s_node))
    try:
        c.wait("the other two elect a leader", lambda: any(
            m.is_leader() for nid, m in c.members(g).items()
            if nid != s_node))
        (l_node,) = [nid for nid, m in c.members(g).items()
                     if nid != s_node and m.is_leader()]
        c.write(l_node)
        faults.configure(f"seed={SEED};" + ";".join(
            f"rpc.send:fail:if={c.addr(nid)}" for nid in c.coords))
        deposed = s.is_leader()
        t0 = time.monotonic()
        with pytest.raises(CoordinatorError, match="no raft leader"):
            c.scan(s_node)
        took = time.monotonic() - t0
    finally:
        faults.reset()
        s.transport = inner
    assert deposed, "S lost its role: no deposed leader was read"
    assert took < 10.0
    assert _read_index().get("not_leader", 0) > refused


def test_a_member_node_between_leaders_makes_a_leader_read(cluster3,
                                                           monkeypatch):
    """Leadership moves off meta's static leader S to L, S's raft is held
    back and rows are acked, so S's replica lags. Then no member hears
    another and L steps down: L's member knows no leader, so L's node
    plans its read at S. That read is a leader read: with every hedge
    due at once it fires none (a hedge would read a lagging replica),
    backs off while the group elects, and returns every acked row once
    the hold lifts."""
    monkeypatch.setenv("CNOSDB_HEDGE", "1")
    monkeypatch.setattr(health, "HEDGE_DELAY_FLOOR_MS", 0.0)
    monkeypatch.setattr(health.SCORER, "hedge_delay",
                        lambda *a, **k: 0.0)
    c = cluster3
    (g,) = c.groups()
    s_node = g.leader_node_id
    c.write(s_node)
    c.wait_caught_up(g)
    l_node = c.lead_off(g, s_node)
    _hold_raft_to(c.addr(s_node))
    try:
        late = c.write(l_node)
        faults.configure(f"seed={SEED};" + ";".join(
            f"rpc.send:fail:if={c.addr(v.node_id)} raft_msg"
            for v in g.vnodes))
        held = c.replica_rows(l_node, g, s_node)
        c.member(l_node, g).stepdown()
        unknown = c.member(l_node, g).leader_id is None
        (split,) = c.coords[l_node].table_vnodes(
            DEFAULT_TENANT, DB, TABLE, TimeRanges.all(), ColumnDomains.all())
        before = health.counters_snapshot()[0]
        waits = _leader_reads().get("no_leader", 0)
        threading.Timer(0.5, faults.reset).start()
        got = c.scan(l_node)
    finally:
        faults.reset()
    assert unknown, "L's member still named a leader"
    assert late.keys().isdisjoint(held), "S did not lag"
    assert (split.vnode_id, split.node_id) == (g.leader_vnode_id, s_node)
    assert split.leader_read
    _assert_rows(got, c.acked)
    after = health.counters_snapshot()[0]
    assert after.get(("fired", ""), 0) == before.get(("fired", ""), 0)
    key = ("suppressed", "leader_read")
    assert after.get(key, 0) > before.get(key, 0)
    assert _leader_reads().get("no_leader", 0) > waits


@pytest.mark.parametrize("flag", [False, True])
def test_a_scan_without_the_flag_is_served_where_it_lands(cluster3, flag):
    """The scan RPC at a member that does not lead: without the
    `leader_read` flag it scans that replica, as before; with it, it
    answers not-leader with the leader's vnode as its hint. At the
    leader both scan."""
    c = cluster3
    (g,) = c.groups()
    c.write(g.leader_node_id)
    c.wait_caught_up(g)
    lead = c.leader_node(g)
    l_vid = c.member(lead, g).node_id
    (f_node,) = [n for n in c.coords if n != lead][:1]
    f_vid = c.member(f_node, g).node_id

    def scan(nid, vid):
        p = {"owner": OWNER, "vnode_id": vid, "table": TABLE,
             "trs": TimeRanges.all().to_wire(),
             "doms": ColumnDomains.all().to_wire(), "field_names": ["v"]}
        if flag:
            p["leader_read"] = True
        return c.services[nid]._scan_vnode(p)

    at_follower = scan(f_node, f_vid)
    if flag:
        assert at_follower == {"ok": False, "not_leader": True,
                               "hint": l_vid}
    else:
        assert at_follower["ipc"] is not None
    assert scan(lead, l_vid)["ipc"] is not None


class _Hint:
    """A replica manager whose only view is a leader hint."""

    def __init__(self, hint):
        self.hint = hint

    def current_leader_vnode(self, owner, rs):
        return None

    def leader_hint(self, owner, rs):
        return self.hint


@pytest.mark.parametrize("case", ["unknown", "copying"])
def test_a_hint_outside_the_running_set_keeps_the_static_leader(
        cluster3, case):
    """A hint naming no vnode of the set (a removed replica) or a
    COPYING replica (no data yet) is not followed."""
    c = cluster3
    (g,) = c.groups()
    other = next(v for v in g.vnodes if v.id != g.leader_vnode_id)
    if case == "copying":
        c.meta.update_vnode(other.id, status=int(VnodeStatus.COPYING))
        hint = other.id
    else:
        hint = max(v.id for v in g.vnodes) + 100
    for nid, coord in c.coords.items():
        coord._replica_mgr = _Hint(hint)
        assert c.routes(nid)[g.id] == (g.leader_vnode_id, g.leader_node_id)
        coord._replica_mgr = None
