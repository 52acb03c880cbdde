"""Which replica a scan reads, on the port's copied coordinator.

A scan whose RPC to a replica failed used to write BROKEN for that
replica into meta. Meta is the cluster's shared catalog, so one node's
failed reach (a partition, a fault, a peer down for a restart) made
every node shun the replica; the planner routed around it even where
it was the live raft leader, and nothing cleared the mark once the
fault healed, since a marked replica is tried only after every other.
Reachability now lives in each node's own health scorer only, which
orders that node's failover; meta's BROKEN stays for replicas whose
data is suspect (quarantine on read, the scrubber), and only the
anti-entropy repair clears it.

The clusters here are in-process: every node its own engine,
Coordinator and node RPC service (the real wire, on 127.0.0.1) over one
MetaStore. Faults are the `rpc.send` fault point, armed only while the
node under test scans. The data comes from a numpy seed. The reference
keeps the sticky marks (it is not changed), so the tests hold the port
to the routing guarantees themselves.
"""
import itertools
import os

import numpy as np
import pytest

from cnosdb_tpu_torch import faults
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
from cnosdb_tpu_torch.parallel.raft import NotLeader
from cnosdb_tpu_torch.storage.engine import TsKv
from cnosdb_tpu_torch.utils import deadline as deadline_mod

SEED = 10
DB = "rt"
OWNER = f"{DEFAULT_TENANT}.{DB}"
TABLE = "cpu"
HOSTS = [f"h{i}" for i in range(8)]
ROWS = 40            # points a host
T0 = 1_000_000
# scans of every node after the heal: a mark must be gone within these
SCANS_AFTER_HEAL = 3
# query ids unique in the process: the nodes share its cancel tombstones
_QIDS = itertools.count()


class Leaders:
    """Raft leadership as each node's replica manager reports it: the
    node whose member leads a group sees it as its own
    (ReplicaGroupManager.current_leader_vnode), every other node holding
    a member of the group follows it (leader_hint), and a node with no
    member of the group has no view of it."""

    def __init__(self, node_id: int, shared: dict):
        self.node_id, self.shared = node_id, shared

    def current_leader_vnode(self, owner, rs):
        vid = self.shared.get((owner, rs.id))
        v = rs.vnode(vid) if vid is not None else None
        return vid if v is not None and v.node_id == self.node_id else None

    def leader_hint(self, owner, rs):
        if all(v.node_id != self.node_id for v in rs.vnodes):
            return None
        return self.shared.get((owner, rs.id))

    def get_or_build(self, owner, rs) -> dict:
        """The node's members of the group, as a read sees them."""
        return {v.id: _Member(self, owner, rs, v.id) for v in rs.vnodes
                if v.node_id == self.node_id}

    def stepdown_local(self, owner, rs, vnode_id) -> bool:
        """The member yields, and the group elects the next of its other
        members, as raft would."""
        if self.current_leader_vnode(owner, rs) != vnode_id:
            return False
        self.shared[(owner, rs.id)] = next(
            v.id for v in rs.vnodes if v.id != vnode_id)
        return True

    def invalidate(self, owner, rs_id):
        pass

    def stop(self):
        pass


class _Member:
    """A raft member as a read sees it: its read index confirms a read
    where it leads, and, as the follower read index, where it follows a
    leader; it names the leader otherwise."""

    def __init__(self, leaders: Leaders, owner, rs, vnode_id: int):
        self.lead = leaders.shared.get((owner, rs.id))
        self.vnode_id = vnode_id

    def read_index(self, timeout: float, follow: bool = True) -> int:
        if self.lead is None or (self.lead != self.vnode_id and not follow):
            raise NotLeader(self.lead)
        return 0


class Cluster:
    def __init__(self, root: str, n_nodes: int, shards: int):
        self.meta = MetaStore(os.path.join(root, "meta.json"))
        self.leaders: dict = {}
        self.coords: dict[int, Coordinator] = {}
        self.services: dict[int, DataNodeService] = {}
        for nid in range(1, n_nodes + 1):
            engine = TsKv(os.path.join(root, f"node{nid}"),
                          background_compaction=False)
            coord = Coordinator(self.meta, engine, node_id=nid)
            # placement names other nodes' vnodes: reach them over RPC
            coord.distributed = True
            coord._replica_mgr = Leaders(nid, self.leaders)
            svc = DataNodeService(coord).start()
            self.meta.register_node(nid, grpc_addr=svc.addr)
            self.coords[nid], self.services[nid] = coord, svc
        self.meta.create_database(DatabaseSchema(
            DEFAULT_TENANT, DB, DatabaseOptions(shard_num=shards,
                                                replica=3)))
        self.meta.create_table(TskvTableSchema.new_measurement(
            DEFAULT_TENANT, DB, TABLE, tags=["host"],
            fields=[("v", ValueType.FLOAT)]))
        self.want = self._load(np.random.default_rng(SEED))
        # raft elects a leader in every group: its static one, here (a
        # read of a replicated set is served only where it leads)
        for rs in self.groups():
            self.leaders[(OWNER, rs.id)] = rs.leader_vnode_id

    def _load(self, rng) -> dict:
        """Every host's rows, written into each replica of its group on
        that replica's node → {(host, ts): v}."""
        want = {}
        ts = [T0 + i for i in range(ROWS)]
        bucket = self.meta.locate_bucket_for_write(DEFAULT_TENANT, DB, T0)
        for h in HOSTS:
            v = rng.standard_normal(ROWS)
            key = SeriesKey(TABLE, {"host": h})
            for vn in bucket.vnode_for(key.hash_id()).vnodes:
                wb = WriteBatch()
                wb.add_series(TABLE, SeriesRows(
                    key, ts, {"v": (int(ValueType.FLOAT), v.tolist())}))
                self.coords[vn.node_id].engine.write(OWNER, vn.id, wb)
            want.update({(h, t): x for t, x in zip(ts, v)})
        return want

    def groups(self) -> list:
        return [rs for b in self.meta.buckets_for(DEFAULT_TENANT, DB)
                for rs in b.shard_group]

    def addr(self, nid: int) -> str:
        return self.services[nid].addr

    def scan(self, nid: int) -> dict:
        """Node `nid`'s scan of the table → {(host, ts): v}."""
        out = {}
        dl = deadline_mod.Deadline(30.0, qid=f"scan-{next(_QIDS)}")
        with deadline_mod.scope(dl):
            batches = self.coords[nid].scan_table(DEFAULT_TENANT, DB, TABLE,
                                                  field_names=["v"])
        for b in batches:
            _, vals, valid = b.fields["v"]
            assert valid.all()
            for i in range(b.n_rows):
                host = b.series_keys[b.sid_ordinal[i]].tag_value("host")
                out[(host, int(b.ts[i]))] = float(vals[i])
        return out

    def routes(self) -> dict:
        """Every node's plan: {node: {vnode read: (its node,
        alternates)}}."""
        return {nid: {s.vnode_id: (s.node_id, tuple(s.alternates))
                      for s in c.table_vnodes(DEFAULT_TENANT, DB, TABLE,
                                              TimeRanges.all(),
                                              ColumnDomains.all())}
                for nid, c in self.coords.items()}

    def marks(self) -> set:
        return {v.id for rs in self.groups() for v in rs.vnodes
                if v.status == VnodeStatus.BROKEN}

    def close(self):
        for nid, c in self.coords.items():
            self.services[nid].stop()
            c.close()
            c.engine.close()


@pytest.fixture(autouse=True)
def _clean_plane(monkeypatch):
    # the nodes' scans run on the host here
    monkeypatch.setenv("CNOSDB_TORCH_PLACEMENT", "cpu")
    faults.reset()
    health.SCORER.reset()
    yield
    faults.reset()
    health.SCORER.reset()


@pytest.fixture
def cluster3(tmp_path):
    c = Cluster(str(tmp_path), n_nodes=3, shards=2)
    yield c
    c.close()


@pytest.fixture
def cluster4(tmp_path):
    c = Cluster(str(tmp_path), n_nodes=4, shards=4)
    yield c
    c.close()


def _assert_rows(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    np.testing.assert_array_equal([got[k] for k in sorted(want)],
                                  [want[k] for k in sorted(want)])


def _unreachable(addr: str) -> None:
    faults.configure(f"seed={SEED};rpc.send:fail:if={addr}")


@pytest.fixture(params=["hedged", "solo"])
def path(request, monkeypatch):
    """The scan's failover lane: health-ranked and hedged (the default)
    or the fixed-order loop (CNOSDB_HEDGE=0). The hedge delay's floor is
    raised past any scan here, so that the failover order alone decides
    which replica answers (a hedge that races a slow CPU scan can reach
    a replica the order keeps for last)."""
    monkeypatch.setenv("CNOSDB_HEDGE", "0" if request.param == "solo"
                       else "1")
    monkeypatch.setattr(health, "HEDGE_DELAY_FLOOR_MS", 30_000.0)
    return request.param


def test_failed_reach_leaves_no_mark_and_routing_returns(cluster3, path):
    """(a) Node A fails to reach node B's replica once, then the fault
    heals: within SCANS_AFTER_HEAL scans every node routes each group as
    before the fault (B's own member leads one group, so B reads it
    locally and the others read it from that live leader, which is also
    meta's static leader), and meta holds no BROKEN mark."""
    c = cluster3
    g = c.groups()[0]
    b_node = g.leader_node_id            # meta's static leader of g
    c.leaders[(OWNER, g.id)] = g.leader_vnode_id     # ... leads in raft
    a_node = next(n for n in c.coords if n != b_node)
    before = c.routes()
    assert all(r[g.leader_vnode_id][0] == b_node for r in before.values())
    _assert_rows(c.scan(a_node), c.want)

    _unreachable(c.addr(b_node))
    try:
        rows = c.scan(a_node)
        fired = len(faults.fired_log())
    finally:
        faults.reset()
    _assert_rows(rows, c.want)
    assert fired >= 1, "A never tried B"

    for _ in range(SCANS_AFTER_HEAL):
        for nid in c.coords:
            _assert_rows(c.scan(nid), c.want)
    assert c.marks() == set()
    assert c.routes() == before


def test_unreachable_replica_is_ordered_last_by_the_scorer(cluster4, path):
    """(b) While B is unreachable from A, A answers every row from its
    own or another replica, B's replica is not marked in meta, and A's
    failover order puts B after its healthy peers: the scorer booked
    the failed reach as UNREACHABLE. Four nodes, so that a group with no
    replica on A has two remote alternates to order."""
    c = cluster4
    a_node = 1
    # a group without a replica on A; B is its first alternate in meta
    # order, y the second
    g = next(rs for rs in c.groups()
             if all(v.node_id != a_node for v in rs.vnodes))
    alts = [v for v in g.vnodes if v.id != g.leader_vnode_id]
    b_vnode, y_vnode = alts
    b_node = b_vnode.node_id
    # A reaches B by reading a group that B leads
    assert any(rs.leader_node_id == b_node for rs in c.groups())
    _assert_rows(c.scan(a_node), c.want)

    _unreachable(c.addr(b_node))
    try:
        for _ in range(3):
            _assert_rows(c.scan(a_node), c.want)
        assert c.marks() == set()
    finally:
        faults.reset()
    assert health.SCORER.state(c.addr(b_node)) != health.HEALTHY
    assert health.SCORER.state(c.addr(y_vnode.node_id)) == health.HEALTHY

    (split,) = [s for s in c.coords[a_node].table_vnodes(
        DEFAULT_TENANT, DB, TABLE, TimeRanges.all(), ColumnDomains.all())
        if s.vnode_id == g.leader_vnode_id]
    assert split.alternates == [(b_vnode.id, b_node),
                                (y_vnode.id, y_vnode.node_id)]
    order = c.coords[a_node]._rank_targets(
        [(split.vnode_id, split.node_id)] + split.alternates, split)
    assert order == [(g.leader_vnode_id, g.leader_node_id),
                     (y_vnode.id, y_vnode.node_id), (b_vnode.id, b_node)]


def test_quarantined_replica_stays_marked_until_repair(cluster3, path):
    """(c) A replica quarantined for a checksum mismatch is marked BROKEN,
    and every node routes around it. A scan that reaches it anyway
    succeeds with the rows it has left, and leaves the mark: only the
    anti-entropy repair knows its data is whole again, and clears it."""
    c = cluster3
    g = c.groups()[0]
    x_node, x_vid = g.leader_node_id, g.leader_vnode_id
    c.leaders[(OWNER, g.id)] = x_vid        # X's member leads g in raft
    before = c.routes()
    # X's replica of g seals one corrupt file (flipped inside its pages)
    faults.configure("tsm.write:corrupt(2):nth=1")
    try:
        c.coords[x_node].engine.vnode(OWNER, x_vid).flush()
    finally:
        faults.reset()

    # X's own read hits the damage: quarantine, mark, step down (another
    # member is elected), fail over to a member that confirms the read
    _assert_rows(c.scan(x_node), c.want)
    assert c.marks() == {x_vid}
    assert c.leaders[(OWNER, g.id)] != x_vid
    for nid, r in c.routes().items():
        assert x_vid not in r, f"node {nid} still reads the suspect replica"
        (alts,) = [a for vid, (_, a) in r.items()
                   if x_vid in {t[0] for t in a}]
        assert alts[-1] == (x_vid, x_node)
    for nid in c.coords:
        _assert_rows(c.scan(nid), c.want)

    # a scan that reaches the suspect replica: it answers short, and the
    # mark stays
    a_node = next(n for n in c.coords if n != x_node)
    short = c.coords[a_node]._scan_remote(PlacedSplit(
        OWNER, x_vid, TABLE, TimeRanges.all(), ColumnDomains.all(),
        node_id=x_node, broken_ids={x_vid}), ["v"])
    assert short is None or short.n_rows < len(c.want)
    assert c.marks() == {x_vid}

    rep = c.coords[a_node].anti_entropy_sweep()
    assert x_vid in rep["repaired"] and rep["failed"] == []
    assert c.marks() == set()
    c.leaders[(OWNER, g.id)] = x_vid
    assert c.routes() == before
    for nid in c.coords:
        _assert_rows(c.scan(nid), c.want)
