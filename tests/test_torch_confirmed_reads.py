"""Every read of a replicated group is confirmed, on every route.

A replica that has not applied the tail of its group's log answers for a
past state, so a read of a replicated group is served only by a member
that confirms it: the leader through its read index, or a follower
through the follower read index (the raft thesis's §6.4: it asks its
leader for the leader's read index over raft, and serves once it has
applied that index). A member that cannot confirm is never read, and a
read that no member can confirm refuses within LEADERLESS_READ_S. The
tests below each name the fault they close; every route used to read a
replica unchecked somewhere:

- C10: a scan whose leader did not answer failed over to the set's other
  replicas with plain scans, the reader's own first, and a lagging one
  answered without the rows the leader had acked; a node cut off from its
  group waited out LEADER_READ_TIMEOUT_S (10 s) on every group it led;
- C11: the stand-in for a BROKEN leader and the failover after a checksum
  mismatch read a replica unchecked; a node's answer to a tag read was
  its local indexes as they stood; a view refresh moved its watermark
  past rows its replica had not applied, and they were missing from the
  view for good.

The clusters are those of tests/test_torch_read_your_writes.py: nodes in
one process, each its own engine, Coordinator, node RPC service on
127.0.0.1 and raft replica manager over one MetaStore, raft and scans on
the real wire, a node's raft delayed or cut by the `rpc.send` fault
point. The rows come from a numpy seed. The JAX package has no read
index (its raft reads at the leader's state machine), so the tests hold
the port to the guarantee itself.
"""
import time

import pytest

import test_torch_read_your_writes as ryw
from cnosdb_tpu_torch import faults
from cnosdb_tpu_torch.errors import CoordinatorError
from cnosdb_tpu_torch.models.meta_data import VnodeStatus
from cnosdb_tpu_torch.models.points import SeriesRows, WriteBatch
from cnosdb_tpu_torch.models.predicate import ColumnDomains, TimeRanges
from cnosdb_tpu_torch.models.schema import ValueType
from cnosdb_tpu_torch.models.series import SeriesKey
from cnosdb_tpu_torch.parallel import coordinator, health
from cnosdb_tpu_torch.parallel.meta import DEFAULT_TENANT
from cnosdb_tpu_torch.parallel.raft import NotLeader, Role
from cnosdb_tpu_torch.sql import matview
from cnosdb_tpu_torch.sql.executor import QueryExecutor, Session

SEED = ryw.SEED
DB, OWNER, TABLE = ryw.DB, ryw.OWNER, ryw.TABLE
# raft messages to a lagging follower arrive this late: its apply trails
# the leader's commit by about as much, long past a loaded test thread's
# stall between an ack and the read that follows it
LAG_MS = 800
# the lagging follower's election timeout while it lags: it neither
# campaigns nor grants a prevote then, so the group keeps its leader
QUIET_ELECTION = (10.0, 12.0)
MINUTE = 60 * 10**9
NOW = 10 * MINUTE    # a view's refresh time: every row is below it

_clean_plane = ryw._clean_plane
path = ryw.path


@pytest.fixture
def cluster3(tmp_path):
    c = ryw.RaftCluster(str(tmp_path), n_nodes=3, shards=1)
    yield c
    c.close()


def _read_index() -> dict:
    return health.read_index_counters()


def _roles(c, g):
    """(the leader's node, the follower whose vnode comes first in meta
    order, the other follower's node), once every member applied the
    whole log. The first follower is first among the leader's
    alternates, and the stand-in the planner takes for a BROKEN leader."""
    c.wait_caught_up(g)
    lead = c.leader_node(g)
    f_node, t_node = [v.node_id for v in g.vnodes if v.node_id != lead]
    return lead, f_node, t_node


def _vid(g, nid: int) -> int:
    (vid,) = [v.id for v in g.vnodes if v.node_id == nid]
    return vid


def _faults(*clauses: str) -> None:
    faults.configure(f"seed={SEED};" + ";".join(clauses))


def _lag(c, g, nid: int, *more: str):
    """Raft messages to node `nid` arrive LAG_MS late (the fault clauses
    `more` armed beside), and its member sits out elections meanwhile:
    hearing appends this late, it would campaign, or grant the prevote of
    a peer a loaded host kept from hearing the leader, and the group
    would change leaders under the test → a function that lifts both."""
    m = c.member(nid, g)
    timeout = m.election_timeout
    m.election_timeout = QUIET_ELECTION
    m._election_deadline = m._new_deadline()
    _faults(f"rpc.send:delay({LAG_MS}):if={c.addr(nid)} raft_msg", *more)

    def lift():
        faults.reset()
        m.election_timeout = timeout
        m._election_deadline = m._new_deadline()
    return lift


def _gap(c, g, lead: int, nid: int) -> int:
    return c.member(lead, g).last_applied - c.member(nid, g).last_applied


def _write_hosts(c, nid: int, hosts: list) -> dict:
    """ryw.ROWS new points for each of `hosts`, written through node
    `nid` and acked (sent again where raft did not commit them)."""
    ts = [c.next_ts + i for i in range(ryw.ROWS)]
    c.next_ts += ryw.ROWS
    wb, rows = WriteBatch(), {}
    for h in hosts:
        v = c.rng.standard_normal(ryw.ROWS)
        wb.add_series(TABLE, SeriesRows(
            SeriesKey(TABLE, {"host": h}), ts,
            {"v": (int(ValueType.FLOAT), v.tolist())}))
        rows.update({(h, t): x for t, x in zip(ts, v)})
    deadline = time.monotonic() + ryw.WAIT_S
    while True:
        try:
            c.coords[nid].write_points(DEFAULT_TENANT, DB, wb)
            break
        except Exception as e:
            if not any(m in str(e) for m in ryw.UNACKED) \
                    or time.monotonic() > deadline:
                raise
    c.acked.update(rows)
    return rows


def _cut(c, g, nid: int):
    """Node `nid`'s raft cut both ways: its member's sends are lost, and
    raft messages to its node fail (its scans still answer) → a function
    that heals the cut."""
    m = c.member(nid, g)
    inner = m.transport
    m.transport = ryw._Cut()
    ryw._hold_raft_to(c.addr(nid))

    def heal():
        faults.reset()
        m.transport = inner
    return heal


def _lead_on(c, g, nid: int) -> None:
    """Leadership of the group on node `nid`, every member following it:
    a leader elsewhere steps down, once every member holds its whole log
    (else `nid` could not win the election that follows), until raft
    elects `nid`."""
    vid = _vid(g, nid)

    def settled():
        lead = c.leader_node(g)
        if lead is None:
            return False
        if lead != nid:
            last = c.member(lead, g).log.last_index()
            if all(m.log.last_index() >= last
                   for m in c.members(g).values()):
                c.member(lead, g).stepdown()
            return False
        return all(m.leader_id == vid
                   for n, m in c.members(g).items() if n != nid)
    try:
        c.wait(f"group {g.id} led from node {nid}", settled)
    except AssertionError as e:
        raise AssertionError(f"{e}; members: " + str({
            n: (m.metrics(), m.election_stats())
            for n, m in c.members(g).items()})) from None


# ------------------------------------------------------ the follower read index
def test_a_lagging_followers_read_index_waits_for_the_leaders_commit(
        cluster3):
    """C10's mechanism. Raft to the follower F is delayed, and rows are
    acked through the leader: F's state machine lags the leader's commit.
    F's read index asks the leader, and returns only once F has applied
    the leader's commit index as it stood when the read arrived: F's
    replica then holds every acked row. The confirmation and its apply
    wait are booked."""
    c = cluster3
    (g,) = c.groups()
    c.write(g.leader_node_id)
    lead, f_node, _t = _roles(c, g)
    f = c.member(f_node, g)
    before = _read_index()
    lift = _lag(c, g, f_node)
    try:
        c.write(lead)
        want = c.member(lead, g).commit_index
        behind = want - f.last_applied
        at = f.read_index(5.0)
        applied = f.last_applied
    finally:
        lift()
    assert behind > 0, "the follower applied every entry: nothing lagged"
    assert at >= want and applied >= at
    ryw._assert_rows(c.replica_rows(lead, g, f_node), c.acked)
    after = _read_index()
    for key in ("follower_confirmed", "follower_apply_us"):
        assert after.get(key, 0) > before.get(key, 0), (key, after)


def test_a_follower_cut_from_its_leader_refuses_with_a_hint(cluster3):
    """C10's mechanism. The follower F's raft requests to its leader
    fail: its read index refuses at once (well within its 5 s budget)
    with the leader as its hint, and the refusal is booked."""
    c = cluster3
    (g,) = c.groups()
    c.write(g.leader_node_id)
    lead, f_node, _t = _roles(c, g)
    before = _read_index()
    _faults(f"rpc.send:fail:if={c.addr(lead)} raft_msg")
    try:
        t0 = time.monotonic()
        with pytest.raises(NotLeader) as e:
            c.member(f_node, g).read_index(5.0)
        took = time.monotonic() - t0
    finally:
        faults.reset()
    assert e.value.leader_id == _vid(g, lead)
    assert took < 2.0, took
    assert _read_index().get("follower_refused", 0) \
        > before.get("follower_refused", 0)


def test_a_candidate_refuses_a_read_at_once(cluster3):
    """C10's mechanism. A member that is campaigning knows no leader: its
    read index refuses at once (well within its 5 s budget), with no
    hint, and asks no member."""
    c = cluster3
    (g,) = c.groups()
    c.write(g.leader_node_id)
    _lead, f_node, _t = _roles(c, g)
    f = c.member(f_node, g)
    sent = []
    inner = f.transport

    class Count:
        def send(self, group_id, to, msg):
            sent.append(msg["type"])
            return inner.send(group_id, to, msg)
    with f.lock:
        f.transport = Count()
        f.role, f.leader_id = Role.CANDIDATE, None
        try:
            t0 = time.monotonic()
            with pytest.raises(NotLeader) as e:
                f.read_index(5.0)
            took = time.monotonic() - t0
        finally:
            f.role, f.transport = Role.FOLLOWER, inner
    assert e.value.leader_id is None and took < 2.0
    assert "read_index" not in sent


# ------------------------------------------------------------------ C10 reads
def test_a_read_fails_over_only_to_members_that_confirm(cluster3, path):
    """C10. The reading node's scans of the leader's node fail, and raft
    to the follower F, whose member is the first alternate of the read
    (the reader is F's own node), is delayed while rows are acked through
    the leader. The read through F's node holds every acked row: F
    serves it only after its follower read index (booked), so it waits
    for F's apply. The unchecked failover read F's replica at once and
    missed the rows F had not applied."""
    c = cluster3
    (g,) = c.groups()
    c.write(g.leader_node_id)
    lead, f_node, _t = _roles(c, g)
    (split,) = c.coords[f_node].table_vnodes(
        DEFAULT_TENANT, DB, TABLE, TimeRanges.all(), ColumnDomains.all())
    before = _read_index()
    lift = _lag(c, g, f_node, f"rpc.send:fail:if={c.addr(lead)} scan_vnode")
    try:
        late = c.write(lead)
        gap = _gap(c, g, lead, f_node)
        got = c.scan(f_node)
    finally:
        lift()
    assert (split.vnode_id, split.node_id) == (_vid(g, lead), lead)
    assert split.alternates[0] == (_vid(g, f_node), f_node)
    assert gap > 0 and late, "the follower applied every entry"
    ryw._assert_rows(got, c.acked)
    assert _read_index().get("follower_confirmed", 0) \
        > before.get("follower_confirmed", 0)


def test_a_cut_off_leaders_node_refuses_within_the_bound(cluster3):
    """C10. The leader S is cut off from raft both ways, the other two
    elect a leader and ack rows, then S's scans to its peers fail too. A
    read through S has no member to confirm it: S's read index refuses,
    and no other member answers. With LEADER_READ_TIMEOUT_S at its 10 s,
    the read refuses with the leader-read error within
    LEADERLESS_READ_S (and a second of slack), where it waited out the
    10 s; it never answers from S's replica."""
    c = cluster3
    (g,) = c.groups()
    c.write(g.leader_node_id)
    c.wait_caught_up(g)
    s_node = c.leader_node(g)
    heal = _cut(c, g, s_node)
    try:
        c.wait("the other two elect a leader", lambda: any(
            m.is_leader() for nid, m in c.members(g).items()
            if nid != s_node))
        (l_node,) = [nid for nid, m in c.members(g).items()
                     if nid != s_node and m.is_leader()]
        c.write(l_node)
        _faults(*[f"rpc.send:fail:if={c.addr(nid)}" for nid in c.coords])
        deposed = c.member(s_node, g).is_leader()
        t0 = time.monotonic()
        with pytest.raises(CoordinatorError, match="no raft leader"):
            c.scan(s_node)
        took = time.monotonic() - t0
    finally:
        heal()
    assert deposed, "S lost its role: no deposed leader was read"
    assert coordinator.LEADER_READ_TIMEOUT_S == 10.0
    assert took < coordinator.LEADERLESS_READ_S + 1.0, took


# ------------------------------------------------------------------ C11 reads
def test_a_broken_leaders_stand_in_holds_every_acked_row(cluster3, path):
    """C11. Meta marks the live leader BROKEN, so every node plans its
    read at a stand-in, the follower F, while raft to F is delayed and
    rows are acked through the leader. The read through the third node
    holds every acked row: F serves it after its follower read index. The
    stand-in was read unchecked, and missed the rows F had not
    applied."""
    c = cluster3
    (g,) = c.groups()
    c.write(g.leader_node_id)
    lead, f_node, t_node = _roles(c, g)
    c.meta.update_vnode(_vid(g, lead), status=int(VnodeStatus.BROKEN))
    lift = _lag(c, g, f_node)
    try:
        late = c.write(lead)
        gap = _gap(c, g, lead, f_node)
        (split,) = c.coords[t_node].table_vnodes(
            DEFAULT_TENANT, DB, TABLE, TimeRanges.all(), ColumnDomains.all())
        got = c.scan(t_node)
        leads = c.leader_node(g)
    finally:
        lift()
    assert gap > 0 and late, "the follower applied every entry"
    ryw._assert_rows(got, c.acked)
    assert leads == lead, f"leadership moved to node {leads}"
    assert (split.vnode_id, split.node_id) == (_vid(g, f_node), f_node)
    assert split.leader_read and split.confirmed


def test_a_checksum_failover_holds_every_acked_row(cluster3, path):
    """C11. The leader's replica seals one corrupt file, raft to the
    follower F (its first alternate) is delayed, and rows are acked. The
    leader's node reads: its scan hits the damage (quarantine, BROKEN
    mark, step down) and fails over, as a confirmed read, to the members
    that can confirm it: the read holds every acked row. The failover
    read F unchecked and missed the rows F had not applied."""
    c = cluster3
    (g,) = c.groups()
    c.write(g.leader_node_id)
    lead, f_node, _t = _roles(c, g)
    l_vid = _vid(g, lead)
    faults.configure("tsm.write:corrupt(2):nth=1")
    try:
        c.coords[lead].engine.vnode(OWNER, l_vid).flush()
    finally:
        faults.reset()
    lift = _lag(c, g, f_node)
    try:
        late = c.write(lead)
        gap = _gap(c, g, lead, f_node)
        got = c.scan(lead)
    finally:
        lift()
    assert gap > 0 and late, "the follower applied every entry"
    ryw._assert_rows(got, c.acked)
    (rs,) = c.groups()
    assert rs.vnode(l_vid).status == VnodeStatus.BROKEN, \
        "the corrupt replica was not read"


def _executor(c, nid: int) -> QueryExecutor:
    return QueryExecutor(c.meta, c.coords[nid])


def _sql(ex, q: str) -> list:
    return ex.execute_one(q, Session(DEFAULT_TENANT, DB)).rows()


def test_tag_reads_after_a_delete_show_what_the_leader_acked(cluster3):
    """C11. Raft to the follower F is delayed while two new hosts are
    acked through the leader. F's node confirms its member before it
    reads its indexes, so its own answer (what it sends a peer's tag
    read) holds the new hosts at once: it waited for F's apply, where it
    answered from F's index as it stood. A DELETE of host h0's rows is
    acked; SHOW TAG VALUES and SHOW SERIES through F's node equal the
    leader's, and SHOW SERIES WHERE time >= 0 shows no series whose rows
    were deleted (a DELETE keeps the series in the index, as in the
    reference). Then F's raft is cut both ways: F's member cannot
    confirm, and a tag read through F's node, or through a node that asks
    F's, fails with the leader-read error instead of answering from F's
    indexes."""
    c = cluster3
    (g,) = c.groups()
    c.write(g.leader_node_id)
    lead, f_node, t_node = _roles(c, g)
    new = ["h8", "h9"]
    before = _read_index()
    lift = _lag(c, g, f_node)
    try:
        _write_hosts(c, lead, new)
        gap = _gap(c, g, lead, f_node)
        own = c.coords[f_node].tag_values_local(OWNER, TABLE, "host")
        own_keys = c.coords[f_node].series_keys_local(
            OWNER, TABLE, ColumnDomains.all())
        _sql(_executor(c, lead), "DELETE FROM cpu WHERE host = 'h0'")
        f_ex = _executor(c, f_node)
        values = _sql(f_ex, "SHOW TAG VALUES FROM cpu WITH KEY = host")
        series = _sql(f_ex, "SHOW SERIES FROM cpu")
        live = _sql(f_ex, "SHOW SERIES FROM cpu WHERE time >= 0")
    finally:
        lift()
    assert gap > 0, "the follower applied every entry"
    hosts = sorted(ryw.HOSTS + new)
    assert own == hosts
    assert sorted(k.tag_value("host") for k in own_keys) == hosts
    assert _read_index().get("follower_confirmed", 0) \
        > before.get("follower_confirmed", 0)
    l_ex = _executor(c, lead)
    assert values == _sql(l_ex, "SHOW TAG VALUES FROM cpu WITH KEY = host")
    assert [v for _k, v in values] == hosts
    assert series == _sql(l_ex, "SHOW SERIES FROM cpu")
    assert sorted(r[0] for r in live) == sorted(
        r[0] for r in series if "host=h0" not in r[0])
    assert len(live) == len(hosts) - 1

    heal = _cut(c, g, f_node)
    try:
        with pytest.raises(CoordinatorError, match="no raft leader"):
            c.coords[f_node].tag_values_local(OWNER, TABLE, "host")
        with pytest.raises(CoordinatorError):
            c.coords[t_node].tag_values(DEFAULT_TENANT, DB, TABLE, "host")
        with pytest.raises(CoordinatorError):
            c.coords[t_node].series_keys(DEFAULT_TENANT, DB, TABLE)
    finally:
        heal()


def test_a_view_refresh_that_cannot_confirm_leaves_the_watermark(
        cluster3, monkeypatch):
    """C11. A view is kept on the leader S's node. S's raft is cut both
    ways, the other two elect a leader and ack rows, and S, which still
    leads in its own view, refreshes: its read index cannot confirm, so
    the refresh leaves the watermark where it was (booked as
    refresh_unconfirmed). Once the cut heals and S leads again, its
    refresh confirms and folds every acked row in: the view's answer
    equals the answer without it. The refresh moved the watermark past
    the rows S had not applied, and the view lacked them for good."""
    monkeypatch.setenv("CNOSDB_MATVIEW_AUTO", "0")
    c = cluster3
    (g,) = c.groups()
    c.write(g.leader_node_id)
    c.wait_caught_up(g)
    s_node = c.leader_node(g)
    s_vid = _vid(g, s_node)
    ex = _executor(c, s_node)
    q = ("SELECT date_bin(INTERVAL '1 minute', time) AS t, host, sum(v), "
         "count(v) FROM cpu GROUP BY t, host")
    _sql(ex, "CREATE MATERIALIZED VIEW mv WATERMARK DELAY '0s' AS " + q)
    me = ex.matview_engine()
    skipped = matview.counters_snapshot().get("refresh_unconfirmed", 0)
    heal = _cut(c, g, s_node)
    try:
        c.wait("the other two elect a leader", lambda: any(
            m.is_leader() for nid, m in c.members(g).items()
            if nid != s_node))
        (l_node,) = [nid for nid, m in c.members(g).items()
                     if nid != s_node and m.is_leader()]
        late = c.write(l_node)
        deposed = c.member(s_node, g).is_leader()
        done = me.refresh("mv", now_ns=NOW)
        hwm = me.status("mv")["vnodes"][str(s_vid)]["hwm"]
    finally:
        heal()
    assert deposed, "S lost its role: no deposed leader refreshed"
    assert late
    assert (done, hwm) == (0, None)
    assert matview.counters_snapshot().get("refresh_unconfirmed", 0) \
        > skipped

    c.wait_caught_up(g)
    _lead_on(c, g, s_node)
    assert me.refresh("mv", now_ns=NOW) == 1
    assert me.status("mv")["vnodes"][str(s_vid)]["hwm"] == NOW
    hits = matview.counters_snapshot().get("rewrite_hit", 0)
    ex.matview_rewrite_enabled = True
    with_view = sorted(map(tuple, _sql(ex, q)))
    assert matview.counters_snapshot().get("rewrite_hit", 0) > hits, \
        "the query did not read the view"
    ex.matview_rewrite_enabled = False
    without = sorted(map(tuple, _sql(ex, q)))
    assert [r[:2] + r[3:] for r in with_view] \
        == [r[:2] + r[3:] for r in without]
    assert sum(r[3] for r in without) == len(c.acked)
    for a, b in zip(with_view, without):
        assert a[2] == pytest.approx(b[2], rel=1e-12, abs=0)
