"""A replica's restart on the port's copied host modules.

Four faults that a three-node cnosdb_tpu_torch cluster showed on the card,
each made to happen here on purpose, in-process:

- a restarted replica replayed its whole raft log into the memory cache,
  rows flushed before the crash included, and applied the entries past
  its flushed watermark twice (the vnode's WAL replay, then raft from
  index 1); an entry raft never committed was visible at open;
- a series whose memory rows overlap a file took the per-series Python
  path without booking a decode-fallback reason;
- a scan that raced raft's apply into the memory cache read a series'
  timestamps and its fields from two states ("could not broadcast input
  array from shape (100,) into shape (0,)", or rows with no fields);
- after a leader's SIGKILL on the card, a group stayed leaderless for
  180 s: the restarted node's first raft messages, arriving on several
  RPC threads at once, each built a replica manager, so a second, unseen
  raft member of the same vnode won leadership and the registered one
  sat at commit 0, its prevotes refused because its peers heard that
  leader. Each member now also reports why an election does or does not
  happen (its ticker's age, whether its lock is held, its prevote
  rounds, the prevotes it refused by reason).

The data comes from a numpy seed. The reference keeps these faults (it is
not changed), so the tests hold the port to the guarantees themselves:
every acked write read back, each entry applied once, whole rows.
"""
import sys
import threading
import time

import numpy as np
import pytest

from cnosdb_tpu_torch.models.points import SeriesRows, WriteBatch
from cnosdb_tpu_torch.models.schema import (DatabaseOptions, DatabaseSchema,
                                            ValueType)
from cnosdb_tpu_torch.models.series import SeriesKey
from cnosdb_tpu_torch.parallel.coordinator import Coordinator
from cnosdb_tpu_torch.parallel.meta import DEFAULT_TENANT, MetaStore
from cnosdb_tpu_torch.storage import scan as scan_mod
from cnosdb_tpu_torch.storage.engine import TsKv
from cnosdb_tpu_torch.storage.scan import DeltaVnodeView, scan_vnode
from cnosdb_tpu_torch.storage.vnode import VnodeStorage
from cnosdb_tpu_torch.storage.wal import WalEntryType

SEED = 9
OWNER = f"{DEFAULT_TENANT}.rdb"
HOSTS = [f"h{i}" for i in range(4)]
ROWS = 25            # rows a host a write


def _batch(rng, t0: int, hosts=HOSTS, rows=ROWS) -> tuple[WriteBatch, dict]:
    """One write of `rows` points a host from t0 on, and its rows by
    (host, ts) → (u, s)."""
    wb = WriteBatch()
    want = {}
    ts = list(range(t0, t0 + rows))
    for h in hosts:
        u = rng.standard_normal(rows)
        s = rng.standard_normal(rows)
        wb.add_series("cpu", SeriesRows(
            SeriesKey("cpu", {"host": h}), ts,
            {"u": (int(ValueType.FLOAT), u.tolist()),
             "s": (int(ValueType.FLOAT), s.tolist())}))
        want.update({(h, t): (a, b) for t, a, b in zip(ts, u, s)})
    return wb, want


def _rows(vnode) -> dict:
    """Every row a scan of the vnode returns, by (host, ts)."""
    b = scan_vnode(vnode, "cpu", field_names=["u", "s"])
    out = {}
    if b.n_rows == 0:
        return out
    (_, u, uv), (_, s, sv) = b.fields["u"], b.fields["s"]
    assert uv.all() and sv.all(), "a row without its fields"
    for i in range(b.n_rows):
        host = b.series_keys[b.sid_ordinal[i]].tag_value("host")
        out[(host, int(b.ts[i]))] = (float(u[i]), float(s[i]))
    return out


def _mem_rows(vnode) -> set:
    """(host, ts) of every row in the vnode's memory caches."""
    out = set()
    for cache in [*vnode.immutables, vnode.active]:
        for (_t, sid), sd in cache.series.items():
            host = vnode.index.get_series_key(sid).tag_value("host")
            ts, _f, _o = sd.materialize()
            out.update((host, int(t)) for t in ts)
    return out


def _wait(cond, timeout=20.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


def _caught_up(nodes) -> bool:
    return any(n.is_leader() for n in nodes.values()) and all(
        n.log.last_index() == n.commit_index == n.last_applied
        for n in nodes.values())


def _crash(coord, engine) -> None:
    """What a SIGKILL leaves: the WALs on disk (synced), the memory caches
    gone. The raft members stop; the engine is dropped unclosed (a close
    would flush)."""
    coord.replica_manager().stop()
    for v in engine.vnodes.values():
        v.wal.sync()
    engine._compactor.shutdown(wait=True)


def _replicated(tmp_path):
    meta = MetaStore(str(tmp_path / "meta.json"))
    meta.create_database(DatabaseSchema(
        DEFAULT_TENANT, "rdb", DatabaseOptions(replica=3)))
    engine = TsKv(str(tmp_path / "data"), background_compaction=False)
    return meta, engine, Coordinator(meta, engine)


@pytest.fixture
def applied(monkeypatch):
    """(vnode id, seq) of every entry a vnode applies, in order."""
    seen = []
    orig = VnodeStorage._apply_entry

    def record(self, entry_type, data, seq, logged):
        seen.append((self.vnode_id, seq))
        return orig(self, entry_type, data, seq, logged)

    monkeypatch.setattr(VnodeStorage, "_apply_entry", record)
    return seen


def test_restart_after_flush_resumes_at_the_watermark(tmp_path, applied):
    """Rows flushed before the crash stay out of the memory cache, every
    entry past the flush applies once, and every acked row reads back
    from all three replicas."""
    rng = np.random.default_rng(SEED)
    meta, engine, coord = _replicated(tmp_path)
    want = {}
    for k in range(3):                          # flushed before the crash
        wb, rows = _batch(rng, k * ROWS)
        coord.write_points(DEFAULT_TENANT, "rdb", wb)
        want.update(rows)
    rs = meta.buckets_for(DEFAULT_TENANT, "rdb")[0].shard_group[0]
    nodes = coord.replica_manager().get_or_build(OWNER, rs)
    assert _wait(lambda: _caught_up(nodes))
    flushed_keys = set(want)
    for v in rs.vnodes:
        engine.vnode(OWNER, v.id).flush()
    late = {}
    for k in range(3, 5):                       # past the flush
        wb, rows = _batch(rng, k * ROWS)
        coord.write_points(DEFAULT_TENANT, "rdb", wb)
        late.update(rows)
    want.update(late)
    assert _wait(lambda: _caught_up(nodes) and all(
        len(_rows(engine.vnode(OWNER, v.id))) == len(want)
        for v in rs.vnodes))
    flushed = {v.id: engine.vnode(OWNER, v.id).summary.version.flushed_seq
               for v in rs.vnodes}
    assert all(flushed.values())
    _crash(coord, engine)

    applied.clear()
    engine2 = TsKv(str(tmp_path / "data"), background_compaction=False)
    coord2 = Coordinator(meta, engine2)
    engine2.open_existing()
    nodes2 = coord2.replica_manager().get_or_build(OWNER, rs)
    try:
        assert _wait(lambda: _caught_up(nodes2) and all(
            len(_rows(engine2.vnode(OWNER, v.id))) == len(want)
            for v in rs.vnodes)), {
                vid: n.metrics() for vid, n in nodes2.items()}
        for v in rs.vnodes:
            vn = engine2.vnode(OWNER, v.id)
            mem = _mem_rows(vn)
            assert not mem & flushed_keys, \
                f"vnode {v.id}: flushed rows replayed into the memory cache"
            assert mem == set(late), f"vnode {v.id}: {len(mem)} rows cached"
            got = _rows(vn)
            assert got.keys() == want.keys()
            np.testing.assert_array_equal(
                np.array([got[k] for k in sorted(want)]),
                np.array([want[k] for k in sorted(want)]))
        mine = [s for s in applied if s[0] in flushed]
        assert mine
        seqs = [s for s in mine if s[1] <= flushed[s[0]]]
        assert not seqs, f"entries at or below the flush applied: {seqs[:5]}"
        assert len(mine) == len(set(mine)), "an entry applied twice"
    finally:
        coord2.close()


def test_uncommitted_entry_is_not_visible_at_open(tmp_path):
    """An entry in a follower's WAL that raft never committed stays out of
    what the vnode shows at open, which is its flushed rows: raft alone
    decides whether the entry commits."""
    rng = np.random.default_rng(SEED + 1)
    meta, engine, coord = _replicated(tmp_path)
    wb, want = _batch(rng, 0)
    coord.write_points(DEFAULT_TENANT, "rdb", wb)
    rs = meta.buckets_for(DEFAULT_TENANT, "rdb")[0].shard_group[0]
    nodes = coord.replica_manager().get_or_build(OWNER, rs)
    assert _wait(lambda: _caught_up(nodes))
    for v in rs.vnodes:
        engine.vnode(OWNER, v.id).flush()
    follower = next(n for n in nodes.values() if not n.is_leader())
    term, last = follower.term, follower.log.last_index()
    _crash(coord, engine)
    # the entry a leader appended and sent to this follower alone before
    # it died: in the follower's log at the leader's term, not committed
    wb2, pending = _batch(rng, 10 * ROWS)
    vn = engine.vnode(OWNER, follower.node_id)
    vn.wal.append(WalEntryType.WRITE, wb2.encode(), seq=last + 1, term=term)
    vn.wal.sync()

    engine2 = TsKv(str(tmp_path / "data"), background_compaction=False)
    try:
        got = _rows(engine2.open_vnode(OWNER, follower.node_id))
        assert not got.keys() & pending.keys(), "uncommitted rows visible"
        assert got.keys() == want.keys()
    finally:
        engine2._compactor.shutdown(wait=True)


def test_boot_starts_the_members_of_replicated_vnodes(tmp_path):
    """The server's boot (open_local_members) starts the raft members of
    replicated vnodes, so the acked rows past the flush read back after a
    restart without a write first."""
    from cnosdb_tpu_torch.parallel.replica import open_local_members

    rng = np.random.default_rng(SEED + 2)
    meta, engine, coord = _replicated(tmp_path)
    wb, want = _batch(rng, 0)
    coord.write_points(DEFAULT_TENANT, "rdb", wb)
    rs = meta.buckets_for(DEFAULT_TENANT, "rdb")[0].shard_group[0]
    nodes = coord.replica_manager().get_or_build(OWNER, rs)
    assert _wait(lambda: _caught_up(nodes))
    _crash(coord, engine)

    engine2 = TsKv(str(tmp_path / "data"), background_compaction=False)
    coord2 = Coordinator(meta, engine2)
    engine2.open_existing()
    try:
        assert open_local_members(coord2) == 3
        assert _wait(lambda: all(
            _rows(engine2.vnode(OWNER, v.id)).keys() == want.keys()
            for v in rs.vnodes))
    finally:
        coord2.close()


def test_a_set_shrunk_to_one_replica_replays_its_raft_entries(tmp_path,
                                                             applied):
    """REPLICA REMOVE down to one member leaves raft's entries in the
    survivor's WAL, and its later writes follow them without a term. No
    raft member drives it any more: the boot replays them itself, each
    once."""
    from cnosdb_tpu_torch.parallel.replica import open_local_members

    rng = np.random.default_rng(SEED + 5)
    meta, engine, coord = _replicated(tmp_path)
    wb, want = _batch(rng, 0)
    coord.write_points(DEFAULT_TENANT, "rdb", wb)
    rs = meta.buckets_for(DEFAULT_TENANT, "rdb")[0].shard_group[0]
    nodes = coord.replica_manager().get_or_build(OWNER, rs)
    assert _wait(lambda: _caught_up(nodes))
    for v in rs.vnodes[1:]:
        coord.drop_replica(v.id)
    rs1 = meta.buckets_for(DEFAULT_TENANT, "rdb")[0].shard_group[0]
    assert len(rs1.vnodes) == 1
    wb, rows = _batch(rng, ROWS)
    coord.write_points(DEFAULT_TENANT, "rdb", wb)
    want.update(rows)
    _crash(coord, engine)

    applied.clear()
    engine2 = TsKv(str(tmp_path / "data"), background_compaction=False)
    coord2 = Coordinator(meta, engine2)
    engine2.open_existing()
    try:
        assert open_local_members(coord2) == 0
        vid = rs1.vnodes[0].id
        got = _rows(engine2.vnode(OWNER, vid))
        assert got.keys() == want.keys()
        mine = [a for a in applied if a[0] == vid]
        assert mine and len(mine) == len(set(mine)), "an entry applied twice"
    finally:
        coord2.close()


def test_concurrent_raft_messages_at_boot_build_one_member_a_vnode(
        tmp_path, monkeypatch):
    """A restarted node's first raft messages arrive on several RPC
    threads at once, each asking the coordinator for its replica manager
    (ensure_group). Made to happen on purpose, with the manager's build
    slowed: every thread gets the one manager, each vnode has one live
    raft member, and the group elects and applies on every member."""
    from cnosdb_tpu_torch.parallel import raft, replica

    rng = np.random.default_rng(SEED + 6)
    meta, engine, coord = _replicated(tmp_path)
    wb, want = _batch(rng, 0)
    coord.write_points(DEFAULT_TENANT, "rdb", wb)
    rs = meta.buckets_for(DEFAULT_TENANT, "rdb")[0].shard_group[0]
    nodes = coord.replica_manager().get_or_build(OWNER, rs)
    assert _wait(lambda: _caught_up(nodes))
    _crash(coord, engine)

    built = []
    init_mgr, init_node = replica.ReplicaGroupManager.__init__, \
        raft.RaftNode.__init__

    def slow_mgr(self, *a, **kw):
        time.sleep(0.05)
        init_mgr(self, *a, **kw)

    def record_node(self, *a, **kw):
        init_node(self, *a, **kw)
        built.append(self)

    monkeypatch.setattr(replica.ReplicaGroupManager, "__init__", slow_mgr)
    monkeypatch.setattr(raft.RaftNode, "__init__", record_node)
    engine2 = TsKv(str(tmp_path / "data"), background_compaction=False)
    coord2 = Coordinator(meta, engine2)
    engine2.open_existing()
    start = threading.Barrier(8)
    managers = []

    def raft_message():
        start.wait(5.0)
        mgr = coord2.replica_manager()
        mgr.get_or_build(OWNER, rs)
        managers.append(mgr)

    threads = [threading.Thread(target=raft_message) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(10.0)
        assert not any(t.is_alive() for t in threads)
        assert len({id(m) for m in managers}) == 1, "two replica managers"
        assert sorted(n.node_id for n in built) == \
            sorted(v.id for v in rs.vnodes), "two members of one vnode"
        nodes2 = coord2.replica_manager().get_or_build(OWNER, rs)
        # within twenty of the manager's longest election timeouts (0.3 s)
        assert _wait(lambda: any(n.is_leader() for n in nodes2.values()),
                     timeout=20 * 0.3)
        assert _wait(lambda: _caught_up(nodes2) and all(
            _rows(engine2.vnode(OWNER, v.id)).keys() == want.keys()
            for v in rs.vnodes))
    finally:
        for n in built:
            n.stop()
        coord2.close()


def _single_vnode(tmp_path) -> VnodeStorage:
    return VnodeStorage(1, str(tmp_path / "v1"))


def test_memcache_overlap_is_booked(tmp_path):
    """A series whose unflushed rows overlap its file takes the per-series
    path, and books its file pages under memcache_overlap; a series with
    no memory rows books nothing."""
    rng = np.random.default_rng(SEED + 3)
    v = _single_vnode(tmp_path)
    wb, want = _batch(rng, 0)
    v.write(wb)
    v.flush()
    wb, rows = _batch(rng, ROWS // 2, hosts=HOSTS[:1])   # overlaps the file
    v.write(wb)
    want.update(rows)
    before = scan_mod.decode_fallback_snapshot().get("memcache_overlap", 0)
    assert _rows(v) == pytest.approx(want)
    booked = scan_mod.decode_fallback_snapshot().get(
        "memcache_overlap", 0) - before
    r = v.summary.version.reader(v.summary.version.all_files()[0])
    sid = v.index.get_series_id(SeriesKey("cpu", {"host": HOSTS[0]}))
    assert booked == len(r.chunk("cpu", sid).time_pages) > 0
    v.close()


@pytest.mark.parametrize("lane", ["native", "python", "delta"])
def test_scans_during_catch_up_apply_read_whole_rows(tmp_path, monkeypatch,
                                                     lane):
    """Raft applies entries into the memory cache (vnode.apply_entry, as a
    restarted replica catching up does) while scans run: no scan raises,
    and each returns whole rows, every entry all or nothing."""
    rng = np.random.default_rng(SEED + 4)
    if lane == "python":
        monkeypatch.setenv("CNOSDB_NO_NATIVE_SCAN", "1")
    hosts = [f"h{i}" for i in range(40)]
    v = _single_vnode(tmp_path)
    # a flushed file under every series, as before the crash
    v.write(_batch(rng, 0, hosts=hosts, rows=4)[0])
    v.flush()
    seq0 = v.applied_seq
    entries = [_batch(rng, 100 + k * 4, hosts=hosts, rows=4)[0].encode()
               for k in range(150)]
    errors: list = []
    done = threading.Event()

    def scanner():
        while not done.is_set():
            try:
                if lane == "delta":
                    b = scan_vnode(DeltaVnodeView(v, frozenset(), seq0),
                                   "cpu", field_names=["u", "s"])
                else:
                    b = scan_vnode(v, "cpu", field_names=["u", "s"])
                for name in ("u", "s"):
                    if name in b.fields and not b.fields[name][2].all():
                        raise AssertionError(f"rows without {name}")
                n = np.bincount(b.sid_ordinal, minlength=b.n_series)
                if (n % 4).any():
                    raise AssertionError(f"a part of an entry: {n}")
            except Exception as e:     # noqa: BLE001 — the test's verdict
                errors.append(repr(e))
                return

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=scanner) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        for k, data in enumerate(entries):
            v.apply_entry(WalEntryType.WRITE, data, seq0 + 1 + k)
    finally:
        done.set()
        for t in threads:
            t.join()
        sys.setswitchinterval(prev)
    assert not errors, errors[:3]
    assert len(_rows(v)) == len(hosts) * 4 * (1 + len(entries))
    v.close()


class _NullSM:
    def apply(self, entry):
        pass

    def snapshot(self):
        return b""

    def install_snapshot(self, data, last_index, last_term):
        pass


# twenty of the group's longest election timeouts (0.15 s)
ELECTION_BOUND = 20 * 0.15


def _raft_group():
    from cnosdb_tpu_torch.parallel.raft import (InProcessTransport,
                                                MemoryLogStore, RaftNode)

    tx = InProcessTransport()
    return {i: RaftNode("g", i, [1, 2, 3], MemoryLogStore(), _NullSM(), tx,
                        election_timeout=(0.05, 0.15),
                        heartbeat_interval=0.02)
            for i in (1, 2, 3)}


def _leader(nodes, timeout=5.0):
    assert _wait(lambda: sum(n.is_leader() for n in nodes) == 1, timeout)
    return next(n for n in nodes if n.is_leader())


def test_survivors_of_a_dead_leader_elect_and_report_it():
    """The leader dies: a survivor wins a prevote and leads within a few
    election timeouts, and its report shows the round it won."""
    nodes = _raft_group()
    try:
        old = _leader(nodes.values())
        old.crash()
        survivors = [n for n in nodes.values() if n is not old]
        t0 = time.monotonic()
        new = _leader(survivors, timeout=ELECTION_BOUND)
        assert time.monotonic() - t0 < ELECTION_BOUND
        stats = new.election_stats()
        assert stats["prevotes_won"] >= 1 and stats["tick_errors"] == 0
        assert stats["last_prevote"]["peers"] == 2
        assert stats["tick_age_s"] < 0.5 and not stats["lock_held"]
    finally:
        for n in nodes.values():
            n.stop()


def test_a_member_stuck_behind_its_lock_is_reported_not_waited_for():
    """Another thread holds a member's raft lock: its report comes back
    at once and says so, its ticker's age grows, the other two members
    still have a leader, and the ticker runs again once the lock is
    let go."""
    nodes = _raft_group()
    try:
        stuck = _leader(nodes.values())
        held, release = threading.Event(), threading.Event()

        def hold():
            with stuck.lock:
                held.set()
                release.wait(10.0)

        t = threading.Thread(target=hold)
        t.start()
        try:
            assert held.wait(5.0)
            time.sleep(0.3)
            t0 = time.monotonic()
            stats = stuck.election_stats()
            assert time.monotonic() - t0 < 0.5
            assert stats["lock_held"] and stats["tick_age_s"] >= 0.2
            _leader([n for n in nodes.values() if n is not stuck],
                    timeout=ELECTION_BOUND)
        finally:
            release.set()
            t.join()
        assert _wait(lambda: stuck.election_stats()["tick_age_s"] < 0.1)
    finally:
        for n in nodes.values():
            n.stop()


def test_a_lost_vote_round_draws_a_fresh_election_deadline():
    """A vote round that waits out a silent member (one second) outlives
    the deadline drawn when it started: the candidate draws its next one
    afresh, so two candidates that split a vote beside a hung member do
    not start their next rounds together, round after round."""
    from cnosdb_tpu_torch.parallel.raft import (InProcessTransport,
                                                MemoryLogStore, RaftNode,
                                                Role)

    tx = InProcessTransport()
    nodes = {i: RaftNode("g", i, [1, 2, 3], MemoryLogStore(), _NullSM(), tx,
                         election_timeout=(0.05, 0.15),
                         heartbeat_interval=0.02, tick=False)
             for i in (1, 2, 3)}
    # member 2 stands in term 1 for itself; member 3 is silent
    with nodes[2].lock:
        nodes[2].term, nodes[2].voted_for = 1, 2
        nodes[2].role = Role.CANDIDATE
    held, release = threading.Event(), threading.Event()

    def hold():
        with nodes[3].lock:
            held.set()
            release.wait(10.0)

    t = threading.Thread(target=hold)
    t.start()
    try:
        assert held.wait(5.0)
        candidate = nodes[1]
        t0 = time.monotonic()
        candidate._start_election()
        assert time.monotonic() - t0 >= 0.9        # waited out member 3
        assert candidate.role == Role.CANDIDATE and candidate.term == 1
        assert candidate._election_deadline > time.monotonic()
    finally:
        release.set()
        t.join()
        for n in nodes.values():
            n.stop()
