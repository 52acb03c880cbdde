"""Replica groups: raft-replicated vnodes.

Role-parity with the reference's RaftNodesManager + TskvRaftWriter
(coordinator/src/raft/manager.rs:33-754, raft/writer.rs:19): every
ReplicationSet with more than one vnode runs a raft group whose state
machine is the VnodeStorage apply path and whose log store is that vnode's
WAL (one durable log per vnode, reference wal_store.rs). Writes go to the
group leader (retry-on-leader-change like tskv_executor.rs
TskvLeaderExecutor); single-vnode sets bypass consensus entirely.

Two deployments share this code:
- single-process (tests, singleton mode): every replica is local, messages
  ride the InProcessTransport;
- multi-node: each node builds ONLY the raft members whose vnodes are
  placed on it; peer messages ride HttpTransport to the owning node's RPC
  service (reference network_grpc.rs), resolved through meta placement.
"""
from __future__ import annotations

import os
import threading

import msgpack

from ..errors import ReplicationError
from ..models.meta_data import ReplicationSet
from ..storage.engine import TsKv
from ..storage.vnode import VnodeStorage
from .raft import (
    HttpTransport, InProcessTransport, LogEntry, MultiRaft, NotLeader,
    RaftNode, StateMachine, WalLogStore,
)
from ..utils import lockwatch


class VnodeStateMachine(StateMachine):
    """ApplyStorage over VnodeStorage (reference tskv TskvEngineStorage)."""

    def __init__(self, vnode: VnodeStorage):
        self.vnode = vnode

    def apply(self, entry: LogEntry):
        if entry.term == 0 and entry.index <= self.vnode.applied_seq:
            # an entry of the vnode's own (a write from before the set
            # was replicated, or a local delete): the vnode applied it
            # when it was written, or in its replay at open
            return
        self.vnode.apply_entry(entry.entry_type, entry.data, entry.index)

    def snapshot(self) -> bytes:
        """FILE-level snapshot (reference vnode_store.rs VnodeSnapshot +
        DownloadFile shipping): flush, then capture the vnode's physical
        files — no per-row re-encoding, and install is byte-identical."""
        return msgpack.packb(self.vnode.file_snapshot(), use_bin_type=True)

    def install_snapshot(self, data: bytes, last_index: int, last_term: int):
        snap = msgpack.unpackb(data, raw=False, strict_map_key=False)
        self.vnode.install_file_snapshot(snap)
        self.vnode.raft_seq = last_index


def _resume_index(vnode: VnodeStorage, log: WalLogStore) -> int:
    """The raft index a vnode's member starts from (its commit and applied
    index): what the vnode already reflects, its flushed watermark raised
    by the replicated entries applied since. A log that starts past it
    (a snapshot install replaced the entries before its index) resumes
    before its first entry: the snapshot's files hold what came before."""
    first = log.first_index()
    return max(vnode.raft_seq, first - 1 if first else 0)


def open_local_members(coord) -> int:
    """Node boot, once the engine has reopened its vnodes: start the raft
    member of every local vnode whose replica set has more than one
    member, so that the entries its open left to raft apply as soon as a
    leader confirms them, with no write or peer message needed first. A
    vnode whose set has one member applies them itself. → members
    started."""
    n = 0
    for (owner, vid), vnode in list(coord.engine.vnodes.items()):
        hit = coord.meta.find_vnode(vid)
        if hit is None or hit[0] != owner:
            continue
        rs = hit[2]
        if len(rs.vnodes) > 1:
            n += vid in coord.replica_manager().get_or_build(owner, rs)
        else:
            vnode.replay_raft_tail()
    return n


class ReplicaGroupManager:
    """Builds/holds the raft groups for this node's replica-set members.

    With `meta=None` (single-process), all members of every set are built
    locally over InProcessTransport — the round-1 behavior. With a meta
    view, only vnodes placed on `node_id` are built and remote peers are
    resolved to their owning node's RPC address."""

    def __init__(self, engine: TsKv, node_id: int | None = None,
                 meta=None,
                 election_timeout=(0.15, 0.3), heartbeat_interval=0.05):
        self.engine = engine
        self.node_id = node_id
        self.meta = meta
        if meta is None:
            self.transport = InProcessTransport()
        else:
            self.transport = HttpTransport(self._resolve_peer)
        self.multi = MultiRaft()
        self.election_timeout = election_timeout
        self.heartbeat_interval = heartbeat_interval
        self.lock = lockwatch.Lock("replica.manager")
        # group_id → ReplicationSet placement (for peer resolution)
        self._placements: dict[str, ReplicationSet] = {}
        # leadership transitions wake blocked writers (event-driven, not
        # sleep-polling: pollers starve under load and hit deadlines)
        self._state_cv = threading.Condition(lockwatch.RLock("replica.state_cv"))

    def _on_member_state(self, _node) -> None:
        with self._state_cv:
            self._state_cv.notify_all()

    def group_id(self, owner: str, rs: ReplicationSet) -> str:
        return f"{owner}/{rs.id}"

    # ------------------------------------------------------------ placement
    def _resolve_peer(self, group_id: str, peer_vnode: int) -> str | None:
        rs = self._placements.get(group_id)
        if rs is None:
            rs = self._find_placement(group_id)
        if rs is None:
            return None
        v = rs.vnode(peer_vnode)
        if v is None or v.node_id == self.node_id:
            return None
        return self.meta.node_addr(v.node_id)

    def _find_placement(self, group_id: str) -> ReplicationSet | None:
        """owner/rs_id → ReplicationSet via the meta bucket map."""
        owner, _, rs_id_s = group_id.rpartition("/")
        tenant, _, db = owner.partition(".")
        try:
            rs_id = int(rs_id_s)
        except ValueError:
            return None
        for bucket in self.meta.buckets_for(tenant, db):
            for rs in bucket.shard_group:
                if rs.id == rs_id:
                    self._placements[group_id] = rs
                    return rs
        return None

    def _is_local(self, v) -> bool:
        return self.meta is None or v.node_id == self.node_id

    # ------------------------------------------------------------ groups
    def get_or_build(self, owner: str, rs: ReplicationSet) -> dict[int, RaftNode]:
        """→ vnode_id → RaftNode for this node's members of the set."""
        gid = self.group_id(owner, rs)
        with self.lock:
            self._placements[gid] = rs
            nodes = {}
            peers = [v.id for v in rs.vnodes]
            for v in rs.vnodes:
                if not self._is_local(v):
                    continue
                key = (gid, v.id)
                existing = self.transport.nodes.get(key)
                if existing is not None:
                    nodes[v.id] = existing
                    continue
                vnode = self.engine.open_vnode(owner, v.id)
                log = WalLogStore(vnode.wal,
                                  os.path.join(vnode.dir, "hardstate"))
                node = RaftNode(gid, v.id, peers, log,
                                VnodeStateMachine(vnode), self.transport,
                                election_timeout=self.election_timeout,
                                heartbeat_interval=self.heartbeat_interval,
                                initial_applied=_resume_index(vnode, log),
                                on_state=self._on_member_state)
                self.multi.add(node)
                nodes[v.id] = node
            return nodes

    def ensure_group(self, group_id: str) -> bool:
        """Build this node's members for a group named by id (first contact
        from a remote raft peer, reference manager.rs open-on-demand)."""
        rs = self._placements.get(group_id) or self._find_placement(group_id)
        if rs is None:
            return False
        owner = group_id.rpartition("/")[0]
        self.get_or_build(owner, rs)
        return True

    def handle_raft_msg(self, group_id: str, to: int, msg: dict) -> dict | None:
        node = self.transport.nodes.get((group_id, to))
        if node is None:
            if not self.ensure_group(group_id):
                return None
            node = self.transport.nodes.get((group_id, to))
            if node is None:
                return None
        return node.handle_message(msg)

    def invalidate(self, owner: str, rs_id: int):
        """Placement changed: drop the cached ReplicationSet for peer
        resolution (single authority for the cache-key format)."""
        self._placements.pop(f"{owner}/{rs_id}", None)

    def stop_member(self, owner: str, rs_id: int, vnode_id: int):
        """Tear down this node's raft member for a removed replica — its
        WAL/dir is about to be dropped and a live ticker would recreate
        them (REPLICA REMOVE)."""
        gid = f"{owner}/{rs_id}"
        node = self.transport.nodes.pop((gid, vnode_id), None)
        if node is not None:
            node.stop()
            self.multi.remove(node)

    def current_leader_vnode(self, owner: str, rs: ReplicationSet) -> int | None:
        """The raft leader's vnode id (may differ from meta's static
        leader_vnode_id after elections) — readers follow it for
        read-your-writes."""
        gid = self.group_id(owner, rs)
        for v in rs.vnodes:
            node = self.transport.nodes.get((gid, v.id))
            if node is not None and node.is_leader():
                return v.id
        return None

    def leader_hint(self, owner: str, rs: ReplicationSet) -> int | None:
        """A local member's view of the current leader vnode id."""
        gid = self.group_id(owner, rs)
        for v in rs.vnodes:
            node = self.transport.nodes.get((gid, v.id))
            if node is not None and node.leader_id is not None:
                return node.leader_id
        return None

    # ------------------------------------------------------------ writes
    def write(self, owner: str, rs: ReplicationSet, entry_type: int,
              data: bytes, timeout: float = 10.0, sync: bool = False) -> int:
        """Propose on the current leader, retrying across leader changes
        (reference TskvLeaderExecutor). Deadline-based: a cold-start
        election on a loaded host can take seconds; giving up early turns
        a transient into a write failure."""
        import time

        nodes = self.get_or_build(owner, rs)
        last_err: Exception | None = None
        deadline = time.monotonic() + timeout

        def wait_state(span: float):
            # woken early by any leadership transition; the timeout is a
            # fallback for remote-leader groups whose local members see
            # no transition
            with self._state_cv:
                self._state_cv.wait(min(span, max(
                    0.0, deadline - time.monotonic())))

        while time.monotonic() < deadline:
            leader = next((n for n in nodes.values() if n.is_leader()), None)
            if leader is None:
                wait_state(0.25)
                continue
            try:
                idx = leader.propose(entry_type, data)
                if sync:
                    self.engine.open_vnode(owner, leader.node_id).wal.sync()
                return idx
            except NotLeader as e:
                last_err = e
                wait_state(0.1)
            except ReplicationError as e:
                last_err = e
                wait_state(0.1)
        raise ReplicationError(
            f"no leader for {self.group_id(owner, rs)}") from last_err

    def propose_local(self, owner: str, rs: ReplicationSet, entry_type: int,
                      data: bytes, sync: bool = False) -> int:
        """Propose iff a member on THIS node is the raft leader; raises
        NotLeader(hint) otherwise so the coordinator can forward."""
        nodes = self.get_or_build(owner, rs)
        leader = next((n for n in nodes.values() if n.is_leader()), None)
        if leader is None:
            raise NotLeader(self.leader_hint(owner, rs))
        idx = leader.propose(entry_type, data)
        if sync:
            self.engine.open_vnode(owner, leader.node_id).wal.sync()
        return idx

    # ------------------------------------------------------------ membership
    def change_membership_local(self, owner: str, rs: ReplicationSet,
                                member_ids: list[int],
                                timeout: float = 10.0) -> int:
        """Single-step config change via a LOCAL leader member; raises
        NotLeader(hint) when no member on this node leads the group (the
        coordinator then forwards to the leader's node). `rs` is the
        CURRENT placement (pre- or post-change both work: peer resolution
        uses meta placement, the raft config rides the log entry)."""
        nodes = self.get_or_build(owner, rs)
        leader = next((n for n in nodes.values() if n.is_leader()), None)
        if leader is None:
            raise NotLeader(self.leader_hint(owner, rs))
        return leader.change_membership(member_ids, timeout=timeout)

    def stepdown_local(self, owner: str, rs: ReplicationSet,
                       vnode_id: int) -> bool:
        """Ask a local member to yield leadership (pre-removal of the
        leader member). → True if it was leader and stepped down."""
        gid = self.group_id(owner, rs)
        node = self.transport.nodes.get((gid, vnode_id))
        if node is None or not node.is_leader():
            return False
        node.stepdown()
        return True

    def member_progress(self, owner: str, rs: ReplicationSet,
                        vnode_id: int) -> tuple[int, int] | None:
        """(match_index, commit_index) of `vnode_id` as seen by a LOCAL
        leader — the catch-up gauge for REPLICA ADD. None when this node
        does not lead the group."""
        nodes = self.get_or_build(owner, rs)
        leader = next((n for n in nodes.values() if n.is_leader()), None)
        if leader is None:
            return None
        if vnode_id == leader.node_id:
            return leader.log.last_index(), leader.commit_index
        return leader.match_index.get(vnode_id, 0), leader.commit_index

    def stop(self):
        self.multi.stop_all()
