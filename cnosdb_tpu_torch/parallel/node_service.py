"""Data-node RPC service: the node-to-node data plane.

Role-parity with the reference's gRPC TSKVService + RaftService servers
(main/src/rpc/tskv.rs:214-397 RaftWrite/QueryRecordBatch/TagScan/Admin,
replication/src/network_grpc.rs RaftCBServer): every data node hosts one
RpcServer (parallel.net) answering

  raft_msg        raft consensus messages for replica groups on this node
  write_vnode     single-replica point writes for a local vnode
  write_replica   propose on a replica-set whose raft leader lives here
  scan_vnode      scan one local vnode → Arrow IPC bytes
  tag_values / series_keys / delete_from_table   index/admin fan-out
  status          node liveness + vnode inventory

The service owns nothing itself: it is a thin dispatch onto the node's
Coordinator / ReplicaGroupManager / engine, so local and remote execution
share one code path.
"""
from __future__ import annotations

from ..models.points import WriteBatch
from ..models.predicate import ColumnDomains, TimeRanges
from .coordinator import Coordinator, PlacedSplit
from .ipc import encode_scan_batch
from .net import RpcServer
from .raft import NotLeader


class DataNodeService:
    def __init__(self, coord: Coordinator, host: str = "127.0.0.1",
                 port: int = 0):
        self.coord = coord
        self.server = RpcServer(host, port, node_id=coord.node_id, handlers={
            "ping": self._ping,
            "status": self._status,
            "raft_msg": self._raft_msg,
            "write_vnode": self._write_vnode,
            "write_replica": self._write_replica,
            "scan_vnode": self._scan_vnode,
            "cancel_scan": self._cancel_scan,
            "tag_values": self._tag_values,
            "series_keys": self._series_keys,
            "delete_vnode_range": self._delete_vnode_range,
            "vnode_snapshot": self._vnode_snapshot,
            "backup_cut": self._backup_cut,
            "restore_vnode": self._restore_vnode,
            "vnode_install": self._vnode_install,
            "vnode_drop": self._vnode_drop,
            "vnode_compact": self._vnode_compact,
            "vnode_token": self._vnode_token,
            "vnode_checksum": self._vnode_checksum,
            "matview_partials": self._matview_partials,
            "replica_change_membership": self._replica_change_membership,
            "replica_stepdown": self._replica_stepdown,
            "replica_progress": self._replica_progress,
            "replica_stop_member": self._replica_stop_member,
        })
        self.addr = self.server.addr

    def start(self):
        self.server.start()
        return self

    def stop(self):
        self.server.stop()

    # ------------------------------------------------------------ handlers
    def _ping(self, p):
        return {"ok": True, "node_id": self.coord.node_id}

    def _status(self, p):
        inv: dict[str, list[int]] = {}
        for (owner, vid) in list(self.coord.engine.vnodes):
            inv.setdefault(owner, []).append(vid)
        return {"node_id": self.coord.node_id,
                "vnodes": {o: sorted(vs) for o, vs in inv.items()}}

    def _raft_msg(self, p):
        reply = self.coord.replica_manager().handle_raft_msg(
            p["group"], p["to"], p["msg"])
        return {"reply": reply}

    def _matview_partials(self, p):
        """Sealed rollup partials for one LOCAL vnode (coordinator-side
        subsumption rewrite fan-out)."""
        me = getattr(self.coord, "matview_maintainer", None)
        if me is None:
            return {"hwm": None, "rows": []}
        return me.partials_for(p["view"], p["owner"], p["vnode_id"])

    def _write_vnode(self, p):
        batch = WriteBatch.decode(p["data"])
        self.coord.engine.write(p["owner"], p["vnode_id"], batch,
                                sync=p.get("sync", False))
        return {"ok": True}

    def _write_replica(self, p):
        from ..models.meta_data import ReplicationSet

        rs = ReplicationSet.from_dict(p["rs"])
        try:
            idx = self.coord.replica_manager().propose_local(
                p["owner"], rs, p["entry_type"], p["data"],
                sync=p.get("sync", False))
        except NotLeader as e:
            return {"ok": False, "hint": e.args[0] if e.args else None}
        return {"ok": True, "index": idx}

    def _scan_vnode(self, p):
        """One local vnode's scan. With `leader_read` it is served only
        where the vnode's member leads and its read index confirms the
        read, else answered not-leader with the leader the member follows;
        with `confirmed` a follower serves it too, once its follower read
        index confirms it (Coordinator.confirm_read). Every query route
        of a replicated set sends one of the two flags. Without either the
        scan reads the replica it names, unchecked: for a single-replica
        set, and for diagnostics that read one replica on purpose
        (`replica_keys` in chip_smoke.py)."""
        if p.get("leader_read") or p.get("confirmed"):
            refused = self.coord.confirm_read(
                p["owner"], p["vnode_id"], follower=bool(p.get("confirmed")))
            if refused is not None:
                return refused
        if p.get("fp"):
            # serving-plane-tagged scan: lets cluster-wide dashboards
            # attribute remote work to the originating query family
            from ..utils import stages

            stages.count("serving.remote_fp")
        split = PlacedSplit(
            p["owner"], p["vnode_id"], p["table"],
            TimeRanges.from_wire(p["trs"]),
            ColumnDomains.from_wire(p["doms"]))
        b = self.coord._scan_local(split, p.get("field_names"))
        if b is None:
            return {"ipc": None}
        return {"ipc": encode_scan_batch(b)}

    def _vnode_token(self, p):
        """Serving-plane result-cache validation: the LOCAL vnode's
        ScanToken, so a coordinating node can key / revalidate cached
        results whose data lives here."""
        v = self.coord.engine.vnode(p["owner"], p["vnode_id"])
        if v is None:
            return {"token": None}
        t = v.scan_token()
        return {"token": {"data_version": t.data_version,
                          "destructive_version": t.destructive_version,
                          "file_ids": sorted(t.file_ids),
                          "mem_seq": t.mem_seq}}

    def _cancel_scan(self, p):
        """Best-effort cancellation fan-in (reference kill_query over the
        coordinator's admin plane): flip the cancel flag of every handler
        currently working for this qid (registered by the RPC server on
        dispatch) and tombstone the qid so queued/delayed work for it is
        rejected on dequeue instead of executed."""
        from ..utils import deadline as deadline_mod

        qid = p.get("qid")
        if not qid:
            return {"ok": False, "cancelled": 0}
        n = deadline_mod.CANCELS.cancel(str(qid))
        return {"ok": True, "cancelled": n}

    def _tag_values(self, p):
        return {"values": self.coord.tag_values_local(
            p["owner"], p["table"], p["tag_key"])}

    def _series_keys(self, p):
        keys = self.coord.series_keys_local(
            p["owner"], p["table"], ColumnDomains.from_wire(p["doms"]))
        return {"keys": [k.encode() for k in keys]}

    def _delete_vnode_range(self, p):
        self.coord.delete_vnode_local(
            p["owner"], p["vnode_id"], p["table"],
            ColumnDomains.from_wire(p["doms"]), p["min_ts"], p["max_ts"])
        return {"ok": True}

    # vnode snapshot shipping (reference rpc/tskv.rs DownloadFile — the
    # MOVE/COPY VNODE data plane; logical snapshots here)
    def _vnode_snapshot(self, p):
        from .replica import VnodeStateMachine

        v = self.coord.engine.vnode(p["owner"], p["vnode_id"])
        if v is None:
            return {"data": None}
        return {"data": VnodeStateMachine(v).snapshot()}

    def _backup_cut(self, p):
        """BACKUP fan-out: one local vnode's consistency cut (files +
        digests + flushed_seq + scan token), with the forced WAL seal +
        archive catch_up baked into _local_cut."""
        from ..storage import backup

        v = self.coord.engine.vnode(p["owner"], p["vnode_id"])
        if v is None:
            return {"cut": None}
        return {"cut": backup._local_cut(v)}

    def _restore_vnode(self, p):
        """RESTORE fan-out: wipe + install one local vnode from shipped
        snapshot bytes, then replay the shipped archived-WAL entries."""
        from ..storage import backup

        backup.install_vnode(self.coord.engine, p["owner"], p["vnode_id"],
                             p["snap"], p["entries"])
        return {"ok": True}

    def _vnode_install(self, p):
        from .replica import VnodeStateMachine

        v = self.coord.engine.open_vnode(p["owner"], p["vnode_id"])
        VnodeStateMachine(v).install_snapshot(p["data"], 0, 0)
        return {"ok": True}

    def _vnode_drop(self, p):
        # stop any live raft member first: its ticker would recreate the
        # WAL the drop removes
        if p.get("rs_id") is not None and self.coord._replica_mgr is not None:
            self.coord._replica_mgr.stop_member(
                p["owner"], p["rs_id"], p["vnode_id"])
        self.coord.engine.drop_vnode(p["owner"], p["vnode_id"])
        return {"ok": True}

    def _vnode_compact(self, p):
        v = self.coord.engine.vnode(p["owner"], p["vnode_id"])
        if v is not None:
            v.compact_major()
        return {"ok": True}

    def _vnode_checksum(self, p):
        v = self.coord.engine.vnode(p["owner"], p["vnode_id"])
        return {"checksum": v.checksum() if v is not None else ""}

    # raft membership change (reference raft/manager.rs:323-566
    # add_follower / change-membership admin surface)
    def _replica_change_membership(self, p):
        from ..models.meta_data import ReplicationSet

        rs = ReplicationSet.from_dict(p["rs"])
        try:
            idx = self.coord.replica_manager().change_membership_local(
                p["owner"], rs, p["members"])
        except NotLeader as e:
            return {"ok": False, "hint": e.args[0] if e.args else None}
        return {"ok": True, "index": idx}

    def _replica_stepdown(self, p):
        from ..models.meta_data import ReplicationSet

        rs = ReplicationSet.from_dict(p["rs"])
        stepped = self.coord.replica_manager().stepdown_local(
            p["owner"], rs, p["vnode_id"])
        return {"ok": True, "stepped": stepped}

    def _replica_stop_member(self, p):
        """Stop a raft member WITHOUT dropping its data (a set shrinking
        to one replica leaves consensus; the vnode stays)."""
        mgr = self.coord._replica_mgr
        if mgr is not None:
            mgr.stop_member(p["owner"], p["rs_id"], p["vnode_id"])
        return {"ok": True}

    def _replica_progress(self, p):
        from ..models.meta_data import ReplicationSet

        rs = ReplicationSet.from_dict(p["rs"])
        prog = self.coord.replica_manager().member_progress(
            p["owner"], rs, p["vnode_id"])
        if prog is None:
            return {"ok": False}
        return {"ok": True, "match": prog[0], "commit": prog[1]}
