"""Per-vnode storage state machine.

Role-parity with the reference's VnodeStorage (tskv/src/vnode_store.rs:
29-620): the unit that a replica set replicates. apply() consumes logged
commands (Write / DeleteTable / DeleteSeries / DeleteTimeRange / UpdateTags),
write() stages rows into the memcache after series-id assignment, flush()
rotates the active cache into an L0 TSM file recorded in the Summary, and
recovery replays WAL entries above the flushed watermark
(wal_store.rs:429 recover).

Directory layout: <vnode_dir>/{wal/, index/, delta/, tsm/, summary}
"""
from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass

import msgpack
import numpy as np

from ..errors import StorageError
from ..models.points import SeriesRows, WriteBatch
from ..models.schema import TskvTableSchema
from ..models.series import SeriesKey, Tag
from .compaction import Picker, gc_compacted_files, run_compaction
from .flush import flush_memcache
from .index import TSIndex
from .memcache import MemCache
from .summary import Summary, VersionEdit
from .tombstone import TombstoneEntry, TsmTombstone
from .wal import Wal, WalEntryType
from ..utils import lockwatch, stages


@dataclass(frozen=True)
class ScanToken:
    """What a cached ScanBatch was decoded from: the TSM file-id set plus
    the last memcache WAL seq at capture time. A later scan whose current
    token differs only by ADDED files / HIGHER seq can decode just the
    delta and merge it into the cached batch; `destructive_version`
    gates that — deletes/tag-renames mutate existing files (tombstones)
    or the index in place, which no file/seq diff can express, so any
    bump forces a full rescan. `data_version` is kept for the exact-match
    fast path (scan_hit)."""

    data_version: int
    destructive_version: int
    file_ids: frozenset
    mem_seq: int


class VnodeStorage:
    def __init__(self, vnode_id: int, dir_path: str,
                 schemas: dict[str, TskvTableSchema] | None = None,
                 memcache_bytes: int = 128 * 1024 * 1024,
                 wal_sync: bool = False,
                 picker: Picker | None = None):
        self.vnode_id = vnode_id
        self.dir = dir_path
        os.makedirs(dir_path, exist_ok=True)
        self.schemas = schemas if schemas is not None else {}
        self.memcache_bytes = memcache_bytes
        self.lock = lockwatch.RLock(f"vnode.{vnode_id}")
        # the last named work that held the lock (VnodeStorage.locked)
        self._holder: str | None = None
        self.summary = Summary(dir_path)
        self.index = TSIndex(os.path.join(dir_path, "index"))
        self.wal = Wal(os.path.join(dir_path, "wal"), sync_on_append=wal_sync)
        # DR plane: attach the WAL archiver BEFORE replay — replay can
        # flush, flush purges, and the purge fence must already be up
        from . import backup as _backup
        if _backup.archive_enabled():
            _backup.attach_vnode(self)
        self.active = MemCache(vnode_id, memcache_bytes)
        self.immutables: list[MemCache] = []
        self.picker = picker or Picker()
        # monotonically increasing snapshot id: bumps on any mutation so
        # scan caches (host ScanBatch + device twin) invalidate naturally
        self.data_version = 0
        # bumps only on mutations that CANNOT be expressed as a delta over
        # the (file set, memcache seq) token: tombstone-writing deletes,
        # tag re-keys, snapshot installs, in-place memcache field edits
        self.destructive_version = 0
        # post-flush callback set by the storage engine (materialized
        # rollup maintenance); fired OUTSIDE the vnode lock
        self.on_flush = None
        # highest WAL seq whose mutation is REFLECTED in files+memcache.
        # Distinct from wal.next_seq-1: under replication the WAL doubles
        # as the raft log, so entries are durable at replication time but
        # only visible at apply time — a scan token must describe what a
        # scan can see, not what the log stores (see scan_token()).
        self.applied_seq = self.summary.version.flushed_seq
        # highest raft log index reflected here: the flushed watermark,
        # raised by every replicated entry applied since. A raft member
        # of this vnode resumes from it (replica.py), so an entry is
        # applied once across a restart
        self.raft_seq = self.applied_seq
        # whether the open left entries past the watermark to raft
        self._raft_tail = self._replay_wal()

    def scan_token(self) -> ScanToken:
        """Capture the snapshot token for a scan ABOUT to run. Taken under
        the vnode lock so the file set and seq are mutually consistent; a
        write racing the subsequent (unlocked) decode only makes the token
        conservative — its rows re-decode on the next delta and dedup."""
        with self.locked("lock_wait_ms", "scan"):
            return ScanToken(
                self.data_version,
                self.destructive_version,
                frozenset(fm.file_id
                          for fm in self.summary.version.all_files()),
                # applied_seq, NOT wal.next_seq-1: a raft-replicated entry
                # sits in the WAL before it commits/applies. A token taken
                # in that window must not claim the entry's seq — the
                # delta path (DeltaVnodeView, seq > token.mem_seq) would
                # then skip its rows forever once they apply.
                self.applied_seq)

    # ------------------------------------------------------------------ boot
    def _replay_wal(self) -> bool:
        """Replay this vnode's own entries past the flushed watermark.
        Entries with a raft term (>= 1) were appended by the replication
        layer, and only raft knows which of them committed: the replay
        stops at the first one and leaves it and the rest to the vnode's
        raft member, which applies them as its commit index advances (or
        to replay_raft_tail when the replica set has one member). → True
        when it stopped so."""
        flushed = self.summary.version.flushed_seq
        for entry in self.wal.replay(from_seq=flushed + 1):
            if entry.term:
                return True
            self._apply_entry(entry.entry_type, entry.data, entry.seq, logged=True)
        return False

    def replay_raft_tail(self):
        """Apply the WAL entries that the open left to raft, for a vnode
        that no raft member drives (its replica set has one member)."""
        with self.lock:
            if not self._raft_tail:
                return
            for entry in self.wal.replay(from_seq=self.applied_seq + 1):
                self._apply_entry(entry.entry_type, entry.data, entry.seq,
                                  logged=True)
            self._raft_tail = False

    # ------------------------------------------------------------------ write
    def write(self, batch: WriteBatch, sync: bool = False) -> int:
        """Log + apply one write batch; → assigned WAL seq."""
        with self.locked("write.lock_wait_ms", "write"):
            with stages.stage("write.wal_ms"):
                # stamp schema version + column ids into the WAL payload
                # so a post-crash replay can re-key fields by id across
                # RENAME/DROP
                batch.stamp_schema(self.schemas)
                data = batch.encode()
                seq = self.wal.append(WalEntryType.WRITE, data)
                if sync:
                    self.wal.sync()
            self._apply_write(batch, seq)
            if seq > self.applied_seq:
                self.applied_seq = seq
            return seq

    @contextmanager
    def locked(self, wait: str, holder: str):
        """Hold the vnode lock as `holder`, its acquisition timed as the
        stage `wait`. A wait that found the lock held tags `holder` with
        the work that held it last, read once the lock is handed over:
        `write`, `scan`, `flush_ms` or `compact_ms` (a flush or compaction
        inside a write names the rest of the write's hold too); a hold
        that names nothing (replay, replication, DDL, snapshots) leaves
        the name before it, and "none" means no named hold yet."""
        with stages.stage(wait) as span:
            if not self.lock.acquire(blocking=False):
                self.lock.acquire()
                span.set_tag("holder", self._holder or "none")
        self._holder = holder
        try:
            yield
        finally:
            self.lock.release()

    def apply_entry(self, entry_type: int, data: bytes, seq: int):
        """Apply a replicated log entry (replication layer path): the entry
        is already durable in this vnode's WAL at `seq`."""
        with self.lock:
            self._apply_entry(entry_type, data, seq, logged=True)
            if seq > self.raft_seq:
                self.raft_seq = seq

    def _apply_entry(self, entry_type: int, data: bytes, seq: int, logged: bool):
        # advance even for no-op entries (blank/membership, empty deletes):
        # the entry's full effect is reflected once this call returns
        if seq > self.applied_seq:
            self.applied_seq = seq
        if entry_type == WalEntryType.WRITE:
            self._apply_write(WriteBatch.decode(data), seq)
        elif entry_type == WalEntryType.DELETE_TABLE:
            obj = msgpack.unpackb(data, raw=False)
            self._apply_drop_table(obj["table"])
        elif entry_type == WalEntryType.DELETE_SERIES:
            obj = msgpack.unpackb(data, raw=False)
            self._apply_delete_series(obj["table"], obj["sids"])
        elif entry_type == WalEntryType.UPDATE_TAGS:
            obj = msgpack.unpackb(data, raw=False)
            self._apply_update_tags(obj["table"], obj["old_keys"], obj["new_keys"])
        elif entry_type == WalEntryType.DELETE_TIME_RANGE:
            obj = msgpack.unpackb(data, raw=False)
            sids = obj.get("sids")
            if obj.get("doms") is not None:
                # replicated deletes carry the tag predicate and resolve
                # series ids at APPLY time on each replica — identical by
                # determinism, and robust to replica index skew
                from ..models.predicate import ColumnDomains

                doms = ColumnDomains.from_wire(obj["doms"])
                if not doms.is_all:
                    sids = self.index.get_series_ids_by_domains(
                        obj["table"], doms)
                    if len(sids) == 0:
                        return
            self._apply_delete_time_range(obj["table"], sids,
                                          obj["min_ts"], obj["max_ts"])
        # RAFT_BLANK/MEMBERSHIP: no storage effect

    def _apply_write(self, batch: WriteBatch, seq: int):
        with stages.stage("write.memcache_ms"):
            self.data_version += 1
            for table, series_list in batch.tables.items():
                # the batch's schema stamp vs the live schema: replayed
                # entries written before a RENAME/DROP re-key their fields
                # by column id (live writes stamp and apply under one lock,
                # so remap is None)
                remap = batch.replay_remap(table, self.schemas.get(table))
                for sr in series_list:
                    sid = self.index.add_series_if_not_exists(sr.key)
                    if remap is not None:
                        fields = {}
                        for name, v in sr.fields.items():
                            tgt = remap.get(name, name)
                            if tgt is not None:   # None → column dropped
                                fields[tgt] = v
                        sr = SeriesRows(sr.key, sr.timestamps, fields)
                    self.active.write_series(table, sid, sr, seq)
        if self.active.should_flush():
            self.flush(trigger="inline")

    # ------------------------------------------------------------------ flush
    def switch_to_immutable(self):
        with self.lock:
            if self.active.is_empty:
                return
            self.active.mark_immutable()
            self.immutables.append(self.active)
            self.active = MemCache(self.vnode_id, self.memcache_bytes)

    def flush(self, sync: bool = True, trigger: str = "explicit"):
        """Rotate active cache and persist ALL immutables to L0 files.
        `trigger` tags the flush's span: "inline" (a write filled the
        memory cache), "reclaim" (the memory broker) or "explicit"."""
        flushed = False
        with self.lock, stages.stage("flush_ms") as span:
            self._holder = "flush_ms"
            self.switch_to_immutable()
            if self.immutables:
                self.data_version += 1
                flushed = True
            rows = written = 0
            for cache in self.immutables:
                rows += sum(sd.n_rows for sd in cache.series.values())
                fid = self.summary.next_file_id()
                path = os.path.join(self.dir, "delta", f"_{fid:06d}.tsm")
                edit = flush_memcache(cache, fid, path, self.schemas)
                if edit is not None:
                    written += sum(fm.size for fm in edit.add_files)
                    self.summary.apply(edit, sync=sync)
            span.set_tag("trigger", trigger).set_tag("rows", rows) \
                .set_tag("bytes", written)
            self.immutables.clear()
            self.index.sync()
            self.wal.sync()
            self.wal.purge_to(self.summary.version.flushed_seq + 1)
        cb = self.on_flush
        if flushed and cb is not None:
            # outside the lock: listeners must never block the write path
            try:
                cb()
            except Exception:
                stages.count_error("flush.listener")

    def rename_mem_field(self, table: str, old: str, new: str):
        """ALTER ... RENAME COLUMN: re-key buffered (unflushed) rows so
        in-memory data follows the column the same way id-resolved TSM
        chunks do — without this, renaming a column to a previously-used
        name would conflate the two columns' unflushed values."""
        with self.lock:
            # in-place memcache edit: invisible to the (file set, seq)
            # token, so delta merges must not span it (the schema_version
            # cache key already isolates it; this is defense in depth)
            self.destructive_version += 1
            for cache in [self.active, *self.immutables]:
                for (t, _sid), sd in cache.series.items():
                    if t == table and old in sd.field_chunks:
                        sd.field_chunks[new] = sd.field_chunks.pop(old)

    def drop_mem_field(self, table: str, name: str):
        """ALTER ... DROP COLUMN: purge buffered rows of the dropped
        field. Leftover name-keyed memcache chunks would otherwise be
        resurrected by a later RENAME/ADD that reuses the name (flushed
        chunks are immune: their dropped column id is never requested)."""
        with self.lock:
            self.destructive_version += 1
            for cache in [self.active, *self.immutables]:
                for (t, _sid), sd in cache.series.items():
                    if t == table:
                        sd.field_chunks.pop(name, None)

    # ------------------------------------------------------------------ compact
    def _compaction_exclude(self) -> frozenset:
        """File ids compaction must leave alone: cold-tiered files (their
        bytes live in the object store — storage/tiering.py) plus any hot
        file overlapping a cold file's time range. The overlap closure
        prevents resurrection: a rewrite landing at a level that outranks
        a cold file carrying a newer row version would flip
        last-write-wins. Backfill writes into an already-tiered window
        therefore freeze until the tiering job moves them too (documented
        limitation)."""
        from . import tiering

        cold = tiering.cold_ids(self.dir)
        if not cold:
            return frozenset()
        version = self.summary.version
        all_fms = version.all_files()
        ranges = [(fm.min_ts, fm.max_ts) for fm in all_fms
                  if fm.file_id in cold]
        out = set(cold)
        for fm in all_fms:
            if fm.file_id not in out and any(
                    fm.overlaps(lo, hi) for lo, hi in ranges):
                out.add(fm.file_id)
        return frozenset(out)

    def compact(self, force_level: int | None = None) -> bool:
        """Run at most one compaction round; → True if work was done."""
        with self.lock, stages.stage("compact_ms") as span:
            self._holder = "compact_ms"
            if self._promote_l0():
                return True
            req = self.picker.pick(self.summary.version,
                                   exclude=self._compaction_exclude())
            if req is None:
                return False
            fid = self.summary.next_file_id()
            span.set_tag("bytes_read", sum(f.size for f in req.files))
            edit = run_compaction(
                self.summary.version, req, fid,
                alloc_id=self.summary.next_file_id,
                max_out_bytes=self.picker.max_output_file_size,
                schemas=self.schemas)
            if edit is None:
                return False
            span.set_tag("bytes_written",
                         sum(f.size for f in edit.add_files))
            # bump only when the file set actually changes so no-op rounds
            # don't invalidate scan caches
            self.data_version += 1
            self.summary.apply(edit)
            gc_compacted_files(self.summary.version, edit)
            return True

    def _promote_l0(self) -> bool:
        """Rewrite-free level promotion (picker.pick_promotions): for
        L0→L1, link the physical file into tsm/ and drop the delta link
        (levels ≥1 share the tsm/ dir — a pure metadata flip). Crash-safe
        in every window: before the edit lands the meta still says the
        old level (its link intact, the new one is garbage for gc);
        after, the new level's link is the live one."""
        import dataclasses

        from .tombstone import tombstone_path as _tb

        version = self.summary.version
        promos = self.picker.pick_promotions(
            version, exclude=self._compaction_exclude())
        if not promos:
            return False
        adds = []
        for fm, target in promos:
            src = version.file_path(fm)
            new = dataclasses.replace(fm, level=target)
            dst = version.file_path(new)
            if dst != src:
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                if not os.path.exists(dst):
                    os.link(src, dst)
                if os.path.exists(_tb(src)) and not os.path.exists(_tb(dst)):
                    os.link(_tb(src), _tb(dst))
            adds.append(new)
        self.data_version += 1
        self.summary.apply(VersionEdit(
            add_files=adds, del_files=[fm.file_id for fm, _ in promos]))
        for fm, target in promos:
            src = version.file_path(fm)   # path at the OLD level
            new = dataclasses.replace(fm, level=target)
            if version.file_path(new) == src:
                continue
            for p in (src, _tb(src)):
                if os.path.exists(p):
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
        return True

    def quarantine_file(self, path: str | None = None,
                        file_id: int | None = None) -> int | None:
        """Contain a corrupt TSM file: durably drop it from the manifest
        (future scans never open it; the cached reader is closed by the
        VersionEdit apply) and rename it to `<path>.quarantine` — kept on
        disk as forensic evidence, invisible to the `.tsm`-suffix GC, and
        wiped by the next snapshot install (repair). Bumps both version
        counters so every ScanToken / scan-cache entry over this vnode
        invalidates. → the quarantined file_id, or None when the file is
        not (or no longer) referenced."""
        with self.lock:
            version = self.summary.version
            target = None
            for fm in version.all_files():
                if fm.file_id == file_id or (
                        path is not None
                        and os.path.abspath(version.file_path(fm))
                        == os.path.abspath(path)):
                    target = fm
                    break
            if target is None:
                return None
            fpath = version.file_path(target)
            self.summary.apply(VersionEdit(del_files=[target.file_id]))
            try:
                os.replace(fpath, fpath + ".quarantine")
            except OSError:
                pass   # already renamed / vanished: the manifest drop holds
            self.data_version += 1
            self.destructive_version += 1
            return target.file_id

    def quarantined_files(self) -> list[str]:
        """Paths of quarantined (renamed-aside) TSM files still on disk."""
        out = []
        for sub in ("delta", "tsm"):
            d = os.path.join(self.dir, sub)
            if os.path.isdir(d):
                out.extend(os.path.join(d, n) for n in sorted(os.listdir(d))
                           if n.endswith(".quarantine"))
        return out

    def compact_major(self) -> bool:
        """One-shot FULL compaction: merge every file of every level into
        time-partitioned, size-bounded files at one level (reference user
        COMPACT = full compaction). One pass over the data — unlike
        looping normal rounds, which against heavily-overlapping tiered
        levels would rewrite the tail repeatedly."""
        from .compaction import CompactReq

        with self.lock, stages.stage("compact_ms") as span:
            self._holder = "compact_ms"
            version = self.summary.version
            exclude = self._compaction_exclude()
            files = [f for lvl in range(0, 5)
                     for f in version.levels[lvl].values()
                     if f.file_id not in exclude]
            if len(files) <= 1:
                return False
            total = sum(f.size for f in files)
            # land everything at the smallest level whose budget holds it
            target = 1
            while target < 4 and total > self.picker.level_max_size(target):
                target += 1
            req = CompactReq(files, target)
            fid = self.summary.next_file_id()
            span.set_tag("bytes_read", total)
            edit = run_compaction(
                self.summary.version, req, fid,
                alloc_id=self.summary.next_file_id,
                max_out_bytes=self.picker.max_output_file_size,
                schemas=self.schemas)
            if edit is None:
                return False
            span.set_tag("bytes_written",
                         sum(f.size for f in edit.add_files))
            self.data_version += 1
            self.summary.apply(edit)
            gc_compacted_files(self.summary.version, edit)
            return True

    def file_snapshot(self) -> dict:
        """FILE-level snapshot (reference vnode_store.rs:129-213
        VnodeSnapshot = VersionEdit + file set shipped via DownloadFile):
        flush everything, then capture the physical files — TSM levels,
        summary manifest, index checkpoint/binlog — as relative-path blobs.
        The WAL is excluded: it IS the raft log being snapshotted around.

        Lock discipline: only the MANIFEST (file list + small mutable
        metadata) is captured under the vnode lock; TSM data files are
        immutable once written, so their bytes are read after release —
        a concurrent compaction that deletes one shows up as a missing
        file and triggers a retry, instead of stalling writes for the
        whole multi-GB read.

        A vnode holding quarantined files REFUSES to snapshot: its state
        machine no longer matches the applied log (the quarantined rows
        are gone), so serving the snapshot — to a raft follower or a
        repair fetch — would clone the data loss onto healthy replicas.
        Repair wipes the quarantine evidence on install, which is what
        re-enables snapshots afterwards."""
        if self.quarantined_files():
            raise StorageError(
                f"vnode {self.vnode_id} has quarantined files: snapshot "
                "refused (state diverged from the applied log; this "
                "replica must be repaired from a healthy peer first)")
        skip_top = {"wal", "hardstate"}
        for _attempt in range(5):
            with self.lock:
                self.flush(sync=True)
                files: dict[str, bytes] = {}
                big: list[str] = []
                for root, _dirs, names in os.walk(self.dir):
                    rel_root = os.path.relpath(root, self.dir)
                    if rel_root.split(os.sep)[0] in skip_top:
                        continue
                    for name in names:
                        if rel_root == "." and name == "hardstate":
                            continue
                        if name.endswith(".quarantine"):
                            continue   # forensic evidence, never shipped
                        rel = os.path.normpath(os.path.join(rel_root, name))
                        if name.endswith(".tsm"):
                            big.append(rel)   # immutable: read outside
                        else:
                            with open(os.path.join(root, name), "rb") as f:  # lint: disable=lock-blocking (small mutable files read under lock so the snapshot is a consistent cut)
                                files[rel] = f.read()
            try:
                for rel in big:
                    with open(os.path.join(self.dir, rel), "rb") as f:
                        files[rel] = f.read()
                return {"files": files, "digests": _digests(files)}
            except FileNotFoundError:
                continue   # compaction replaced the file set: re-capture
        # final attempt entirely under the lock (consistency over latency)
        with self.lock:
            self.flush(sync=True)
            files = {}
            for root, _dirs, names in os.walk(self.dir):
                rel_root = os.path.relpath(root, self.dir)
                if rel_root.split(os.sep)[0] in skip_top:
                    continue
                for name in names:
                    if rel_root == "." and name == "hardstate":
                        continue
                    if name.endswith(".quarantine"):
                        continue
                    rel = os.path.normpath(os.path.join(rel_root, name))
                    with open(os.path.join(root, name), "rb") as f:  # lint: disable=lock-blocking (final capture attempt deliberately under lock: consistency over latency)
                        files[rel] = f.read()
            return {"files": files, "digests": _digests(files)}

    def install_file_snapshot(self, snap: dict):
        """Replace this vnode's physical state with a snapshot, in place
        (the raft member and engine registry keep their object). Old
        readers stay valid on unlinked inodes; data_version invalidates
        every cache. Paths are CONFINED to the vnode dir — the snapshot
        arrives over the network and must never become a file-write
        primitive outside it."""
        import shutil

        base = os.path.realpath(self.dir)
        digests = snap.get("digests") or {}
        for rel in snap["files"]:
            if os.path.isabs(rel):
                raise StorageError(f"absolute path in snapshot: {rel!r}")
            dest = os.path.realpath(os.path.join(base, rel))
            if not (dest == base or dest.startswith(base + os.sep)):
                raise StorageError(f"path escapes vnode dir: {rel!r}")
            want = digests.get(rel)
            if want is not None and _sha256(snap["files"][rel]) != want:
                raise StorageError(
                    f"snapshot file {rel!r} corrupted in transit")
        with self.lock:
            self.summary.version.close()
            self.summary.close()
            self.index.close()
            for name in os.listdir(self.dir):
                if name in ("wal", "hardstate"):
                    continue
                path = os.path.join(self.dir, name)
                if os.path.isdir(path):
                    shutil.rmtree(path, ignore_errors=True)
                else:
                    os.unlink(path)
            for rel, raw in snap["files"].items():
                path = os.path.join(self.dir, rel)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as f:  # lint: disable=lock-blocking (snapshot install must be atomic vs readers; consistency over latency)
                    f.write(raw)
            self.summary = Summary(self.dir)
            self.index = TSIndex(os.path.join(self.dir, "index"))
            self.active = MemCache(self.vnode_id, self.memcache_bytes)
            self.immutables = []
            self.data_version += 1
            self.destructive_version += 1

    def checksum(self) -> str:
        """Content checksum of every live row, independent of physical
        layout (reference compaction/check.rs:99 ChecksumGroup): replicas
        of one raft group must agree regardless of flush/compaction state,
        so the hash runs over the logical merged scan in canonical
        (table, series key, time) order. Vectorized — whole-column buffers
        feed the hash, so multi-million-row vnodes answer within an RPC
        timeout instead of minutes of per-row python."""
        import hashlib

        import numpy as np

        from ..models.strcol import as_object_array
        from .scan import scan_vnode

        h = hashlib.sha256()
        with self.lock:
            # under the vnode lock: a concurrent snapshot install swaps
            # summary/index mid-scan otherwise (truncated-footer reads
            # while a lagging replica is being seeded)
            tables = set()
            for (table, _sid) in list(self.active.series.keys()):
                tables.add(table)
            for c in self.immutables:
                for (table, _sid) in c.series:
                    tables.add(table)
            for fm in self.summary.version.all_files():
                r = self.summary.version.reader(fm)
                tables.update(r.tables())
            batches = {t: scan_vnode(self, t) for t in sorted(tables)}  # lint: disable=lock-held-dispatch (checksum scan must see one version cut; consistency over latency)
        for table in sorted(tables):
            b = batches[table]
            if b.n_rows == 0:
                continue
            keys = [k.encode() if k is not None else b""
                    for k in b.series_keys]
            # canonical order: series key bytes, then time — via the rank
            # of each row's key so lexsort stays fully vectorized
            key_rank_of_series = np.argsort(
                np.argsort(np.array(keys, dtype=object)))
            key_rank = key_rank_of_series[b.sid_ordinal]
            order = np.lexsort((b.ts, key_rank))
            h.update(table.encode())
            for kb in sorted(keys):   # key SET in key order — layout-free
                h.update(kb)
            h.update(key_rank[order].astype(np.int64).tobytes())
            h.update(b.ts[order].astype(np.int64).tobytes())
            for name in sorted(b.fields):
                _vt, vals, valid = b.fields[name]
                h.update(name.encode())
                h.update(valid[order].astype(np.uint8).tobytes())
                v_ord = as_object_array(vals[order])
                if v_ord.dtype == object:
                    masked = np.where(valid[order], v_ord, "")
                    h.update("\x00".join(str(x) for x in masked).encode())
                else:
                    zero = np.zeros((), dtype=v_ord.dtype)
                    h.update(np.where(valid[order], v_ord, zero).tobytes())
        return h.hexdigest()

    def compact_full(self, max_rounds: int = 32):
        for _ in range(max_rounds):
            if not self.compact():
                break

    # ------------------------------------------------------------------ deletes
    def drop_table(self, table: str):
        with self.lock:
            data = msgpack.packb({"table": table})
            seq = self.wal.append(WalEntryType.DELETE_TABLE, data)
            self._apply_drop_table(table)
            self.applied_seq = max(self.applied_seq, seq)

    def _apply_drop_table(self, table: str):
        self.data_version += 1
        self.destructive_version += 1
        self.active.delete_table(table)
        for c in self.immutables:
            c.delete_table(table)
        for sid in self.index.table_series_ids(table):
            self.index.del_series(int(sid))
        for fm in self.summary.version.all_files():
            self.summary.version.tombstone(fm).add(
                [TombstoneEntry(table, None, -(2**63), 2**63 - 1)])

    def delete_series(self, table: str, sids: list[int]):
        with self.lock:
            data = msgpack.packb({"table": table, "sids": [int(s) for s in sids]})
            seq = self.wal.append(WalEntryType.DELETE_SERIES, data)
            self._apply_delete_series(table, sids)
            self.applied_seq = max(self.applied_seq, seq)

    def _apply_delete_series(self, table: str, sids):
        self.data_version += 1
        self.destructive_version += 1
        for c in [self.active, *self.immutables]:
            for sid in sids:
                c.delete_series(table, int(sid))
        for fm in self.summary.version.all_files():
            self.summary.version.tombstone(fm).add(
                [TombstoneEntry(table, int(s), -(2**63), 2**63 - 1) for s in sids])

    def delete_time_range(self, table: str, sids, min_ts: int, max_ts: int):
        """DELETE FROM t WHERE ... (reference vnode_store.rs:503)."""
        with self.lock:
            data = msgpack.packb({
                "table": table,
                "sids": [int(s) for s in sids] if sids is not None else None,
                "min_ts": int(min_ts), "max_ts": int(max_ts)})
            seq = self.wal.append(WalEntryType.DELETE_TIME_RANGE, data)
            self._apply_delete_time_range(table, sids, min_ts, max_ts)
            self.applied_seq = max(self.applied_seq, seq)

    def _apply_delete_time_range(self, table: str, sids, min_ts: int, max_ts: int):
        self.data_version += 1
        self.destructive_version += 1
        for c in [self.active, *self.immutables]:
            c.delete_time_range(table, sids, min_ts, max_ts)
        ents = ([TombstoneEntry(table, int(s), min_ts, max_ts) for s in sids]
                if sids is not None else [TombstoneEntry(table, None, min_ts, max_ts)])
        for fm in self.summary.version.all_files():
            if fm.overlaps(min_ts, max_ts):
                self.summary.version.tombstone(fm).add(ents)

    def _apply_update_tags(self, table: str, old_keys: list[bytes], new_keys: list[bytes]):
        """UPDATE tag values: re-key series (reference update_tags_value)."""
        self.data_version += 1
        self.destructive_version += 1
        for ob, nb in zip(old_keys, new_keys):
            old_key = SeriesKey.decode(ob)
            sid = self.index.get_series_id(old_key)
            if sid is None:
                continue
            self.index.rename_series(sid, SeriesKey.decode(nb))

    def update_tags(self, table: str, old_keys: list[SeriesKey], new_keys: list[SeriesKey]):
        with self.lock:
            data = msgpack.packb({
                "table": table,
                "old_keys": [k.encode() for k in old_keys],
                "new_keys": [k.encode() for k in new_keys]})
            seq = self.wal.append(WalEntryType.UPDATE_TAGS, data)
            self._apply_update_tags(table, [k.encode() for k in old_keys],
                                    [k.encode() for k in new_keys])
            self.applied_seq = max(self.applied_seq, seq)

    # ------------------------------------------------------------------ stats
    def series_count(self) -> int:
        return self.index.series_count()

    def disk_size(self) -> int:
        return sum(f.size for f in self.summary.version.all_files())

    def close(self):
        with self.lock:
            self.flush()
            self.wal.close()
            self.index.close()
            self.summary.close()


def _sha256(raw: bytes) -> str:
    import hashlib

    return hashlib.sha256(raw).hexdigest()


def _digests(files: dict[str, bytes]) -> dict[str, str]:
    """Per-file integrity digests shipped with a snapshot: install
    verifies them so transit corruption fails loudly instead of landing
    silently in the store."""
    return {rel: _sha256(raw) for rel, raw in files.items()}
