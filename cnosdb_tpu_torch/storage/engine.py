"""Engine facade: the per-node storage service owning all local vnodes.

Role-parity with the reference's TsKv (tskv/src/kvcore.rs:35-406 — Engine
trait impl: open/write/flush/drop, background compaction) plus VersionSet
(version_set.rs): a registry of VnodeStorage keyed by (owner, vnode_id),
schema propagation from meta, and background flush/compaction driving.
"""
from __future__ import annotations

import os
import threading

from ..models.points import WriteBatch
from ..models.schema import TskvTableSchema
from .compaction import Picker
from .vnode import VnodeStorage
from ..utils import lockwatch


class TsKv:
    def __init__(self, data_dir: str,
                 memcache_bytes: int = 128 * 1024 * 1024,
                 wal_sync: bool = False,
                 picker: Picker | None = None,
                 background_compaction: bool = True):
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self.memcache_bytes = memcache_bytes
        self.wal_sync = wal_sync
        self.picker = picker
        self.background_compaction = background_compaction
        self.lock = lockwatch.RLock("engine.registry")
        self.vnodes: dict[tuple[str, int], VnodeStorage] = {}
        self.schemas: dict[str, dict[str, TskvTableSchema]] = {}  # owner → tables
        # background workers drive compactions (reference CompactJob pool,
        # compaction/job.rs max_concurrent_compaction) so merges never sit
        # in the write path; per-vnode dedup + the vnode lock keep one
        # merge per vnode, workers parallelize ACROSS vnodes
        from concurrent.futures import ThreadPoolExecutor

        workers = max(1, min(4, (os.cpu_count() or 1) - 1) or 1)
        self._compactor = ThreadPoolExecutor(workers,
                                             thread_name_prefix="compact")
        self._compact_pending: set[tuple[str, int]] = set()
        # (owner, vnode_id) flush notifications — set by the materialized
        # rollup maintainer; must be cheap and non-blocking
        self.flush_listener = None
        # memory-governance plane: the memcache pool (active + immutable
        # caches = the unflushed-WAL rows) is reclaimed by flushing.
        # Registration is latest-wins, matching engine lifetime in-process.
        from ..server import memory as _memory

        _memory.register_pool("memcache",
                              usage_fn=self.memcache_bytes_used,
                              reclaim=self._reclaim_memcache)

    # ---------------------------------------------------------------- vnodes
    def vnode_dir(self, owner: str, vnode_id: int) -> str:
        return os.path.join(self.data_dir, "data", owner, str(vnode_id))

    def open_vnode(self, owner: str, vnode_id: int) -> VnodeStorage:
        with self.lock:
            key = (owner, vnode_id)
            v = self.vnodes.get(key)
            if v is None:
                v = VnodeStorage(
                    vnode_id, self.vnode_dir(owner, vnode_id),
                    schemas=self.schemas.setdefault(owner, {}),
                    memcache_bytes=self.memcache_bytes,
                    wal_sync=self.wal_sync,
                    picker=self.picker or Picker())
                v.on_flush = \
                    lambda o=owner, vid=vnode_id: self._notify_flush(o, vid)
                self.vnodes[key] = v
            return v

    def _notify_flush(self, owner: str, vnode_id: int):
        cb = self.flush_listener
        if cb is not None:
            cb(owner, vnode_id)

    def vnode(self, owner: str, vnode_id: int) -> VnodeStorage | None:
        v = self.vnodes.get((owner, vnode_id))
        if v is None and os.path.isdir(self.vnode_dir(owner, vnode_id)):
            return self.open_vnode(owner, vnode_id)
        return v

    def open_existing(self):
        """Reopen every vnode found on disk (node restart)."""
        base = os.path.join(self.data_dir, "data")
        if not os.path.isdir(base):
            return
        for owner in os.listdir(base):
            od = os.path.join(base, owner)
            if not os.path.isdir(od):
                continue
            for vid in os.listdir(od):
                if vid.isdigit():
                    self.open_vnode(owner, int(vid))

    def local_vnodes(self, owner: str) -> list[VnodeStorage]:
        """Every vnode of `owner`, including ones not yet opened this
        process (lazily opened from disk) — admin ops like drop/delete must
        reach on-disk vnodes, not just in-memory ones."""
        with self.lock:
            od = os.path.join(self.data_dir, "data", owner)
            if os.path.isdir(od):
                for vid in os.listdir(od):
                    if vid.isdigit() and (owner, int(vid)) not in self.vnodes:
                        self.open_vnode(owner, int(vid))
            return [v for (o, _), v in self.vnodes.items() if o == owner]

    # ---------------------------------------------------------------- schema
    def set_table_schema(self, owner: str, schema: TskvTableSchema):
        self.schemas.setdefault(owner, {})[schema.name] = schema

    def remove_table_schema(self, owner: str, table: str):
        self.schemas.get(owner, {}).pop(table, None)

    # ---------------------------------------------------------------- ops
    def write(self, owner: str, vnode_id: int, batch: WriteBatch,
              sync: bool = False) -> int:
        v = self.open_vnode(owner, vnode_id)
        seq = v.write(batch, sync=sync)
        if self.background_compaction:
            self._maybe_schedule_compact(owner, vnode_id, v)
        return seq

    def _maybe_schedule_compact(self, owner: str, vnode_id: int,
                                v: VnodeStorage):
        # cheap L0 check inline; the merge itself runs on the worker.
        # Either enough small files piled up, or a flush-sized file is
        # ready for the rewrite-free L1 promotion
        version = v.summary.version
        l0 = version.levels[0]
        promo_ready = False
        if l0:
            # mirror pick_promotions' oldest-first prefix + id rule — a
            # promote-sized file stuck behind a small older one must not
            # resubmit a guaranteed-no-op job on every write
            oldest = min(l0.values(), key=lambda f: f.file_id)
            promo_ready = (oldest.size >= v.picker.promote_file_size
                           and oldest.file_id
                           > max(version.levels[1], default=0))
        if len(l0) < v.picker.l0_trigger and not promo_ready:
            return
        key = (owner, vnode_id)
        with self.lock:
            if key in self._compact_pending:
                return
            self._compact_pending.add(key)

        def run():
            try:
                v.compact_full()
            finally:
                with self.lock:
                    self._compact_pending.discard(key)

        self._compactor.submit(run)

    def memcache_bytes_used(self) -> int:
        """Unflushed bytes across every open vnode (active + immutable
        caches) — the memcache pool's usage feed. Dirty read by design:
        a write racing this sum skews one broker sample, never a
        result."""
        total = 0
        for v in list(self.vnodes.values()):
            caches = [v.active, *v.immutables]
            total += sum(c.approx_bytes for c in caches)
        return total

    def _reclaim_memcache(self, target_bytes: int) -> int:
        """Broker reclaim callback: flush the fattest vnodes until
        `target_bytes` have been persisted (or nothing is left). Runs on
        whichever thread crossed the watermark — flushing inline IS the
        backpressure."""
        before = self.memcache_bytes_used()
        with self.lock:
            victims = sorted(
                self.vnodes.values(),
                key=lambda v: sum(c.approx_bytes
                                  for c in [v.active, *v.immutables]),
                reverse=True)
        freed = 0
        for v in victims:
            if freed >= target_bytes:
                break
            v.flush(sync=False, trigger="reclaim")
            freed = before - self.memcache_bytes_used()
        return max(0, freed)

    def flush_all(self, sync: bool = True):
        with self.lock:
            for v in self.vnodes.values():
                v.flush(sync=sync)

    def compact_all(self):
        """User-triggered COMPACT: full (major) compaction per vnode."""
        with self.lock:
            for v in self.vnodes.values():
                v.compact_major()

    def drop_table(self, owner: str, table: str):
        for v in self.local_vnodes(owner):
            v.drop_table(table)
        self.remove_table_schema(owner, table)

    def drop_database(self, owner: str):
        import shutil

        with self.lock:
            for key in [k for k in self.vnodes if k[0] == owner]:
                self.vnodes[key].close()
                del self.vnodes[key]
            self.schemas.pop(owner, None)
            d = os.path.join(self.data_dir, "data", owner)
            if os.path.isdir(d):
                from . import tiering

                for name in os.listdir(d):
                    tiering.purge_vnode(os.path.join(d, name))
                shutil.rmtree(d, ignore_errors=True)

    def close_database(self, owner: str):
        """Release a database's vnodes WITHOUT touching disk (soft DROP:
        files stay for RECOVER; purge later hard-deletes)."""
        with self.lock:
            for key in [k for k in self.vnodes if k[0] == owner]:
                self.vnodes[key].close()
                del self.vnodes[key]
            self.schemas.pop(owner, None)

    def drop_vnode(self, owner: str, vnode_id: int,
                   purge_cold: bool = False):
        """`purge_cold` also deletes the vnode's cold-tier objects
        (best-effort) — the tier-then-expire path: TTL tiers data first,
        then the drop reclaims both local disk and the object store."""
        import shutil

        with self.lock:
            key = (owner, vnode_id)
            v = self.vnodes.pop(key, None)
            if v:
                v.close()
            d = self.vnode_dir(owner, vnode_id)
            if purge_cold and os.path.isdir(d):
                from . import tiering

                tiering.purge_vnode(d)
            if os.path.isdir(d):
                shutil.rmtree(d, ignore_errors=True)

    def close(self):
        self._compactor.shutdown(wait=True)
        with self.lock:
            for v in self.vnodes.values():
                v.close()
            self.vnodes.clear()
