"""In-memory write cache (one active + N immutable per vnode).

Role-parity with the reference's MemCache (tskv/src/mem_cache/
memcache.rs:30-295, series_data.rs): per-series row storage that absorbs
writes and converts to columnar pages at flush. Kept deliberately simple —
per-series Python lists of appended row chunks; sorting, last-write-wins
dedup and null-mask construction happen once, vectorized, at
`series_batches()` (flush or read) time, not per write.
"""
from __future__ import annotations

import numpy as np

from ..models.points import SeriesRows
from ..models.schema import ValueType

# Per-row bookkeeping overhead charged on top of the payload bytes:
# timestamp (8) + WAL seq share + python list/chunk slots. The old flat
# _APPROX_ROW_BYTES = 48 heuristic ignored dtypes entirely, so a
# string-heavy workload blew far past the configured cap before
# should_flush() noticed while a sparse float workload flushed early;
# sizing is now dtype-aware (see _series_rows_bytes).
_ROW_OVERHEAD_BYTES = 16


def _series_rows_bytes(sr: SeriesRows) -> int:
    """Dtype-aware payload estimate for one appended chunk: actual
    ndarray nbytes where the chunk is typed, element sizes otherwise
    (strings cost their encoded length + an object-header share), plus
    8 bytes per row of timestamps and the per-row overhead."""
    n = len(sr.timestamps)
    total = n * (8 + _ROW_OVERHEAD_BYTES)
    for _name, (vt, vals) in sr.fields.items():
        nb = getattr(vals, "nbytes", None)
        if nb is not None:                      # typed ndarray chunk
            total += int(nb)
            continue
        if vt == int(ValueType.STRING):
            for v in vals:
                total += (len(v) if isinstance(v, (str, bytes)) else 0) + 49
        elif vt == int(ValueType.BOOLEAN):
            total += len(vals)
        else:                                   # numeric python lists
            total += 8 * len(vals)
    return total


class SeriesData:
    """Accumulated rows of one series inside a memcache."""

    __slots__ = ("sid", "table", "ts_chunks", "field_chunks", "n_rows",
                 "seq_chunks")

    def __init__(self, sid: int, table: str):
        self.sid = sid
        self.table = table
        self.ts_chunks: list[list[int]] = []
        # field → list[(row_offset, value_type, values)]; offset aligns the
        # chunk with its rows in the concatenated timestamp stream
        self.field_chunks: dict[str, list[tuple[int, int, list]]] = {}
        self.n_rows = 0
        # WAL seq per ts chunk (non-decreasing — appends follow log order);
        # lets a delta scan take only the chunk suffix newer than a token
        self.seq_chunks: list[int] = []

    def append(self, sr: SeriesRows, seq: int = 0):
        off = self.n_rows
        self.ts_chunks.append(sr.timestamps)
        self.seq_chunks.append(seq)
        self.n_rows += len(sr.timestamps)
        for name, (vt, vals) in sr.fields.items():
            self.field_chunks.setdefault(name, []).append((off, vt, vals))

    def suffix(self, after_seq: int) -> "SeriesData | None":
        """→ a SeriesData holding only the chunks with seq > after_seq
        (None when there are none). Shares the chunk lists' objects —
        callers must treat the result as read-only."""
        import bisect

        i = bisect.bisect_right(self.seq_chunks, after_seq)
        if i >= len(self.ts_chunks):
            return None
        nd = SeriesData(self.sid, self.table)
        nd.ts_chunks = self.ts_chunks[i:]
        nd.seq_chunks = self.seq_chunks[i:]
        nd.n_rows = sum(len(c) for c in nd.ts_chunks)
        if nd.n_rows == 0:
            return None
        base = sum(len(c) for c in self.ts_chunks[:i])
        for name, chunks in self.field_chunks.items():
            kept = [(off - base, vt, vals) for (off, vt, vals) in chunks
                    if off >= base]
            if kept:
                nd.field_chunks[name] = kept
        return nd

    def prefix(self, max_seq: int) -> "SeriesData | None":
        """→ a SeriesData holding only the chunks with seq <= max_seq
        (None when there are none). A field chunk belongs to it iff its
        row offset lies inside the timestamps kept, so a chunk that an
        apply is appending meanwhile is never seen. Shares the chunk
        lists' objects — callers must treat the result as read-only."""
        import bisect

        k = bisect.bisect_right(self.seq_chunks, max_seq)
        if k == 0:
            return None
        nd = SeriesData(self.sid, self.table)
        nd.ts_chunks = self.ts_chunks[:k]
        nd.seq_chunks = self.seq_chunks[:k]
        nd.n_rows = sum(len(c) for c in nd.ts_chunks)
        # list(): an apply may add a field meanwhile; its chunks only grow
        # at the end, so the ones past the rows kept are a tail
        for name, chunks in list(self.field_chunks.items()):
            j = len(chunks)
            while j and chunks[j - 1][0] >= nd.n_rows:
                j -= 1
            if j:
                nd.field_chunks[name] = chunks[:j]
        return nd

    def materialize(self) -> tuple[np.ndarray, dict[str, tuple[ValueType, np.ndarray, np.ndarray]], np.ndarray]:
        """→ (sorted unique ts, {field: (vt, values, valid_mask)}, order)

        Sorts by time. Duplicate timestamps merge PER FIELD: each field
        takes its latest non-missing value across the duplicate rows
        (reference memcache RowData::extend — a later partial row overrides
        only the fields it carries). Typed-array and None-free list chunks
        materialize fully vectorized; only chunks actually carrying Nones
        pay a per-element pass.
        """
        if len(self.ts_chunks) == 1:
            ts = np.asarray(self.ts_chunks[0], dtype=np.int64)
        else:
            ts = np.concatenate(
                [np.asarray(c, dtype=np.int64) for c in self.ts_chunks]) \
                if self.ts_chunks else np.empty(0, dtype=np.int64)
        n = len(ts)
        order = np.argsort(ts, kind="stable")  # stable: append order within ties
        ts_sorted = ts[order]
        group_starts = _group_starts(ts_sorted)
        uts = ts_sorted[group_starts]
        out_fields: dict[str, tuple[ValueType, np.ndarray, np.ndarray]] = {}
        idx = np.arange(n, dtype=np.int64)
        for name, chunks in self.field_chunks.items():
            vt = ValueType(chunks[0][1])
            np_dtype = vt.numpy_dtype()
            typed = np_dtype is not object
            vals_full = (np.zeros(n, dtype=np_dtype) if typed
                         else np.empty(n, dtype=object))
            valid_full = np.zeros(n, dtype=bool)
            for off, _vt, vals in chunks:
                m = len(vals)
                if typed and isinstance(vals, np.ndarray):
                    vals_full[off:off + m] = vals
                    valid_full[off:off + m] = True
                elif typed and None not in vals:
                    vals_full[off:off + m] = np.asarray(vals, dtype=np_dtype)
                    valid_full[off:off + m] = True
                else:
                    for i, v in enumerate(vals):
                        if v is not None:
                            vals_full[off + i] = v
                            valid_full[off + i] = True
            vals_s = vals_full[order]
            valid_s = valid_full[order]
            # per-group index of last valid row (-1 if none), vectorized
            score = np.where(valid_s, idx, -1)
            last_valid = np.maximum.reduceat(score, group_starts) if n else score
            valid_out = last_valid >= 0
            gather = np.clip(last_valid, 0, None)
            vals_out = vals_s[gather]
            if not typed:
                vals_out = _typed_array(vals_out, valid_out, vt)
            out_fields[name] = (vt, vals_out, valid_out)
        return uts, out_fields, order

    def time_range(self) -> tuple[int, int]:
        lo, hi = 2**63 - 1, -(2**63)
        for c in self.ts_chunks:
            a = np.asarray(c, dtype=np.int64)
            if len(a):
                lo = min(lo, int(a.min()))
                hi = max(hi, int(a.max()))
        return lo, hi


def _group_starts(sorted_arr: np.ndarray) -> np.ndarray:
    """Indices where a new run of equal values begins in a sorted array."""
    n = len(sorted_arr)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    starts = np.empty(n, dtype=bool)
    starts[0] = True
    starts[1:] = sorted_arr[1:] != sorted_arr[:-1]
    return np.nonzero(starts)[0]


def _typed_array(obj_vals: np.ndarray, valid: np.ndarray, vt: ValueType) -> np.ndarray:
    np_dtype = vt.numpy_dtype()
    if np_dtype is object:
        out = np.empty(len(obj_vals), dtype=object)
        out[:] = [v if m else "" for v, m in zip(obj_vals, valid)]
        return out
    out = np.zeros(len(obj_vals), dtype=np_dtype)
    if valid.any():
        idx = np.nonzero(valid)[0]
        out[idx] = np.array([obj_vals[i] for i in idx], dtype=np_dtype)
    return out


class MemCache:
    """Active or immutable write cache for one vnode."""

    def __init__(self, vnode_id: int, max_bytes: int = 128 * 1024 * 1024):
        self.vnode_id = vnode_id
        self.max_bytes = max_bytes
        self.series: dict[tuple[str, int], SeriesData] = {}
        self.approx_bytes = 0
        # row-column count (rows × (1 + fields)) kept separately so the
        # reference's usage gauge stays exact while approx_bytes carries
        # the real dtype-aware payload size
        self.rowcols = 0
        self.min_seq: int | None = None
        self.max_seq: int = 0
        self.min_ts = 2**63 - 1
        self.max_ts = -(2**63)
        self.immutable = False

    def write_series(self, table: str, sid: int, sr: SeriesRows, seq: int):
        assert not self.immutable, "write to immutable memcache"
        key = (table, sid)
        sd = self.series.get(key)
        if sd is None:
            sd = self.series[key] = SeriesData(sid, table)
        sd.append(sr, seq)
        nb = len(sr.timestamps)
        self.approx_bytes += _series_rows_bytes(sr)
        self.rowcols += nb * (1 + len(sr.fields))
        if self.min_seq is None:
            self.min_seq = seq
        self.max_seq = max(self.max_seq, seq)
        if len(sr.timestamps):
            from ..models.points import ts_bounds

            lo, hi = ts_bounds(sr.timestamps)
            self.min_ts = min(self.min_ts, lo)
            self.max_ts = max(self.max_ts, hi)

    @property
    def is_empty(self) -> bool:
        return not self.series

    def should_flush(self) -> bool:
        return self.approx_bytes >= self.max_bytes

    @property
    def usage_size(self) -> int:
        """The reference's cache-memory estimate (80 bytes per
        row-column: a 1-row single-field write reads 160 —
        vnode_cache_size.slt), decoupled from the flush-threshold
        accounting so dtype-aware sizing can't change gauge parity."""
        return self.rowcols * 80

    def mark_immutable(self):
        self.immutable = True

    def series_batches(self):
        """Yield (table, sid, ts, fields) in sorted (table, sid) order —
        flush consumes this to write a delta TSM file."""
        for (table, sid) in sorted(self.series.keys()):
            sd = self.series[(table, sid)]
            ts, fields, _ = sd.materialize()
            yield table, sid, ts, fields

    def delete_series(self, table: str, sid: int):
        self.series.pop((table, sid), None)

    def delete_table(self, table: str):
        for key in [k for k in self.series if k[0] == table]:
            del self.series[key]

    def delete_time_range(self, table: str, sids, min_ts: int, max_ts: int):
        """Row-level delete inside cache (reference memcache delete):
        rebuild affected series without rows in [min_ts, max_ts]."""
        sidset = set(int(s) for s in sids) if sids is not None else None
        for (tbl, sid), sd in list(self.series.items()):
            if tbl != table or (sidset is not None and sid not in sidset):
                continue
            ts, fields, _ = sd.materialize()
            keep = (ts < min_ts) | (ts > max_ts)
            if keep.all():
                continue
            nd = SeriesData(sid, tbl)
            if keep.any():
                kts = ts[keep].tolist()
                nf = {}
                for name, (vt, vals, valid) in fields.items():
                    v = [vals[i] if valid[i] else None for i in np.nonzero(keep)[0]]
                    nf[name] = (int(vt), v)
                from ..models.series import SeriesKey
                # the rebuilt chunk carries the cache's max seq: it holds
                # survivors of older writes, so a delta suffix taken at an
                # older token must include it (the delete itself also bumps
                # destructive_version, which forces a full rescan anyway)
                nd.append(SeriesRows(SeriesKey(tbl, []), kts, nf),
                          self.max_seq)
                self.series[(tbl, sid)] = nd
            else:
                del self.series[(tbl, sid)]

    def suffix_view(self, after_seq: int) -> "MemCache | None":
        """→ a read-only MemCache exposing only rows appended with WAL
        seq > after_seq, or None when this cache has nothing newer. Used
        by the delta scan (storage/scan.DeltaVnodeView) so an incremental
        rescan decodes only post-token memcache chunks."""
        if self.max_seq <= after_seq:
            return None
        out = MemCache(self.vnode_id, self.max_bytes)
        out.immutable = True
        out.min_seq = self.min_seq
        out.max_seq = self.max_seq
        # list(): scans run without the vnode lock, so a concurrent write
        # may grow the dict mid-iteration (same discipline as _series_parts)
        for key, sd in list(self.series.items()):
            suf = sd.suffix(after_seq)
            if suf is not None:
                out.series[key] = suf
        return out if out.series else None
