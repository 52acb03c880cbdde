"""Fused device-side query programs over cached DeviceBatches (X2).

The port of cnosdb_tpu/ops/fused.py. One program per (filter expression,
aggregate set, segment shape) runs the ENTIRE per-vnode query — predicate
filter, time-bucket computation, group mapping, masked segment
reductions — against device-resident columns. Per query only the
group-of-series vector crosses to the device and one packed
[slots, ns_pad] float64 matrix comes back in one copy.

Bucket math: for interval I, batch epoch E and query origin O the JAX
package derives i32 constants on the host (`bucket_arith_params`, kept
here verbatim as the gate of the device path) so the TPU never touches an
i64. The card does int64 natively, so the program computes the same index
directly from the int64 timestamp offset t = ts - E:

    bucket = offset + floor((t + rA) / I),   rA = rA_s·1e9 + rA_ns

which equals the i32 form `offset + floor((sec + rA_s + carry) / I_s)`
term for term (floor division, so negative offsets round down too).

Filters run through `device_filter.row_mask` (AND, OR and NOT walked as
the host branch walks them) over the batch's columns as `FilterValue`s,
with `device_filter.TorchXP` as `xp`: sql/expr.py's operators and numpy
names, computed in numpy's types on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..sql.expr import Expr
from .device_cache import DeviceBatch
from .device_filter import TorchXP, filter_env, filter_key, row_mask
from .kernels import local_segment_partials, pad_segments

_kernel_cache: dict = {}

# observability: how many fused device programs launched this process
# (tests assert the device path actually engaged)
launch_count = 0

NS_PER_SEC = 1_000_000_000


def bucket_arith_params(epoch_ns: int, origin: int, interval: int,
                        bmin: int, max_span_ns: int = 0,
                        ) -> tuple[int, int, int, int] | None:
    """Host-side derivation of the i32 bucket constants; None if the
    interval is not a whole number of seconds or any i32 step could
    overflow (host path handles those)."""
    if interval % NS_PER_SEC != 0:
        return None
    i_s = interval // NS_PER_SEC
    if i_s >= 2**31:
        return None
    a = epoch_ns - origin
    qa = a // interval
    ra = a - qa * interval
    ra_s = ra // NS_PER_SEC
    ra_ns = ra % NS_PER_SEC
    # sec_adj = ts_sec + ra_s + carry must stay inside i32
    if max_span_ns // NS_PER_SEC + ra_s + 2 >= 2**31:
        return None
    offset = qa - bmin
    if not (-(2**31) < offset < 2**31):
        return None
    return int(i_s), int(ra_s), int(ra_ns), int(offset)


class PendingFused:
    """A launched (asynchronous) fused program; fetch() pulls the single
    packed output matrix in ONE device→host copy and unpacks it."""

    __slots__ = ("dev_out", "manifest", "num_segments", "int_slots", "agg_cols")

    def __init__(self, dev_out, manifest, num_segments, int_slots, agg_cols):
        self.dev_out = dev_out
        self.manifest = manifest
        self.num_segments = num_segments
        self.int_slots = int_slots
        self.agg_cols = agg_cols

    def fetch(self) -> dict[str, dict]:
        mat = self.dev_out.cpu().numpy()  # lint: disable=host-sync (audited transfer point: the [n_slots, ns_pad] matrix, one pull per program)
        bits = mat.view(np.int64)
        out: dict[str, dict] = {}
        for i, (col, agg) in enumerate(self.manifest):
            src = bits if self.int_slots[i] else mat
            out.setdefault(col, {})[agg] = src[i, :self.num_segments]
        presence = out.get("__presence__", {}).get("count")
        if presence is not None:
            # all-valid columns elide their count slot (it IS presence); a
            # column whose ONLY slot was count must still appear in out
            for col in self.agg_cols:
                out.setdefault(col, {}).setdefault("count", presence)
        return out


def launch_fused(dbatch: DeviceBatch, filter_expr: Expr | None,
                 group_of_series: np.ndarray, n_groups: int, n_buckets: int,
                 arith: tuple[int, int, int, int] | None,
                 col_wants: dict[str, dict]) -> PendingFused:
    global launch_count
    launch_count += 1
    num_segments = n_groups * n_buckets
    ns_pad = pad_segments(max(num_segments, 1))

    flt_key = filter_key(filter_expr)
    cols_key = tuple(sorted((c, tuple(sorted(w.items())))
                            for c, w in col_wants.items()))
    # ship every column the program touches: aggregated ones AND columns
    # the filter references but no aggregate does
    filt_cols = filter_expr.columns() if filter_expr is not None else set()
    present = [n for n in sorted(set(col_wants) | filt_cols)
               if n in dbatch.fields]
    dtypes_key = tuple((name, str(dbatch.fields[name][1].dtype))
                       for name in present)
    i_s, ra_s, ra_ns, offset = arith if arith is not None else (1, 0, 0, 0)
    use_bucket = arith is not None
    need_rank = any(w.get("want_first") or w.get("want_last")
                    for w in col_wants.values())
    valid_flags = tuple(dbatch.fields[n][2] is not None for n in present)
    int_cols = frozenset(name for name in present if not dbatch.fields[
        name][1].dtype.is_floating_point)
    key = (flt_key, cols_key, dtypes_key, ns_pad, n_buckets,
           use_bucket, i_s, dbatch.n_pad, need_rank, valid_flags)
    entry = _kernel_cache.get(key)
    if entry is None:
        entry = _build_kernel(filter_expr, col_wants, tuple(present), ns_pad,
                              n_buckets, use_bucket, i_s, need_rank,
                              valid_flags, int_cols)
        _kernel_cache[key] = entry
    fn, manifest, int_slots = entry

    ns = max(dbatch.n_series, 1)
    gos = np.zeros(ns, dtype=np.int64)
    gos[:len(group_of_series)] = group_of_series
    dev = dbatch.ts_rel.device
    dev_out = fn(dbatch, torch.from_numpy(gos).to(dev),
                 ra_s * NS_PER_SEC + ra_ns, offset)
    agg_cols = tuple(n for n in present if n in col_wants)
    return PendingFused(dev_out, manifest, num_segments, int_slots, agg_cols)


def _build_kernel(filter_expr: Expr | None, col_wants: dict,
                  present: tuple, ns_pad: int, n_buckets: int,
                  use_bucket: bool, i_s: int, need_rank: bool,
                  valid_flags: tuple, int_cols: frozenset):
    """→ (program, manifest, int_slots). The program packs every partial
    into ONE [n_slots, ns_pad] float64 matrix so the host fetches a single
    copy; an integer slot (int_slots[i]) carries its int64 bits, so an
    int64 sum, min or max comes back exact at any magnitude."""
    from .tpu_exec import is_conjunctive

    manifest: list[tuple[str, str]] = [("__presence__", "count")]
    agg_cols = [n for n in present if n in col_wants]
    valid_of = dict(zip(present, valid_flags))
    for name in agg_cols:
        w = col_wants[name]
        if valid_of.get(name):
            # nullable column: its count differs from presence → own slot
            manifest.append((name, "count"))
        for agg, flag in (("sum", "want_sum"), ("min", "want_min"),
                          ("max", "want_max"), ("first", "want_first"),
                          ("last", "want_last")):
            if w.get(flag):
                manifest.append((name, agg))
                if agg in ("first", "last"):
                    manifest.append((name, agg + "_rank"))
    int_slots = tuple(agg == "count" or agg.endswith("_rank")
                      or col in int_cols for col, agg in manifest)
    interval = i_s * NS_PER_SEC
    conjunctive = filter_expr is not None and is_conjunctive(filter_expr)

    def program(dbatch: DeviceBatch, group_of_series, ra: int, offset: int):
        dev = dbatch.ts_rel.device
        fields = {name: (dbatch.fields[name][1], dbatch.fields[name][2])
                  for name in present}
        n = dbatch.n_pad
        mask = torch.arange(n, device=dev) < dbatch.n_rows
        if filter_expr is not None:
            mask = mask & row_mask(filter_expr, filter_env(dbatch, present),
                                   TorchXP(dev), n, conjunctive)
        sid = dbatch.sid_ordinal
        if use_bucket:
            bucket = offset + torch.div(dbatch.ts_rel + ra, interval,
                                        rounding_mode="floor")
            bucket = torch.clamp(bucket, 0, n_buckets - 1)
        else:
            bucket = torch.zeros(n, dtype=torch.int64, device=dev)
        seg = torch.index_select(group_of_series, 0, sid) * n_buckets \
            + bucket
        seg = torch.where(mask, seg, 0)
        presence = torch.zeros(ns_pad, dtype=torch.int32,
                               device=dev).index_add_(
            0, seg, mask.to(torch.int32))
        results = {("__presence__", "count"): presence}
        rank = dbatch.rank_dev() if need_rank else seg
        for name in agg_cols:
            vals, valid = fields[name]
            w = col_wants[name]
            part = local_segment_partials(
                vals, (valid & mask) if valid is not None else mask, seg,
                rank,  # rank unused w/o first/last
                num_segments=ns_pad,
                # an all-valid column's count IS the presence count: skip
                # the extra scatter
                want_count=valid is not None,
                want_sum=w.get("want_sum", False),
                want_min=w.get("want_min", False),
                want_max=w.get("want_max", False),
                want_first=w.get("want_first", False),
                want_last=w.get("want_last", False))
            if "count" not in part:
                part["count"] = presence
            for agg, arr in part.items():
                results[(name, agg)] = arr
        return torch.stack([
            results[slot].to(torch.int64).view(torch.float64) if is_int
            else results[slot].to(torch.float64)
            for slot, is_int in zip(manifest, int_slots)])

    return program, manifest, int_slots
