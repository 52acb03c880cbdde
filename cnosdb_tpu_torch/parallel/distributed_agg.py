"""Distributed scan aggregation: per-shard partials + a gather merge.

The port of cnosdb_tpu/parallel/distributed_agg.py. Rows are sharded
over the mesh (ops/device_cache.put_sharded): every shard reduces its
rows into segment partials on its own device with X1
(ops/kernels.local_segment_partials), then the collective gathers the
shards' partials onto the lead device (`mesh.devices[0]`) in shard order
— peer copies between cards, no copy at all for logical shards on one
device — and combines them there: count/sum add, min/max take the
extremum, first/last pick the arg-min/max rank. The output lives on the
lead device, the one copy the host pulls (the JAX output is replicated
P() on every device, but only one copy was ever fetched).

The lane is single-controller, as in the JAX package: one process
drives every shard, so there is no torch.distributed process group.
Both programs are plain torch ops, like every jitted XLA program of the
port; neither is a Pallas kernel in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels import (local_segment_partials, pad_rows, pad_segments,
                           segment_sum)
from .mesh import PartitionSpec as P
from .mesh import SHARD_AXIS, mesh_size


def _spread_masked(seg: torch.Tensor, valid: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """int64 segment ids with every masked-out row (pad rows, filtered
    rows, NULLs) moved to segment `row % num_segments`. Such a row adds
    only identities (0, +0.0, the extrema, the rank fill keys), so the
    partials are unchanged; but the sharded layout pads each shard's
    tail to a power-of-two row count with segment 0, and millions of
    atomic adds to one address serialize on the card."""
    spread = torch.arange(seg.shape[0], dtype=torch.int64,
                          device=seg.device).remainder_(num_segments)
    return torch.where(valid, seg.to(torch.int64), spread)


def _gather(parts: list, lead: torch.device) -> torch.Tensor:
    """The collective: every shard's partial onto the lead device, in
    shard order → [d, n]."""
    return torch.stack([p.to(lead) for p in parts])


def _pick(ranks: torch.Tensor, vals: torch.Tensor, first: bool):
    """first/last across gathered rows: the row holding the least
    (first) or greatest (last) rank wins → (values, ranks)."""
    win = (torch.argmin if first else torch.argmax)(ranks, dim=0)[None, :]
    return vals.gather(0, win)[0], ranks.gather(0, win)[0]


def _dist_kernel(values, valid, seg_ids, rank, *, mesh, num_segments: int,
                 want_first: bool, want_last: bool) -> dict:
    """Sharded operands (device_cache.ShardedTensor) → [num_segments]
    merged partials on the lead device: the psum/pmin/pmax form, whose
    reduction order is the library's (f64 sums may differ from a
    sequential fold in the last bits)."""
    parts = [local_segment_partials(
        v, m, _spread_masked(s, m, num_segments), r,
        num_segments=num_segments,
        want_first=want_first, want_last=want_last)
        for v, m, s, r in zip(values.shards, valid.shards, seg_ids.shards,
                              rank.shards)]
    lead = mesh.devices[0]

    def gathered(name):
        return _gather([p[name] for p in parts], lead)

    out = {"count": gathered("count").sum(0, dtype=torch.int32),
           "sum": gathered("sum").sum(0),
           "min": gathered("min").amin(0),
           "max": gathered("max").amax(0)}
    for nm, want in (("first", want_first), ("last", want_last)):
        if want:
            out[nm], out[f"{nm}_rank"] = _pick(
                gathered(f"{nm}_rank"), gathered(nm), nm == "first")
    return out


def mesh_merge_kernel(values, valid, seg_ids, rank, run_sums, run_segs, *,
                      mesh, slots: int, num_segments: int,
                      wants: tuple[str, ...], run_pad: int = 0) -> dict:
    """Deterministic-order collective merge for the mesh exec lane
    (ops/mesh_exec.py): each shard holds up to `slots` whole scan
    batches, rows carry slot-local segment ids (slot · num_segments +
    seg), and per-(slot, segment) partials fold in GLOBAL BATCH ORDER —
    shard-major, slot-minor — after the gather onto the lead device.

    That fold order is the whole point: `sql/executor._merge_results_vec`
    adds per-batch partials in batch order with np.add.at, so a library
    sum (whose reduction order torch owns) could drift f64 sums by an
    ulp. The row-by-row fold reproduces the legacy addition order;
    min/max/first/last are order-insensitive and ride the same gather.

    When `run_pad` > 0 the host has staged per-run reduceat partials
    (`run_sums`, sharded like the rows) and `run_segs` maps runs to
    slot-local segments (unused run slots → the dead segment
    slots·num_segments, sliced off): each shard folds its run partials
    into its segments in run order (index_add_ over slots·num_segments +
    1 segments) instead of summing rows. run_pad == 0 keeps the flat
    row-order sum. → dict of [num_segments] tensors on the lead device.
    """
    want_first = "first" in wants
    want_last = "last" in wants
    two_level = run_pad > 0 and "sum" in wants
    n_local = slots * num_segments
    parts = []
    for i, (v, m, s, r) in enumerate(zip(values.shards, valid.shards,
                                         seg_ids.shards, rank.shards)):
        local = local_segment_partials(
            v, m, _spread_masked(s, m, n_local), r, num_segments=n_local,
            want_count=True, want_sum="sum" in wants and not two_level,
            want_min="min" in wants, want_max="max" in wants,
            want_first=want_first, want_last=want_last)
        if two_level:
            rsum, rseg = run_sums.shards[i], run_segs.shards[i]
            local["sum"] = segment_sum(rsum, rseg.to(torch.int64),
                                       n_local + 1)[:-1]
        parts.append(local)
    d = mesh_size(mesh)
    lead = mesh.devices[0]

    def gathered(name):
        return _gather([p[name] for p in parts], lead) \
            .reshape(d * slots, num_segments)

    def folded(name, op):
        a = gathered(name)
        if name == "count":
            a = a.to(torch.int64)
        acc = a[0]
        for k in range(1, d * slots):
            acc = op(acc, a[k])
        return acc

    out = {"count": folded("count", torch.add)}
    for nm, op in (("sum", torch.add), ("min", torch.minimum),
                   ("max", torch.maximum)):
        if nm in wants:
            out[nm] = folded(nm, op)
    for nm in ("first", "last"):
        if nm in wants:
            # ranks are globally unique per valid row, so the arg pick is
            # exact — ties exist only between empty slots' fill keys
            out[nm], out[f"{nm}_rank"] = _pick(
                gathered(f"{nm}_rank"), gathered(nm), nm == "first")
    return out


def merge_distinct_pairs(chunks: list[np.ndarray], n_values: int,
                         num_segments: int) -> np.ndarray:
    """Combine per-chunk/per-shard DISTINCT partials (sorted (group·nv +
    value) pair-code arrays from ops.kernels.sorted_pair_codes) into
    per-group distinct counts. The wire format is the plain sorted i64
    pair array — the same shape single-chip partials use, so multi-chip
    merging needs no new collective."""
    if not chunks:
        return np.zeros(num_segments, dtype=np.int64)
    pairs = np.unique(np.concatenate(chunks))
    nv = max(int(n_values), 1)
    return np.bincount((pairs // nv).astype(np.int64),
                       minlength=num_segments).astype(np.int64)[:num_segments]


def _pad(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    out = np.full(n, fill, dtype=a.dtype)
    out[:len(a)] = a
    return out


def distributed_aggregate_host(values: np.ndarray, valid: np.ndarray,
                               seg_ids: np.ndarray, rank: np.ndarray,
                               num_segments: int, mesh,
                               want_first: bool = False,
                               want_last: bool = False) -> dict:
    """Host wrapper: pad rows to devices × size class, shard, run, fetch."""
    from ..ops.device_cache import put_sharded

    n = len(values)
    d = mesh_size(mesh)
    np_pad = pad_rows(max(n, 1))
    if np_pad % d:
        np_pad = ((np_pad + d - 1) // d) * d
    ns_pad = pad_segments(max(num_segments, 1))
    spec = P(SHARD_AXIS)
    dv = put_sharded(_pad(values, np_pad), mesh, spec)
    dm = put_sharded(_pad(valid, np_pad, fill=False), mesh, spec)
    ds = put_sharded(_pad(seg_ids, np_pad, fill=0), mesh, spec)
    dr = put_sharded(_pad(rank, np_pad, fill=0), mesh, spec)
    out = _dist_kernel(dv, dm, ds, dr, mesh=mesh, num_segments=ns_pad,
                       want_first=want_first, want_last=want_last)
    host = {k: v[:num_segments].cpu().numpy() for k, v in out.items()}  # lint: disable=host-sync (audited transfer point: one pull per merged column)
    host["count"] = host["count"].astype(np.int64)
    return host
