"""Mesh-native aggregate execution: shard-parallel kernels + collective merge.

The multi-vnode aggregate path the executor uses by default
(sql/executor._exec_aggregate_batches) runs one kernel per scan batch on
a thread pool, pulls every batch's [segments] partials to the host, and
merges them with numpy (`_merge_results_vec`). This lane replaces the
whole fan-out for on-mesh batches: every batch's rows upload once with a
`NamedSharding(mesh, P("shard"))` layout (batch i → shard i//slots, so
vnode placement IS the sharding spec), and ONE jit program per column
computes per-shard segment partials and folds them across the mesh in
global batch order through XLA collectives
(parallel/distributed_agg.mesh_merge_kernel). No per-batch host partial
ever materializes — the merge happens on the interconnect, and the host
fetches only the final [segments] arrays.

Semantics contract: the output AggResult is bit-identical to
`_merge_results_vec` over the legacy per-batch results — same glab/
bucket-code row ordering, same dtypes, same fold order for f64 sums,
same (ts, batch-order) first/last tie-breaking — so
`sql/executor._finalize_single` consumes it unchanged, and CNOSDB_MESH=0
(or any decline) falls back to the byte-identical legacy path.

Every early exit books a reason via `parallel.mesh.count_outcome`
(`cnosdb_mesh_total{lane,reason}`, enforced by the mesh-accounting lint
rule); engagements book `("exec", "engaged")` + `("merge",
"collective")`, which is how the zero-host-merge acceptance is asserted.

Fault surface: `mesh.collective` fires just before the collective phase
— the nemesis `device_loss` kind arms it to kill a mesh participant
mid-collective, and the lane answers by declining (reason
`device_loss`), which IS the transparent fallback to the host/RPC merge.
"""
from __future__ import annotations

import os
import weakref

import numpy as np

from .. import faults
from ..models.schema import ValueType
from ..utils import stages
from .tpu_exec import AggResult, host_group_layout, host_row_mask

faults.register_point(
    "mesh.collective", __name__,
    desc="mesh exec lane, upload + collective merge kernel: a failure "
         "here is a device lost mid-collective — the lane books "
         "device_loss and the query transparently falls back to the "
         "legacy host-merge path")

_MESH_FUNCS = {"count", "sum", "min", "max", "first", "last"}
_NUMERIC_VTS = (ValueType.FLOAT, ValueType.INTEGER)

# cells = devices × slots × padded segments of the gathered fold operand;
# past this the collective's memory beats the host merge it replaces
_MAX_FOLD_CELLS = 1 << 24


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _declined(reason: str):
    from ..parallel import mesh

    mesh.count_outcome("exec", reason)
    return None


# ------------------------------------------------------------ prep cache
# Warm repeat queries (dashboards, the bench sweep) re-aggregate the same
# scan snapshot: the sharded device operands are pure functions of
# (batch set, group shape) for unfiltered queries, so they cache on the
# lead batch. Accounted to the memory broker as its own pool — reclaim
# drops the device arrays, the next query re-stages.
# ScanBatch is an eq-comparing dataclass (unhashable), so a WeakSet
# can't hold it — track weak refs keyed by id() instead, pruned by the
# ref callback when the batch is collected.
_PREP_REFS: dict[int, "weakref.ref"] = {}


def _live_prep_batches():
    for b in [r() for r in list(_PREP_REFS.values())]:
        if b is not None:
            yield b


def prep_bytes() -> int:
    total = 0
    for b in _live_prep_batches():
        entry = getattr(b, "_mesh_prep", None)
        if entry is not None:
            total += entry[1].get("est_bytes", 0)
    return total


def prep_clear(target_bytes: int = 0) -> int:
    freed = 0
    for b in _live_prep_batches():
        entry = getattr(b, "_mesh_prep", None)
        if entry is None:
            continue
        freed += entry[1].get("est_bytes", 0)
        b._mesh_prep = None
        if freed >= target_bytes > 0:
            break
    return freed


def _register_prep_pool() -> None:
    from ..server import memory as _memory

    _memory.register_pool("mesh_prep", usage_fn=prep_bytes,
                          reclaim=prep_clear)


_register_prep_pool()


def _canon(v):
    """NaN-canonical dict key (the executor's _canon_group_key rule)."""
    if isinstance(v, (float, np.floating)) and v != v:
        return "__nan__"
    return v


def try_mesh_aggregate(batches, query):
    """Run the whole multi-batch aggregate on the execution mesh.

    → a fully merged AggResult (bit-identical to the legacy per-batch
    kernel fan-out + `_merge_results_vec`) for `_finalize_single`, or
    None after booking a decline reason — the caller then takes the
    legacy path unchanged.
    """
    from ..parallel import mesh

    if not mesh.enabled():
        return _declined("disabled")
    aggs = query.aggs
    if any(a.func not in _MESH_FUNCS for a in aggs):
        return _declined("agg_func")
    if query.group_fields and \
            os.environ.get("CNOSDB_MESH_FIELDS", "0") != "1":
        # string/numeric field group axes merge through the dict path in
        # the legacy engine, whose row order this lane cannot reproduce;
        # opt in (parity tests and the bench do) when ORDER BY pins it
        return _declined("group_fields")
    if any(not getattr(b, "_mesh_local", False) for b in batches):
        # off-mesh replica partials arrive over RPC msgpack — the
        # coordinator merges those on the host exactly as before
        return _declined("off_mesh")
    live = [b for b in batches if b.n_rows]
    if len(live) < 2:
        return _declined("single_batch")
    total_rows = sum(b.n_rows for b in live)
    if total_rows < _env_int("CNOSDB_MESH_MIN_ROWS", 65536):
        return _declined("few_rows")
    m = mesh.get_mesh()
    if m is None:
        return _declined("no_devices")
    n_dev = mesh.mesh_size(m)
    if n_dev < _env_int("CNOSDB_MESH_MIN_DEVICES", 2):
        return _declined("few_devices")
    for b in live:
        for a in aggs:
            if a.column is None or a.column == "time":
                continue
            f = b.fields.get(a.column)
            if f is None or f[0] not in _NUMERIC_VTS:
                # absent column (could be a tag → string agg), unsigned
                # bias games, booleans, strings: legacy lanes own those
                return _declined("value_dtype")
    try:
        prep = _build_prep(live, query, m, n_dev)
    except Exception:
        stages.count_error("mesh.plan")
        return _declined("plan_error")
    if prep is None:
        return _declined("segments")
    if prep["n_out"] == 0:
        # every row filtered out: the legacy merge's empty-result shape
        res = _empty_result(query)
        mesh.count_outcome("exec", "engaged")
        mesh.count_outcome("merge", "collective")
        return res
    try:
        faults.fire("mesh.collective")
        with stages.stage("mesh.collective_ms"):
            fetched = _run_collectives(prep, m)
    except Exception:
        # a mesh participant died mid-collective (nemesis device_loss,
        # real XLA failure): fall back to the host merge transparently
        stages.count_error("mesh.collective")
        return _declined("device_loss")
    with stages.stage("mesh.assemble_ms"):
        res = _assemble_merged(prep, query, fetched)
    mesh.count_outcome("exec", "engaged")
    mesh.count_outcome("merge", "collective")
    stages.count("mesh.rows", total_rows)
    stages.count("mesh.shards", n_dev)
    return res


def _col_wants(aggs) -> dict:
    wants: dict[str | None, set] = {}
    for a in aggs:
        if a.column is not None:
            wants.setdefault(a.column, set()).add(
                "count" if a.func == "count" else a.func)
    # sum/first/last validity and min/max `has` masks all derive from the
    # per-segment valid count, so every column always wants it
    for w in wants.values():
        w.add("count")
    return wants


def _legacy_sum_runs(b, gseg, mask, valid, col_fl, needs_rank, ordered,
                     prefer_flat):
    """Replicate the branch tpu_exec.launch_scan_aggregate takes for a
    CPU float-sum column, because the branches accumulate f64 in
    different orders. Returns None when the legacy path sums with a flat
    row-order scatter, else (rows, starts): the ascending row indices the
    legacy run kernel compresses to (None = every row) and the run start
    offsets within them (kernels.run_boundaries semantics — a new run at
    every segment or series change)."""
    from . import kernels

    # string first/last never reaches the mesh lane (value_dtype gate),
    # so legacy's fl_string term is always False here
    rank_based_fl = needs_rank and not ordered
    if (col_fl and rank_based_fl) or (prefer_flat and not col_fl):
        return None   # rank/scatter fallback kernels: flat
    n = b.n_rows
    all_valid = bool(valid.all())
    all_rows = mask is None or bool(mask.all())
    sel = None if all_rows else np.flatnonzero(mask)
    if all_rows and all_valid:
        starts = kernels.run_boundaries(gseg, b.sid_ordinal)
        if not col_fl and len(starts) > (n >> 2):
            return None   # fine-grained runs: legacy flat-scatters
        return None, starts
    if all_valid and sel is not None and not prefer_flat:
        starts = kernels.run_boundaries(gseg[sel], b.sid_ordinal[sel])
        if not col_fl and len(starts) > (len(sel) >> 2):
            return None
        return sel, starts
    # nulls present (or filtered string-field grouping): legacy
    # compresses the valid∧selected rows and is always run-aware
    if sel is not None:
        vsub = valid[sel]
        idx2 = sel if vsub.all() else sel[vsub]
    else:
        idx2 = np.flatnonzero(valid)
    starts = kernels.run_boundaries(gseg[idx2], b.sid_ordinal[idx2])
    return idx2, starts


def _build_prep(live, query, m, n_dev):
    """Global segment layout + sharded device operands (cached on the
    lead batch for unfiltered repeats). → prep dict, or None when the
    fold operand would blow the segment budget."""
    from .device_cache import put_sharded
    from .kernels import pad_rows, pad_segments
    from ..parallel.mesh import SHARD_AXIS
    from ..parallel.mesh import PartitionSpec as P

    wants = _col_wants(query.aggs)
    needs_rank = any(a.func in ("first", "last") for a in query.aggs)
    slots = -(-len(live) // n_dev)          # batches per shard, ceil
    cache_ok = query.filter is None
    key = (tuple((id(b), b.n_rows) for b in live),
           tuple(query.group_tags), tuple(query.group_fields),
           query.time_bucket, n_dev, slots, needs_rank,
           tuple(sorted((c, tuple(sorted(w))) for c, w in wants.items())))
    if cache_ok:
        hit = getattr(live[0], "_mesh_prep", None)
        if hit is not None and hit[0] == key:
            stages.count("mesh.plan_cache_hit")
            return hit[1]
    stages.count("mesh.plan_cache_miss")

    with stages.stage("mesh.plan_ms"):
        masks = [host_row_mask(b, query.filter) for b in live]
        keep = [i for i, (b, mk) in enumerate(zip(live, masks))
                if mk is None or mk.any()]
        live = [live[i] for i in keep]
        masks = [masks[i] for i in keep]
        if not live:
            prep = {"n_out": 0, "est_bytes": 0}
            return prep
        layouts = [host_group_layout(b, query.group_tags,
                                     query.group_fields, query.time_bucket)
                   for b in live]

        # ---- global tag groups: glab insertion order is batch-major over
        # each batch's local label table — _merge_results_vec's exact rule
        glab: dict[tuple, int] = {}
        tag_luts = []
        for hl in layouts:
            lut = np.empty(len(hl.group_labels), dtype=np.int64)
            for i, lab in enumerate(hl.group_labels):
                lut[i] = glab.setdefault(lab, len(glab))
            tag_luts.append(lut)
        lab_table = [None] * len(glab)
        for lab, g in glab.items():
            lab_table[g] = lab

        # ---- global field-group dictionaries (one per GROUP BY field)
        n_gf = len(query.group_fields)
        gdicts: list[dict] = [{} for _ in range(n_gf)]
        gvals: list[list] = [[] for _ in range(n_gf)]
        for hl in layouts:
            for fi in range(n_gf):
                for v in hl.gf_dicts[fi]:
                    ck = _canon(v)
                    if ck not in gdicts[fi]:
                        gdicts[fi][ck] = len(gdicts[fi])
                        gvals[fi].append(v)
        gdims = [len(d) + 1 for d in gdicts]   # +1: the NULL group slot
        gf_luts = []
        for hl in layouts:
            per_field = []
            for fi in range(n_gf):
                local = hl.gf_dicts[fi]
                lut = np.empty(len(local) + 1, dtype=np.int64)
                for i, v in enumerate(local):
                    lut[i] = gdicts[fi][_canon(v)]
                lut[len(local)] = gdims[fi] - 1   # local NULL → global NULL
                per_field.append(lut)
            gf_luts.append(per_field)

        n_groups = max(len(glab), 1)
        for d in gdims:
            n_groups *= d

        # ---- per-batch decode: local seg → (tag gid, field codes, bucket)
        per_batch_gid = []
        per_batch_bstart = []
        for bi, (b, hl) in enumerate(zip(live, layouts)):
            seg = hl.seg_ids.astype(np.int64)
            grp = seg // hl.n_buckets
            codes = []
            for fi in range(n_gf - 1, -1, -1):
                dim = hl.gf_dims[fi]
                codes.append(grp % dim)
                grp //= dim
            g = tag_luts[bi][grp]
            for fi in range(n_gf):
                g = g * gdims[fi] + gf_luts[bi][fi][codes[n_gf - 1 - fi]]
            per_batch_gid.append(g)
            if query.time_bucket is not None:
                per_batch_bstart.append(
                    hl.bucket_starts[seg % hl.n_buckets])
            else:
                per_batch_bstart.append(None)

        # ---- global bucket times: sorted union of PRESENT bucket starts
        if query.time_bucket is not None:
            parts = []
            for bs, mk in zip(per_batch_bstart, masks):
                parts.append(np.unique(bs if mk is None else bs[mk]))
            utimes = np.unique(np.concatenate(parts))
            n_t = len(utimes)
        else:
            utimes, n_t = None, 1
        n_seg = n_groups * n_t
        seg_pad = pad_segments(n_seg)
        if n_dev * slots * seg_pad > _MAX_FOLD_CELLS \
                or slots * seg_pad > np.iinfo(np.int32).max:
            return None

        # ---- per-row global segment ids + presence
        presence = np.zeros(n_seg, dtype=np.int64)
        gsegs = []
        for g, bs, mk in zip(per_batch_gid, per_batch_bstart, masks):
            gs = g * n_t
            if bs is not None:
                gs = gs + np.searchsorted(utimes, bs)
            gsegs.append(gs)
            presence += np.bincount(gs if mk is None else gs[mk],
                                    minlength=n_seg)

        # ---- global time-order rank (first/last tie-breaking: timestamp,
        # then batch order, then row order — the stable argsort of the
        # batch-order concatenation encodes all three)
        if needs_rank:
            cts = np.concatenate([b.ts for b in live])
            order = np.argsort(cts, kind="stable")
            grank = np.empty(len(cts), dtype=np.int32)
            grank[order] = np.arange(len(cts), dtype=np.int32)
            sorted_ts = cts[order]
        else:
            grank = sorted_ts = None

        # ---- shard-major padded layout: batch i → shard i//slots
        shard_rows = [0] * n_dev
        for i, b in enumerate(live):
            shard_rows[i // slots] += b.n_rows
        row_pad = pad_rows(max(max(shard_rows), 1))
        total = n_dev * row_pad
        seg_arr = np.zeros(total, dtype=np.int32)
        base_valid = np.zeros(total, dtype=bool)
        rank_arr = np.zeros(total, dtype=np.int32)
        col_host: dict[str, tuple] = {}
        for c in wants:
            vt = ValueType.INTEGER if c == "time" else live[0].fields[c][0]
            dt = np.int64 if vt == ValueType.INTEGER else np.float64
            col_host[c] = (vt, np.zeros(total, dtype=dt),
                           np.zeros(total, dtype=bool))
        cursor = [0] * n_dev
        concat_off = 0
        placements = []   # (batch idx, shard, slot, dest row offset)
        for i, b in enumerate(live):
            sh, slot = divmod(i, slots)
            d0 = sh * row_pad + cursor[sh]
            d1 = d0 + b.n_rows
            cursor[sh] += b.n_rows
            placements.append((i, sh, slot, d0))
            seg_arr[d0:d1] = (slot * seg_pad + gsegs[i]).astype(np.int32)
            mk = masks[i]
            base_valid[d0:d1] = True if mk is None else mk
            if grank is not None:
                rank_arr[d0:d1] = grank[concat_off:concat_off + b.n_rows]
            for c, (vt, vals, cvalid) in col_host.items():
                if c == "time":
                    vals[d0:d1] = b.ts
                    cvalid[d0:d1] = base_valid[d0:d1]
                else:
                    f = b.fields.get(c)
                    if f is not None:
                        vals[d0:d1] = np.asarray(f[1])
                        cvalid[d0:d1] = base_valid[d0:d1] & f[2]
            concat_off += b.n_rows

        # ---- f64 sum run plans: the legacy CPU host kernels are
        # run-aware (ufunc.reduceat per contiguous equal-segment run, run
        # partials folded per segment in run order), and reduceat's
        # within-run association is numpy's pairwise reduce — no device
        # scatter order reproduces it. So replicate the per-batch branch
        # decision tpu_exec.launch_scan_aggregate makes, stage the
        # per-run reduceat partials with the SAME numpy call, and let the
        # kernel fold runs → segments → shards on the mesh. Batches the
        # legacy path sums flat stage one run per row (bincount is a
        # sequential C loop, so row-order is exact for those). Integer
        # sums and every other aggregate are order-exact as flat scatters.
        run_host: dict[str, tuple] = {}
        from .placement import scan_device
        from .tpu_exec import _FORCE_DEVICE, _ordered_within_series
        cpu_mode = scan_device().type == "cpu" and not _FORCE_DEVICE()
        if cpu_mode:
            ordered = [_ordered_within_series(b) for b in live]
            for c, (vt, _vals, _cvalid) in col_host.items():
                if "sum" not in wants[c] or vt != ValueType.FLOAT:
                    continue
                col_fl = bool({"first", "last"} & wants[c])
                plans = []
                for i, b in enumerate(live):
                    plans.append(_legacy_sum_runs(
                        b, gsegs[i], masks[i], b.fields[c][2], col_fl,
                        needs_rank, ordered[i],
                        bool(layouts[i].gf_dims)))
                if not any(p is not None for p in plans):
                    continue   # every batch sums flat: one-level is exact
                nruns = []
                for bi, p in enumerate(plans):
                    if p is None:   # flat batch → one run per summed row
                        b = live[bi]
                        mk = masks[bi]
                        inc = b.fields[c][2] if mk is None \
                            else (mk & b.fields[c][2])
                        rows = np.flatnonzero(inc)
                        starts = np.arange(len(rows), dtype=np.int64)
                        plans[bi] = (rows, starts)
                    nruns.append(len(plans[bi][1]))
                shard_runs = [0] * n_dev
                for (i, sh, slot, d0), nr in zip(placements, nruns):
                    shard_runs[sh] += nr
                run_pad = max(max(shard_runs), 1)
                run_sums = np.zeros(n_dev * run_pad, dtype=np.float64)
                run_segs = np.full(n_dev * run_pad, slots * seg_pad,
                                   dtype=np.int32)
                cur_r = [0] * n_dev
                for (i, sh, slot, d0), p in zip(placements, plans):
                    rows, starts = p
                    b = live[i]
                    cv = np.asarray(b.fields[c][1])
                    sub = cv if rows is None else cv[rows]
                    nr = len(starts)
                    if nr == 0:
                        continue
                    off = sh * run_pad + cur_r[sh]
                    cur_r[sh] += nr
                    run_sums[off:off + nr] = np.add.reduceat(sub, starts)
                    gs = gsegs[i] if rows is None else gsegs[i][rows]
                    run_segs[off:off + nr] = slot * seg_pad + gs[starts]
                run_host[c] = (run_sums, run_segs, run_pad)

    with stages.stage("mesh.upload_ms"):
        spec = P(SHARD_AXIS)
        seg_dev = put_sharded(seg_arr, m, spec)
        rank_dev = put_sharded(rank_arr, m, spec)
        cols_dev = {}
        for c, (vt, vals, cvalid) in col_host.items():
            cols_dev[c] = (put_sharded(vals, m, spec),
                           put_sharded(cvalid, m, spec))
        runs_dummy = put_sharded(np.zeros(n_dev, dtype=np.int32), m, spec)
        runs_dev = {}
        for c, (rids, rsegs, rpad) in run_host.items():
            runs_dev[c] = (put_sharded(rids, m, spec),
                           put_sharded(rsegs, m, spec), rpad)

    est = seg_arr.nbytes + rank_arr.nbytes + base_valid.nbytes \
        + sum(v.nbytes + cv.nbytes for _, v, cv in col_host.values()) \
        + sum(r.nbytes + s.nbytes for r, s, _ in run_host.values()) \
        + (sorted_ts.nbytes if sorted_ts is not None else 0)
    prep = {
        "n_out": int((presence > 0).sum()), "presence": presence,
        "n_seg": n_seg, "seg_pad": seg_pad, "slots": slots,
        "n_t": n_t, "utimes": utimes, "lab_table": lab_table,
        "gdims": gdims, "gvals": gvals, "sorted_ts": sorted_ts,
        "wants": {c: tuple(sorted(w)) for c, w in wants.items()},
        "seg_dev": seg_dev, "rank_dev": rank_dev, "cols_dev": cols_dev,
        "runs_dev": runs_dev, "runs_dummy": runs_dummy,
        "est_bytes": int(est * 2),   # host staging + device twin
    }
    if cache_ok:
        lead = live[0]
        lead._mesh_prep = (key, prep)
        bid = id(lead)
        _PREP_REFS[bid] = weakref.ref(
            lead, lambda _r, _bid=bid: _PREP_REFS.pop(_bid, None))
    return prep


def _run_collectives(prep, m) -> dict:
    """One collective merge program per aggregated column; fetch the
    replicated [n_seg] outputs in a single host pull each."""
    from ..parallel.distributed_agg import mesh_merge_kernel

    n_seg = prep["n_seg"]
    outs = {}
    for c, (vals_dev, valid_dev) in prep["cols_dev"].items():
        rids, rsegs, rpad = prep["runs_dev"].get(
            c, (prep["runs_dummy"], prep["runs_dummy"], 0))
        out = mesh_merge_kernel(
            vals_dev, valid_dev, prep["seg_dev"], prep["rank_dev"],
            rids, rsegs, mesh=m, slots=prep["slots"],
            num_segments=prep["seg_pad"], wants=prep["wants"][c],
            run_pad=rpad)
        outs[c] = {k: v[:n_seg].cpu().numpy() for k, v in out.items()}  # lint: disable=host-sync (audited transfer point: one replicated pull per merged column)
    return outs


def _empty_result(query):
    cols = {t: np.empty(0, dtype=object) for t in query.group_tags}
    for t in query.group_fields:
        cols[t] = np.empty(0, dtype=object)
    if query.time_bucket is not None:
        cols["time"] = np.empty(0, dtype=np.int64)
    for a in query.aggs:
        cols[a.alias] = np.empty(0)
    return AggResult(cols, 0)


def _assemble_merged(prep, query, fetched) -> AggResult:
    """Merged partials → the AggResult `_merge_results_vec` would have
    produced: rows are the present segments in (group id, bucket) code
    order, with the same dtypes and validity rules."""
    presence = prep["presence"]
    n_t = prep["n_t"]
    sel = np.nonzero(presence > 0)[0]
    n_out = len(sel)
    out_cols: dict[str, np.ndarray] = {}
    out_valid: dict[str, np.ndarray] = {}
    grp = sel // n_t
    # field-group label columns peel innermost-first (NULL = top code)
    for fi in range(len(query.group_fields) - 1, -1, -1):
        dim = prep["gdims"][fi]
        codes = grp % dim
        grp = grp // dim
        vtab = np.empty(dim, dtype=object)
        vtab[:len(prep["gvals"][fi])] = prep["gvals"][fi]
        vtab[dim - 1] = None
        out_cols[query.group_fields[fi]] = vtab[codes]
    if query.group_tags:
        for i, t in enumerate(query.group_tags):
            col = np.empty(len(prep["lab_table"]), dtype=object)
            col[:] = [lab[i] for lab in prep["lab_table"]]
            out_cols[t] = col[grp]
    if query.time_bucket is not None:
        out_cols["time"] = prep["utimes"][sel % n_t]
    for a in query.aggs:
        if a.column is None:
            # count(*): presence IS the per-segment row count
            out_cols[a.alias] = presence[sel].astype(np.int64)
            continue
        col = fetched[a.column]
        cnt = col["count"][sel]
        has = cnt > 0
        if a.func == "count":
            out_cols[a.alias] = cnt.astype(np.int64)
        elif a.func in ("sum", "min", "max"):
            out_cols[a.alias] = col[a.func][sel]
            out_valid[a.alias] = has
        else:   # first / last
            out_cols[a.alias] = np.where(has, col[a.func][sel],
                                         np.zeros(1, col[a.func].dtype))
            rk = col[f"{a.func}_rank"][sel].astype(np.int64)
            ts = prep["sorted_ts"][
                np.clip(rk, 0, len(prep["sorted_ts"]) - 1)]
            out_cols[a.alias + "__ts"] = np.where(has, ts, 0)
            out_valid[a.alias] = has
    res = AggResult(out_cols, n_out, out_valid)
    return res
