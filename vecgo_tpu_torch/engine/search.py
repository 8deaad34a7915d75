"""Device half of the search planner (port of vecgo_tpu/engine/search.py).

The host half — manifest pruning, exact filter masks, strategy selection,
the plan cache — is the JAX package's (`_plan_snapshot`, `PlanCache`,
`_plan_filter_key`, `_plan_still_resident`). This module scores a planned
snapshot on the device: every source returns exact (distance, row) lists,
one sort on the device merges them, and one device-to-host copy brings the
best k + margin per query back for the MVCC visibility check.

Kernel launches and the result copies are asynchronous, so
`search_snapshot_stream` keeps several batches in flight: batch i+1 is
enqueued before batch i's results are read, and the host's visibility pass
over batch i runs while the card scans batch i+1.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from vecgo_tpu.engine.search import (
    CHUNK_B,
    _VIS_MARGIN,
    _VIS_MARGIN_CAP,
    PlanCache,
    _loc_lists,
    _plan_filter_key,
    _plan_snapshot,
    _plan_still_resident,
)
from vecgo_tpu.model import Metric, QueryStats, SearchOptions
from vecgo_tpu_torch._roadmap import not_ported
from vecgo_tpu_torch.ops import distance as D
from vecgo_tpu_torch.ops import topk as T

# Merge codes carry the source slot above the row: slot << 32 | row (int64).
_ROW_BITS = 32

__all__ = ["PlanCache", "search_snapshot", "search_snapshot_stream"]


def _dispatch_chunk(plan, qd, opts, options, exact_k: int = 0):
    """Score one query chunk against every planned source, on the device and
    without a host sync. Returns ([(seg_id, d [B,w], rows [B,w])], dist_comps)."""
    b = qd.shape[0]
    k = opts.k
    fetch_k = max(k * max(opts.refine_factor, 1), k)
    # The memtable and flat sources return exact distances, so their top
    # (k + churn margin) already holds the global top-k. Graph sources keep
    # the JAX planner's refine_factor pool (fetch_k) and a device rerank.
    exact_k = max(exact_k or fetch_k, k)
    scan_dtype = getattr(options, "flat_scan_dtype", "bf16")
    out = []
    dist_comps = 0
    for src in plan.sources:
        if src.kind in ("graph", "brute_masked"):
            d, rows, comps = _graph_source(src, qd, min(fetch_k, src.n), opts, options)
            dist_comps += comps + b * rows.shape[1]
            out.append((src.seg_id, d, rows))
            continue
        if src.kind == "mem":
            kk = min(exact_k, src.n)
            d, rows = src.source.search(qd, kk, src.n, _source_mask(src, qd.device))
        elif src.kind == "flat":
            kk = min(exact_k, src.n)
            d, rows = src.source.search(qd, kk, mask=_source_mask(src, qd.device),
                                        scan_dtype=scan_dtype)
        elif src.kind == "flat_compact":
            d, rows = _compact_search(src, qd, min(exact_k, src.rows_considered),
                                      options.metric, scan_dtype)
        else:  # flat_stream, graph_stream, graph_cached
            raise not_ported(f"the {src.kind!r} source (beyond-device segment)", 2)
        dist_comps += b * src.rows_considered + b * rows.shape[1]
        out.append((src.seg_id, d, rows))
    return out, dist_comps


def _graph_source(src, qd, kk: int, opts, options):
    """A graph segment's candidates, reranked on the device: brute force over
    its coded slots (or its f32 rows) at low selectivity, else the graph
    search with selectivity-adaptive ef. Returns (d, rows, distance
    computations)."""
    seg = src.source
    b = qd.shape[0]
    mask = _source_mask(src, qd.device)
    if src.kind == "brute_masked":
        if seg.ivf_members is not None:
            d, rows = seg.masked_scan(qd, kk, mask)
        else:
            dev = seg.device_state(qd.device)
            d, rows = T.blockwise_topk_search(
                qd, dev["full"], kk, metric=options.metric, x_norms_sq=dev["rnorm2"],
                mask=mask, x_normalized=True,
            )
        comps = b * src.rows_considered
    else:
        ef = max(opts.ef or options.ef_search, kk)
        if src.mask is not None and 0 < src.rows_considered < src.n:
            # Selectivity-adaptive ef: a filter that rides the graph drops
            # most traversal candidates, so the working set widens by
            # 1/selectivity, capped (lockstep cost grows with ef).
            sel = src.rows_considered / src.n
            ef = min(int(ef / max(sel, 1e-3)),
                     max(ef, getattr(options, "ef_filtered_cap", 2048)))
        bw = opts.beam_width or options.beam_width
        gkw = {}
        if opts.graph_refine >= 0:
            gkw["refine_steps"] = opts.graph_refine
        if opts.graph_rescore is not None:
            gkw["rescore"] = opts.graph_rescore
        if opts.nprobes:
            gkw["n_probe"] = opts.nprobes
        if opts.graph_qcap_factor > 0:
            gkw["qcap_factor"] = opts.graph_qcap_factor
        d, rows = seg.search(qd, kk, mask=mask, ef=ef, beam_width=bw, **gkw)
        steps = ef // max(bw, 1) + 8 + int(math.ceil(math.log2(max(seg.n, 2))))
        comps = b * steps * bw * seg.r
    return seg.rerank(qd, rows), rows, comps


def _plan_state(src) -> dict:
    """Device state a cached plan keeps for one source (its uploaded mask, its
    compact-gather sub-corpus), in the slot the plan cache's device budget
    counts (`PlanCache.sweep_gathered`)."""
    if src.compact is None:
        src.compact = {}
    return src.compact


def _source_mask(src, device):
    """The source's host mask (filter and tombstones) on the device, uploaded
    once per plan, so that later batches enqueue no synchronous copy."""
    if src.mask is None:
        return None
    st = _plan_state(src)
    if "mask" not in st:
        st["mask"] = torch.from_numpy(src.mask).to(device)
    return st["mask"]


def _compact_search(src, qd, kk: int, metric: Metric, scan_dtype: str):
    """Low-selectivity filter on a flat segment: the eligible rows are
    gathered once per plan into a dense sub-corpus (kept on the plan's source),
    so the scan costs O(selectivity * N) and carries no mask."""
    seg = src.source
    dev = seg.device_state(qd.device)
    cc = _plan_state(src)
    if "rows" not in cc:
        rows_elig = torch.from_numpy(np.flatnonzero(src.mask)).to(qd.device)
        cc.update(
            rows=rows_elig,
            x16=dev["vectors"][rows_elig].to(torch.bfloat16),
            rn=dev["rnorm2"][rows_elig],
        )
    if scan_dtype == "f32":
        # Exact sub-corpus scan; the f32 gather exists only for this profile.
        if "x32" not in cc:
            cc["x32"] = dev["vectors"][cc["rows"]]
        d, lrows = T.blockwise_topk_search(
            qd, cc["x32"], kk, metric=metric, x_norms_sq=cc["rn"], x_normalized=True,
        )
        return d, torch.where(lrows >= 0, cc["rows"][lrows.clamp_min(0)], -1)
    # bf16 pool (+24: the sub-corpus scan is cheap), remap to segment rows,
    # exact fp32 rerank against the full table, final top-kk.
    n_sub = cc["x16"].shape[0]
    _, lrows = T.blockwise_topk_search(
        qd, cc["x16"], min(kk + 24, n_sub), metric=metric, x_norms_sq=cc["rn"],
        x_normalized=True,
    )
    rows = torch.where(lrows >= 0, cc["rows"][lrows.clamp_min(0)], -1)
    return T.topk_smallest_with_ids(seg.rerank(qd, rows), rows, kk)


def _merge_device(parts, width: int):
    """Sort every source's candidates together on the device; keep the best
    `width` per query as (d [B, W] f32, code [B, W] int64 = slot<<32 | row,
    -1 where empty)."""
    ds, codes = [], []
    for slot, (_, d, rows) in enumerate(parts):
        rows = rows.long()
        codes.append(torch.where(rows >= 0, rows + (slot << _ROW_BITS), -1))
        ds.append(torch.where(rows >= 0, d.float(), float("inf")))
    d, pos = T.topk_smallest(torch.cat(ds, 1), width)
    return d, torch.gather(torch.cat(codes, 1), 1, pos)


def _finish(d: np.ndarray, code: np.ndarray, slot_seg_ids, snap, pk, opts):
    """Decode merged candidates, drop rows invisible at the snapshot (MVCC)
    and duplicate ids, and compact the first k survivors per query (host)."""
    k = opts.k
    b, w = d.shape
    valid = np.isfinite(d) & (code >= 0)
    slot = np.where(valid, code >> _ROW_BITS, 0)
    row = np.where(valid, code & ((1 << _ROW_BITS) - 1), -1)
    seg_of_slot = np.asarray(slot_seg_ids, np.int64)
    seg = seg_of_slot[slot]
    ids = np.full((b, w), -1, np.int64)
    lsns = np.full((b, w), -1, np.int64)
    segmap = {h.seg_id: h.segment for h in snap.segments}
    for s, seg_id in enumerate(seg_of_slot):
        m = valid & (slot == s)
        if not m.any():
            continue
        if seg_id == -1:
            ids_src = snap.memtable.ids[: snap.mem_rows]
            lsns_src = snap.memtable.lsns[: snap.mem_rows]
        else:
            ids_src, lsns_src = segmap[int(seg_id)].ids, segmap[int(seg_id)].lsns
        ids[m] = np.asarray(ids_src)[row[m]].astype(np.int64)
        lsns[m] = np.asarray(lsns_src)[row[m]]

    # Ids with one version are visible by construction; only multi-version
    # ("dirty") ids need the PK chain, and only they can repeat in a row.
    dirty = pk.dirty_sorted()
    if len(dirty):
        from vecgo_tpu.engine.pk import DELETED

        flagged = valid & np.isin(ids, dirty)
        for bi, j in zip(*np.nonzero(flagged)):
            ent = pk.get_entry(int(ids[bi, j]), snap.lsn)
            if ent is None or ent[1] == DELETED or ent[0] != int(lsns[bi, j]):
                valid[bi, j] = False
        for bi in np.flatnonzero(flagged.any(axis=1)):
            seen = set()
            for j in np.flatnonzero(valid[bi]):
                if ids[bi, j] in seen:
                    valid[bi, j] = False
                else:
                    seen.add(ids[bi, j])

    sel = np.argsort(~valid, axis=1, kind="stable")[:, :k]
    kk = sel.shape[1]
    got = np.take_along_axis(valid, sel, axis=1)
    out_ids = np.full((b, k), -1, np.int64)
    out_d = np.full((b, k), np.inf, np.float32)
    out_ids[:, :kk] = np.where(got, np.take_along_axis(ids, sel, axis=1), -1)
    out_d[:, :kk] = np.where(got, np.take_along_axis(d, sel, axis=1), np.inf)
    loc = (np.take_along_axis(seg, sel, axis=1), np.take_along_axis(row, sel, axis=1), got)
    return out_ids, out_d, loc


@dataclass
class _PendingBatch:
    """A batch whose device work and result copies are enqueued but unread."""

    plan: Any
    chunks: list  # [(d [B, W], code [B, W])] host tensors, one per query chunk
    done: Optional[torch.cuda.Event]  # recorded after the copies (None on the CPU)
    slot_seg_ids: list
    b: int
    dist_comps: int
    stats: Any
    t0: float
    t_plan: float
    t_score: float


def _to_host_async(t: torch.Tensor) -> torch.Tensor:
    """Enqueue a device-to-host copy into pinned memory right behind the
    kernels that produce `t`, so that reading one batch's results never waits
    for the batches enqueued after it. Valid once the batch's event is done."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t, non_blocking=True)


def _query_tensor(q, device, metric: Metric):
    """The query batch as f32 on the device. Host batches go through pinned
    memory so the upload does not wait for the batches already enqueued."""
    if isinstance(q, torch.Tensor):
        qd = q
    else:
        qd = torch.from_numpy(np.ascontiguousarray(q, np.float32))
        if device.type == "cuda":
            qd = qd.pin_memory()
    qd = qd.to(device=device, dtype=torch.float32, non_blocking=True).contiguous()
    return D.normalize(qd) if metric == Metric.COSINE else qd


def _dispatch_batch(snap, pk, q, opts: SearchOptions, options, device_budget=None,
                    plan_cache: Optional[PlanCache] = None) -> _PendingBatch:
    t0 = time.perf_counter()
    stats = QueryStats() if opts.with_stats else None
    qd = _query_tensor(q, options.device, options.metric)
    b = qd.shape[0]

    plan = cache_key = None
    if plan_cache is not None:
        fkey = _plan_filter_key(opts.filter)
        if fkey is not None:
            cache_key = (
                snap.lsn, snap.version, snap.mem_rows,
                tuple(h.seg_id for h in snap.segments),
                fkey, opts.selectivity_cutoff, opts.prefilter,
            )
            plan = plan_cache.get(cache_key)
            if plan is not None and not _plan_still_resident(plan, device_budget):
                plan = None
    if plan is None:
        plan = _plan_snapshot(snap, opts, options, device_budget)
        if cache_key is not None:
            plan_cache.put(cache_key, plan)
    t_plan = time.perf_counter()

    # Every dirty (multi-version) id can put one stale row per source into
    # the merge window, so the margin grows with the dirty count; a clean
    # snapshot needs none. Past the cap the merge keeps every candidate.
    dirty_n = len(pk.dirty_sorted())
    margin = 0 if dirty_n == 0 else max(_VIS_MARGIN, min(dirty_n, _VIS_MARGIN_CAP))
    chunks = []
    dist_comps = 0
    for c0 in range(0, b if plan.sources else 0, CHUNK_B):
        parts, dc = _dispatch_chunk(plan, qd[c0 : c0 + CHUNK_B], opts, options,
                                    exact_k=opts.k + margin)
        dist_comps += dc
        total = sum(p[2].shape[1] for p in parts)
        width = total if dirty_n > _VIS_MARGIN_CAP else min(total, opts.k + margin)
        chunks.append(tuple(map(_to_host_async, _merge_device(parts, width))))
    done = None
    if qd.device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(qd.device))
    if plan_cache is not None:
        # Compact-gather sub-corpora attach at first dispatch; hold the plan
        # cache to its device budget now.
        plan_cache.sweep_gathered(getattr(options, "plan_gather_budget_bytes", 2 << 30))
    return _PendingBatch(plan, chunks, done, [s.seg_id for s in plan.sources], b,
                         dist_comps, stats, t0, t_plan, time.perf_counter())


def _drain_batch(pending: _PendingBatch, snap, pk, opts, need_locations: bool = True):
    k = opts.k
    plan, b, stats = pending.plan, pending.b, pending.stats
    out_ids = np.full((b, k), -1, np.int64)
    out_d = np.full((b, k), np.inf, np.float32)
    out_loc: List[List] = [[] for _ in range(b)] if not plan.sources else []
    if pending.done is not None:
        pending.done.synchronize()
    t_rerank = time.perf_counter()
    for ci, (d, code) in enumerate(pending.chunks):
        ids_c, d_c, loc_c = _finish(d.numpy(), code.numpy(), pending.slot_seg_ids,
                                    snap, pk, opts)
        s = ci * CHUNK_B
        out_ids[s : s + ids_c.shape[0]] = ids_c
        out_d[s : s + ids_c.shape[0]] = d_c
        if need_locations:
            out_loc.extend(_loc_lists(*loc_c))
    if stats:
        t_end = time.perf_counter()
        stats.planning_time_s = pending.t_plan - pending.t0
        stats.scoring_time_s = pending.t_score - pending.t_plan
        stats.rerank_time_s = t_rerank - pending.t_score
        stats.materialize_time_s = t_end - t_rerank
        stats.total_time_s = t_end - pending.t0
        stats.segments_total = plan.segments_total
        stats.segments_pruned = plan.n_pruned
        stats.segments_brute_force = plan.n_brute
        stats.segments_graph = plan.n_graph
        stats.rows_considered = plan.rows_considered
        stats.rows_filtered_out = plan.rows_filtered_out
        stats.distance_computations = pending.dist_comps
        if plan.filtered:
            stats.selectivity = plan.rows_considered / max(plan.total_rows, 1)
        stats.strategy = (
            "empty" if not plan.sources else
            f"brute={plan.n_brute} graph={plan.n_graph} pruned={plan.n_pruned}"
            + (" filtered" if plan.filtered else "")
        )
    return out_ids, out_d, out_loc, stats


def search_snapshot(snap, pk, q, opts: SearchOptions, options, device_budget=None,
                    need_locations: bool = True, plan_cache: Optional[PlanCache] = None):
    """Search a snapshot with a query batch [B, d] (numpy or tensor).

    Returns (ids [B, k] int64 (-1 pad), dists [B, k] f32, per-query
    [(seg_id, row), ...] lists when need_locations, stats or None)."""
    pending = _dispatch_batch(snap, pk, q, opts, options, device_budget, plan_cache)
    return _drain_batch(pending, snap, pk, opts, need_locations)


def search_snapshot_stream(snap, pk, batches, opts: SearchOptions, options,
                           device_budget=None, need_locations: bool = False,
                           depth: int = 3, plan_cache: Optional[PlanCache] = None):
    """Serve a stream of query batches over one snapshot, keeping up to
    `depth` batches enqueued on the device; yields (ids, dists, locs, stats)
    per batch in input order."""
    inflight: "deque[_PendingBatch]" = deque()
    for q in batches:
        inflight.append(_dispatch_batch(snap, pk, q, opts, options, device_budget,
                                        plan_cache))
        if len(inflight) >= depth:
            yield _drain_batch(inflight.popleft(), snap, pk, opts, need_locations)
    while inflight:
        yield _drain_batch(inflight.popleft(), snap, pk, opts, need_locations)
