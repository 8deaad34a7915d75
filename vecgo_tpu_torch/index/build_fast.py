"""Clustered Vamana build on the device (port of vecgo_tpu/index/build_fast.py).

No graph search during the build: candidates come from cluster-local exact
KNN computed as batched [G, C, C] distance products.

  1. JL-project the corpus to 32 dims; k-means partition and top-`overlap`
     assignment run in the projection,
  2. each point joins its `overlap` nearest clusters (capacity-capped by
     hash-scatter rounds in distance waves, the JAX package's default form),
  3. per cluster batch: full-dim bf16 distances -> exact top-knn per member,
  4. NN-descent rounds on a pure-KNN working list,
  5. one RobustPrune pass over [working list | random far ids | reverse
     edges of the working list], with alpha occlusion measured in a 16-dim
     projection at >= 100k rows.

Under a device grid (`mesh=`, `parallel.mesh.make_mesh`) the corpus and
its norms are replicated to the grid's devices, and the cluster-KNN stage
and the prune split over them (`parallel.engine_shard.sharded_cluster_knn`,
`sharded_prune`, one pass); the rest runs on the grid's first device. The
JAX package's environment knobs (`BUILD_*`) and its TPU-runtime retries
have no counterpart: their defaults are built in. Where
the JAX build scattered with duplicate indices (reverse-edge hashing), the
port resolves collisions deterministically (the largest source id wins).
The random far ids come from a seeded `torch.Generator`, so a graph built
here is not the JAX-built graph; both are held to the same recall floors.
"""

from __future__ import annotations

import logging
import math
from typing import Tuple

import numpy as np
import torch

from vecgo_tpu_torch.ops import beam as beam_ops
from vecgo_tpu_torch.ops import topk as T
from vecgo_tpu_torch.quantization import kmeans as km
from vecgo_tpu_torch.utils.tensors import checked_device

logger = logging.getLogger("vecgo_tpu_torch")

OCC_DIM = 32  # JL projection dim: partition space (and occlusion below 100k rows)
PRUNE_OCC_DIM = 16  # RobustPrune occlusion space at >= 100k rows
_PRUNE_OCC_MIN_ROWS = 100_000


def _bucket_rows(n: int, block: int = 8192) -> int:
    """Round n up to the JAX package's size bucket (next power of two below
    `block`, 1/8-octave steps above), so both packages pad alike."""
    if n <= 256:
        return 256
    if n <= block:
        return 1 << (n - 1).bit_length()
    step = max(block, (1 << ((n - 1).bit_length() - 1)) // 8)
    return ((n + step - 1) // step) * step


def _tiny_graph(x: np.ndarray, r: int):
    """Fully connected graph for n <= r + 1."""
    n = x.shape[0]
    g = np.full((n, r), -1, np.int32)
    for i in range(n):
        others = [j for j in range(n) if j != i]
        g[i, : len(others)] = others
    medoid = int(((x - x.mean(0)) ** 2).sum(1).argmin())
    return g, medoid


def _bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 a @ b with f32 accumulation, rounded to bf16 as a bf16 product is
    in JAX, returned as f32."""
    return (a.float() @ b.float()).to(torch.bfloat16).float()


def _cluster_knn(x16, rnorm2, members, mem_slot, knn: int, overlap: int, n_out: int, g: int):
    """Exact KNN within every cluster, scattered into a per-point table
    cand [n_out, overlap, knn] int64 (-1 pad). members/mem_slot [K_pad, Cmax]
    (-1 padded members); g clusters per batched product."""
    k_pad, cmax = members.shape
    dev = x16.device
    cand = torch.full((n_out, overlap, knn), -1, dtype=torch.int64, device=dev)
    eye = torch.eye(cmax, dtype=torch.bool, device=dev)
    for g0 in range(0, k_pad, g):
        mem = members[g0 : g0 + g].long()
        slot = mem_slot[g0 : g0 + g].long()
        valid = mem >= 0
        safe = mem.clamp_min(0)
        v = x16[safe].float()  # [g, cmax, d]
        rn = rnorm2[safe]
        dmat = rn[:, :, None] + rn[:, None, :] - 2.0 * torch.bmm(v, v.transpose(1, 2))
        dmat = torch.where(valid[:, None, :] & ~eye, dmat, math.inf)
        loc = torch.topk(dmat, knn, dim=2, largest=False).indices  # [g, cmax, knn]
        gcand = mem[:, None, :].expand(-1, cmax, -1).gather(2, loc)
        vtake = valid[:, None, :].expand(-1, cmax, -1).gather(2, loc)
        gcand = torch.where(vtake, gcand, -1)
        # A point holds one slot per overlap rank, so (point, slot) is unique.
        cand[mem[valid], slot[valid]] = gcand[valid]
        del dmat, v
    return cand


def _score_merge(w_d, w_i, cand, x16, rnorm2, kw: int, block: int):
    """Score candidate ids and merge them into the per-point working KNN
    lists w_d/w_i [N_pad, kw] (sorted, -1 pad), block by block."""
    n_pad = cand.shape[0]
    out_d = torch.empty((n_pad, kw), dtype=torch.float32, device=cand.device)
    out_i = torch.empty((n_pad, kw), dtype=torch.int64, device=cand.device)
    for b0 in range(0, n_pad, block):
        rows = torch.arange(b0, min(n_pad, b0 + block), device=cand.device)
        cands = cand[b0 : b0 + block]
        q16 = x16[rows].float()
        qn = rnorm2[rows][:, None]
        d_new = beam_ops._score_rows(q16, qn, x16, rnorm2, cands.clamp_min(0))
        bad = (cands < 0) | (cands == rows[:, None])
        d_new = torch.where(bad, math.inf, d_new)
        cands = torch.where(bad, -1, cands)
        nd, ni = beam_ops._dedup_topk(torch.cat([w_d[b0 : b0 + block], d_new], 1),
                                      torch.cat([w_i[b0 : b0 + block], cands], 1), kw)
        out_d[b0 : b0 + block], out_i[b0 : b0 + block] = nd, ni
    return out_d, out_i


def _rand_cand(n_pad: int, n: int, n_rand: int, seed: int, device) -> torch.Tensor:
    """[n_pad, n_rand] random node ids from a seeded generator on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    return torch.randint(0, n, (n_pad, n_rand), generator=gen, device=device)


def _reverse_dev(edges: torch.Tensor, rev_cap: int) -> torch.Tensor:
    """Sampled in-edges by hash-scatter (no sort): for edge u -> v, u lands in
    rev[v, h(u)]; of the sources colliding in a slot, the largest id stays.
    edges [N_pad, W] (-1 pad). Returns [N_pad, rev_cap] int64."""
    n_pad, w = edges.shape
    dev = edges.device
    src = torch.arange(n_pad, device=dev)[:, None].expand(n_pad, w)
    h = (((src * 2654435761) & 0xFFFFFFFF) >> 12) % rev_cap
    ok = edges >= 0
    rev = torch.full((n_pad * rev_cap,), -1, dtype=torch.int64, device=dev)
    rev.scatter_reduce_(0, (edges.long() * rev_cap + h)[ok], src[ok], reduce="amax",
                        include_self=True)
    return rev.reshape(n_pad, rev_cap)


def _descent_candidates(w_i, hop_a: int, hop_b: int, rev_cap: int):
    """NN-descent candidates: 2-hop samples from the working lists plus
    hash-scattered reverse edges. Returns [N_pad, hop_a*hop_b + rev_cap]."""
    n_pad = w_i.shape[0]
    nbr = w_i[:, :hop_a]
    hop = w_i[:, :hop_b][nbr.clamp_min(0)].reshape(n_pad, hop_a * hop_b)
    hop = torch.where(nbr.repeat_interleave(hop_b, dim=1) >= 0, hop, -1)
    return torch.cat([hop, _reverse_dev(w_i, rev_cap)], 1)


def _descend(cand, x16, rnorm2, rounds: int, kw: int, block: int, hop_a: int, hop_b: int,
             rev_cap: int):
    """Initial merge plus `rounds` NN-descent iterations. Returns (w_d, w_i)
    [N_pad, kw]."""
    n_pad = cand.shape[0]
    w_d = torch.full((n_pad, kw), math.inf, dtype=torch.float32, device=cand.device)
    w_i = torch.full((n_pad, kw), -1, dtype=torch.int64, device=cand.device)
    w_d, w_i = _score_merge(w_d, w_i, cand, x16, rnorm2, kw, block)
    for _ in range(rounds):
        w_d, w_i = _score_merge(w_d, w_i, _descent_candidates(w_i, hop_a, hop_b, rev_cap),
                                x16, rnorm2, kw, block)
    return w_d, w_i


def _prune_all(cand_table, vectors, rnorm2, x_occ, rn_occ, r_out: int, alpha: float,
               block: int, row0: int = 0):
    """RobustPrune every row of cand_table [N_pad, L], block by block; its
    rows are the corpus rows from `row0` on (a slice of a sharded prune).
    Returns [N_pad, r_out] int64."""
    n_pad = cand_table.shape[0]
    out = torch.empty((n_pad, r_out), dtype=torch.int64, device=cand_table.device)
    for b0 in range(0, n_pad, block):
        rows = torch.arange(row0 + b0, row0 + min(n_pad, b0 + block), device=cand_table.device)
        out[b0 : b0 + block] = beam_ops.robust_prune(
            rows, vectors[rows.clamp_max(vectors.shape[0] - 1)], cand_table[b0 : b0 + block],
            vectors, rnorm2, r_out=r_out, alpha=alpha, vectors_occ=x_occ, rnorm2_occ=rn_occ,
        )
    return out


def _assign_topk(z, znorm2, centers, overlap: int, block: int):
    """Per-point `overlap` nearest centroids (bf16 products), in projection
    space for the clustered build, over the full dimension for
    `ops/ivf.build_ivf_table`; padded rows carry +inf znorm2. Returns
    (assign [N_pad, ov] int64, dist [N_pad, ov] f32), ties to the lower id."""
    c16 = centers.to(torch.bfloat16).float()
    cn = (centers.float() ** 2).sum(1)
    a, dd = [], []
    for b0 in range(0, z.shape[0], block):
        prod = z[b0 : b0 + block].to(torch.bfloat16).float() @ c16.T
        dmat = znorm2[b0 : b0 + block, None] + cn[None, :] - 2.0 * prod
        nd, idx = T.topk_smallest(dmat, overlap)
        a.append(idx)
        dd.append(nd)
    return torch.cat(a), torch.cat(dd)


def _membership_scatter(assign, dists, k: int, cmax: int):
    """Capacity-capped membership by hash-scatter rounds (the JAX package's
    default form). assign/dists [N, ov]; cluster k - 1 is the callers' dump
    cluster for padded rows. Each (point, overlap rank) membership tries six
    hashed positions in its cluster's row per distance wave; of the points
    that reach one free position in a round, the largest id wins (a max
    scatter). Ranks go in order, so primaries take capacity first, and four
    waves place the nearest quarter of the memberships (by the quantiles of
    the valid rows' primary distances) before the next. Returns (members
    [k, cmax] int32 (-1 pad), mem_slot [k, cmax] int32, entry_nodes [k]
    int32 (a cluster's first occupied column, -1 if empty), covered [N])."""
    n, ov = assign.shape
    dev = assign.device
    pt = torch.arange(n, device=dev)
    members = torch.full(((k + 1) * cmax,), -1, dtype=torch.int64, device=dev)
    mem_slot = torch.zeros(((k + 1) * cmax,), dtype=torch.int32, device=dev)
    placed = torch.zeros(n, dtype=torch.bool, device=dev)
    d0 = dists[:, 0].float()
    row_valid = (assign[:, 0] < k - 1) & torch.isfinite(d0)
    qs = torch.nanquantile(torch.where(row_valid, d0, math.nan),
                           torch.tensor([0.25, 0.5, 0.75], device=dev))
    bucket = (dists > qs[0]).int() + (dists > qs[1]).int() + (dists > qs[2]).int()
    hbase = (pt * 2654435761) & 0xFFFFFFFF
    for s in range(ov):
        cl = assign[:, s].long().clamp_max(k)
        need = torch.ones(n, dtype=torch.bool, device=dev)
        for w in range(4):
            eligible = bucket[:, s] <= w
            for r in range(6):
                salt = ((w * 7 + r) * 0x9E3779B9 + s * 0x85EBCA6B) & 0xFFFFFFFF
                pos = (hbase ^ salt) % cmax
                trying = need & eligible
                row = torch.where(trying, cl, k)
                free = members[row * cmax + pos] < 0
                cell = torch.where(free, row, k) * cmax + pos
                members.scatter_reduce_(0, cell, pt, reduce="amax", include_self=True)
                won = (members[cell] == pt) & trying & free
                mem_slot[cell[won]] = s
                placed |= won
                need &= ~won
    members = members.view(k + 1, cmax)[:k].to(torch.int32)
    mem_slot = mem_slot.view(k + 1, cmax)[:k]
    first = torch.argmax((members >= 0).int(), dim=1)
    entry_nodes = members.gather(1, first[:, None])[:, 0]
    return members, mem_slot, entry_nodes, placed


def _complete_membership(members, covered_n):
    """Coverage completion: the i-th uncovered row (ascending) takes the
    i-th free (-1) slot in row-major order. members [K, S]; covered_n [n]."""
    k, s = members.shape
    n = covered_n.shape[0]
    flat = members.reshape(-1)
    free = flat < 0
    csum = torch.cumsum(free.long(), 0)
    rows = torch.arange(n, device=members.device)
    lv_sorted = torch.sort(torch.where(covered_n, n, rows)).values
    n_left = int((~covered_n).sum())
    if n_left > int(free.sum()):
        logger.warning("build membership: %d rows uncovered (no free slots)",
                       n_left - int(free.sum()))
    fill = lv_sorted[(csum - 1).clamp(0, n - 1)]
    fill_ok = free & (csum - 1 < n_left)
    return torch.where(fill_ok, fill.to(flat.dtype), flat).reshape(k, s)


def build_graph_clustered(
    x,
    r: int = 32,
    alpha: float = 1.2,
    seed: int = 42,
    cluster_size: int = 1024,
    overlap: int = 2,
    knn: int = 0,
    n_rand: int = 8,
    rev_cap: int = 0,
    prune_block: int = 0,
    kmeans_iters: int = 5,
    cluster_group: int = 0,
    refine_rounds: int = 1,
    hop2: int = 64,
    restarts: int = 1,
    return_membership: bool = False,
    device=None,
    mesh=None,
) -> Tuple:
    """Build a Vamana-style graph over x [N, d] without graph search.

    x is a tensor (its device builds; norms from its bf16 rounding, as the
    JAX package's device-input path) or a numpy array (built on `device`:
    "cuda" by default, or the first device of `mesh`). mesh: a device grid
    (`parallel.mesh.Mesh`) that the cluster-KNN stage and the prune split
    over. Returns (graph [N, r] int32, medoid, entry_centroids
    [K, d] f32, entry_nodes [K] int32), plus the build's capacity-capped
    cluster membership [K, cluster_size] int32 (-1 padded, every row
    covered) with return_membership."""
    n, d = x.shape
    device_input = isinstance(x, torch.Tensor)
    if device_input:
        dev = x.device
    elif device is None and mesh is not None:
        dev = mesh.entries()[0]
    else:
        dev = checked_device(device or "cuda", "build_graph_clustered")
    rng = np.random.default_rng(seed)
    if n == 0:
        return (np.zeros((0, r), np.int32), 0, np.zeros((0, d), np.float32),
                np.zeros(0, np.int32))
    if n <= r + 1:
        xh = x.float().cpu().numpy() if device_input else np.asarray(x, np.float32)
        g, medoid = _tiny_graph(xh, r)
        out = (g, medoid, xh[medoid : medoid + 1].copy(), np.asarray([medoid], np.int32))
        if return_membership:
            out = out + (np.arange(n, dtype=np.int32)[None, :],)
        return out

    # Widths as in the JAX package (its measured defaults at 1M, r = 32).
    knn = knn or max(24, (3 * r) // 4)
    rev_cap = rev_cap or max(r // 2, 8)
    overlap = max(1, min(overlap, 4))
    if prune_block <= 0:
        prune_block = 32768 if n >= 131072 else 8192
    n_full = _bucket_rows(n, prune_block)
    row_ok = torch.arange(n_full, device=dev) < n

    # Padded rows carry +inf norms: no distance can select them.
    if device_input:
        x16 = x.to(torch.bfloat16)
        if n_full > n:
            x16 = torch.cat([x16, x16.new_zeros((n_full - n, d))])
        rnorm2 = torch.where(row_ok, (x16.float() ** 2).sum(1), math.inf)
        mean16 = (x16.float().sum(0) / n).to(torch.bfloat16)
    else:
        x = np.ascontiguousarray(x, np.float32)
        x16 = torch.zeros((n_full, d), dtype=torch.bfloat16, device=dev)
        x16[:n] = torch.from_numpy(x).to(dev)
        rn_host = np.full(n_full, np.inf, np.float32)
        rn_host[:n] = np.einsum("nd,nd->n", x, x, dtype=np.float64).astype(np.float32)
        rnorm2 = torch.from_numpy(rn_host).to(dev)
        mean16 = torch.from_numpy(x.mean(0, dtype=np.float64)).to(dev).to(torch.bfloat16)
    if mesh is not None:
        from vecgo_tpu_torch.parallel import engine_shard as es
        from vecgo_tpu_torch.parallel.mesh import replicate

        x16_grid, rn_grid = replicate(x16, mesh), replicate(rnorm2, mesh)
    medoid_dev = torch.argmin(rnorm2 - 2.0 * _bf16_matmul(x16, mean16[:, None])[:, 0])

    # JL projections: [0] is also the occlusion space below 100k rows; each
    # restart partitions under its own projection.
    pdim = min(OCC_DIM, d)

    def proj(width):
        p = rng.standard_normal((d, width)) / math.sqrt(width)
        return torch.from_numpy(p).to(dev).to(torch.bfloat16)

    projs = [proj(pdim) for _ in range(max(1, restarts))]
    if d > pdim:
        x_occ = _bf16_matmul(x16, projs[0])
        rn_occ = (x_occ * x_occ).sum(1)
    else:
        x_occ, rn_occ = x16.float(), rnorm2
    if PRUNE_OCC_DIM < min(pdim, d) and n_full >= _PRUNE_OCC_MIN_ROWS:
        x_occ_p = _bf16_matmul(x16, proj(PRUNE_OCC_DIM))
        rn_occ_p = (x_occ_p * x_occ_p).sum(1)
    else:
        x_occ_p, rn_occ_p = x_occ, rn_occ

    block = min(prune_block, n_full)
    entry_nodes_dev = None
    n_dropped = None
    members_t0 = covered_t0 = None
    cand_parts = []
    for t in range(max(1, restarts)):
        if d > pdim:
            z = x_occ if t == 0 else _bf16_matmul(x16, projs[t])
            zn = rn_occ if t == 0 else (z * z).sum(1)
        else:
            z, zn = x_occ, rn_occ
        cmax = min(cluster_size, n)
        g_batch = cluster_group or max(1, min(64, 65536 // cmax))
        covered = None
        if n <= 2 * cmax:
            # Small corpus: one global cluster = exact KNN over everything.
            ov_t, cmax, g_batch = 1, n_full, 1
            members = torch.where(row_ok, torch.arange(n_full, device=dev), -1)[None, :].int()
            mem_slot = torch.zeros((1, n_full), dtype=torch.int32, device=dev)
            enodes_t = medoid_dev.reshape(1)
        else:
            ov_t = overlap
            k_clusters = max(2, math.ceil(n * ov_t * 1.4 / cmax))
            n_sample = min(n, max(32768, 12 * k_clusters))
            idx = rng.choice(n, n_sample, replace=False)
            centers, _ = km.train_kmeans_dev(
                z[torch.from_numpy(idx).to(dev)], k_clusters, iters=kmeans_iters,
                seed=seed + 101 * t, sample=n_sample,
            )
            a_dev, d_dev = _assign_topk(z, zn, centers, ov_t, block)
            # Padded rows go to a dump cluster beyond k_pad.
            k_pad = -(-k_clusters // g_batch) * g_batch
            a_dev = torch.where(row_ok[:, None], a_dev, k_pad)
            members, mem_slot, enodes_t, covered = _membership_scatter(a_dev, d_dev, k_pad + 1,
                                                                        cmax)
            members, mem_slot = members[:k_pad], mem_slot[:k_pad]
            enodes_t = enodes_t[:k_clusters]
            nd = n - int(covered[:n].sum())
            n_dropped = nd if n_dropped is None else min(n_dropped, nd)
        if t == 0:
            members_t0, covered_t0 = members, covered
        if entry_nodes_dev is None:
            entry_nodes_dev = torch.where(enodes_t >= 0, enodes_t.long(), medoid_dev)
        knn_eff = min(knn, min(cmax, n) - 1)
        if mesh is not None:
            cand_t = es.sharded_cluster_knn(x16_grid, rn_grid, members, mem_slot, knn_eff, ov_t,
                                            n_full, g_batch, mesh)
        else:
            cand_t = _cluster_knn(x16, rnorm2, members, mem_slot, knn_eff, ov_t, n_full, g_batch)
        cand_parts.append(cand_t.reshape(n_full, ov_t * knn_eff))
    cand = torch.cat(cand_parts, 1) if len(cand_parts) > 1 else cand_parts[0]

    # NN-descent on a pure-KNN working list, then one RobustPrune pass.
    kw = max(48, int(1.5 * r))
    hop_a, hop_b = min(16, kw), max(1, hop2 // 16)
    w_d, w_i = _descend(cand, x16, rnorm2, max(refine_rounds, 0), kw, block, hop_a, hop_b,
                        rev_cap)
    del cand, cand_parts, w_d
    parts = [w_i]
    if n_rand > 0:
        parts.append(_rand_cand(n_full, n, n_rand, seed, dev))
    parts.append(_reverse_dev(w_i[:, :r], rev_cap))
    if mesh is not None:
        graph = es.sharded_prune(torch.cat(parts, 1), x16_grid, rn_grid, x_occ_p, rn_occ_p, r,
                                 alpha, block, rev_cap, mesh, one_pass=True)
    else:
        graph = _prune_all(torch.cat(parts, 1), x16, rnorm2, x_occ_p, rn_occ_p, r, alpha, block)

    medoid = int(medoid_dev)
    entry_nodes = entry_nodes_dev.cpu().numpy().astype(np.int32)
    if device_input:
        entry_centroids = x16[entry_nodes_dev].float().cpu().numpy()
    else:
        entry_centroids = x[entry_nodes].copy()
    if n_dropped:
        logger.info("clustered build: %d/%d points had no cluster membership "
                    "(capacity overflow); reverse edges keep them reachable", n_dropped, n)
    out = (graph[:n].to(torch.int32).cpu().numpy(), medoid, entry_centroids, entry_nodes)
    if return_membership:
        members = members_t0
        if covered_t0 is not None:
            members = _complete_membership(members_t0, covered_t0[:n])
        out = out + (members.cpu().numpy().astype(np.int32),)
    return out
