"""Top-k primitives and the scans built on `scan_topk` (port of
vecgo_tpu/ops/topk.py).

The JAX package scanned with an XLA matmul plus `lax.approx_min_k`; the port
has no approximate selector and scans with the fused kernel, which is exact.
Small-width selections (pools, merges) stay plain PyTorch, as they stayed
XLA in the JAX package. Every selection breaks ties by the lower index, as
`lax.top_k` does. Distances are smaller-is-better; missing entries carry
+inf and id -1.
"""

from __future__ import annotations

import math

import torch

from vecgo_tpu_torch.model import Metric
from vecgo_tpu_torch.ops import distance as D
from vecgo_tpu_torch.ops.scan_topk import scan_topk


def topk_smallest(scores: torch.Tensor, k: int):
    """Top-k smallest along the last axis -> (dists [.., k], idx [.., k] int64)."""
    d, idx = torch.sort(scores, dim=-1, stable=True)
    return d[..., :k], idx[..., :k]


def merge_topk_sorted(d_a, i_a, d_b, i_b, k: int):
    """Merge two candidate sets (last axis) into the k smallest overall."""
    d = torch.cat([d_a, d_b], -1)
    i = torch.cat([i_a.long(), i_b.long()], -1)
    d, pos = topk_smallest(d, k)
    return d, torch.gather(i, -1, pos)


def topk_smallest_with_ids(d, i, k: int):
    """Top-k smallest of (d, i) pairs along the last axis."""
    dk, pos = topk_smallest(d, k)
    return dk, torch.gather(i.long(), -1, pos)


def blockwise_topk_search(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    *,
    metric,
    x_norms_sq=None,
    mask=None,
    compute_dtype=None,
    x_normalized: bool = False,
):
    """Exact top-k of q [B, d] against x [N, d] through `scan_topk`.

    compute_dtype=torch.bfloat16 scans a bf16 copy of x (a no-op when x is
    already bf16). Returns (dists [B, k] f32, rows [B, k] int64, -1 missing).
    """
    metric = Metric(metric).compute() if isinstance(metric, str) else metric.compute()
    q = q.float()
    if metric == Metric.COSINE:
        q = D.normalize(q)
        if not x_normalized:
            x = D.normalize(x)
    if metric == Metric.L2 and x_norms_sq is None:
        x_norms_sq = D.row_norms_sq(x)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    d, i = scan_topk(
        q.contiguous(), x.contiguous(),
        x_norms_sq if metric == Metric.L2 else None, k, metric, mask,
    )
    if metric == Metric.L2:
        d = d.clamp_min(0.0)
    return d, i.long()


def rerank_exact(q, rows, full, rn, metric: Metric) -> torch.Tensor:
    """Exact fp32 distances [B, C] of candidate rows [B, C] (-1 -> +inf):
    a gather of the full-precision rows plus one batched product."""
    metric = metric.compute()
    safe = rows.long().clamp_min(0)
    v = full[safe]  # [B, C, d]
    qf = q.float()
    if metric == Metric.COSINE:
        qf = D.normalize(qf)
    prod = torch.einsum("bcd,bd->bc", v.float(), qf)
    if metric == Metric.L2:
        d = ((qf * qf).sum(-1, keepdim=True) + rn[safe] - 2.0 * prod).clamp_min(0.0)
    elif metric == Metric.DOT:
        d = -prod
    else:  # cosine over normalized storage
        d = 1.0 - prod
    return torch.where(rows >= 0, d, math.inf)


def scored_pool_rerank(q, x_scan, full, rn, k: int, pool: int, metric: Metric, mask=None):
    """Pool scan + exact fp32 rerank + final top-k (the port of
    `_scored_pool_rerank_jit`): `scan_topk` keeps a pool of `pool` rows per
    query over the scan table (a bf16 or f32 copy of `full`, whose row norms
    are `rn`), the pool is reranked exactly against `full`, and the best k of
    the pool are returned."""
    _, rows = blockwise_topk_search(
        q, x_scan, pool, metric=metric, x_norms_sq=rn, mask=mask, x_normalized=True,
    )
    return topk_smallest_with_ids(rerank_exact(q, rows, full, rn, metric), rows, k)
