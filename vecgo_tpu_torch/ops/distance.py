"""Batched distance scoring (port of vecgo_tpu/ops/distance.py).

All functions return smaller-is-better scores of shape [B, N], in IEEE fp32.
A float32 matrix product on the card defaults to full fp32; the flag is set
here explicitly because TF32 (about three decimal digits) would reorder near
neighbours, and every exact rerank of the port goes through these products.
The bf16 profile rounds both operands to bf16 and accumulates in fp32, as
`vecgo_tpu.ops.distance._matmul` does with `compute_dtype=bfloat16`.
"""

from __future__ import annotations

import torch

from vecgo_tpu_torch.model import Metric

torch.backends.cuda.matmul.allow_tf32 = False


def row_norms_sq(x: torch.Tensor) -> torch.Tensor:
    """Per-row squared L2 norms, float32 [N]."""
    xf = x.float()
    return (xf * xf).sum(-1)


def normalize(x: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """L2-normalize rows."""
    n = x.float().pow(2).sum(-1, keepdim=True).sqrt()
    return (x / n.clamp_min(eps)).to(x.dtype)


def _matmul(q: torch.Tensor, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Q [B,d] @ X^T [d,N] -> [B,N] with fp32 accumulation."""
    if compute_dtype is not None:
        q = q.to(compute_dtype)
        x = x.to(compute_dtype)
    return q.float() @ x.float().T


def squared_l2(q, x, x_norms_sq=None, compute_dtype=None) -> torch.Tensor:
    """Squared L2 distances [B, N], clamped at 0."""
    qf = q.float()
    qn = (qf * qf).sum(-1, keepdim=True)
    if x_norms_sq is None:
        x_norms_sq = row_norms_sq(x)
    d = qn + x_norms_sq[None, :] - 2.0 * _matmul(q, x, compute_dtype)
    return d.clamp_min(0.0)


def dot_scores(q, x, compute_dtype=None) -> torch.Tensor:
    """Negative inner product [B, N]."""
    return -_matmul(q, x, compute_dtype)


def cosine_scores(
    q, x, x_normalized: bool = False, q_normalized: bool = False, compute_dtype=None
) -> torch.Tensor:
    """Cosine distance 1 - cos(q, x), [B, N]."""
    if not q_normalized:
        q = normalize(q)
    if not x_normalized:
        x = normalize(x)
    return 1.0 - _matmul(q, x, compute_dtype)


def pairwise_scores(
    q, x, metric: Metric, x_norms_sq=None, x_normalized: bool = True,
    q_normalized: bool = False, compute_dtype=None,
) -> torch.Tensor:
    """Metric-dispatched [B, N] scores (HAMMING scores as L2 over 0/1 vectors)."""
    metric = metric.compute()
    if metric == Metric.L2:
        return squared_l2(q, x, x_norms_sq, compute_dtype)
    if metric == Metric.DOT:
        return dot_scores(q, x, compute_dtype)
    if metric == Metric.COSINE:
        return cosine_scores(q, x, x_normalized, q_normalized, compute_dtype)
    raise ValueError(f"unsupported metric for float scoring: {metric}")
