"""The plain reference: the exact top-k of each query over the visible rows.

Plain PyTorch, in blocks of rows, on whatever device holds the inputs. It
normalizes the generated rows and queries itself (cosine), and takes nothing
that the program made: only the generator's rows, the deleted ids and the
metadata. Distances follow the program's convention, smaller is better:
cosine 1 - cos(q, x), squared L2, or the negative inner product.

`precision="f32"` is IEEE float32 (TF32 off), the reference. `"tf32"` is the
control: the same computation with the products' operands in TF32 (on the
card its tensor cores; elsewhere the operands rounded to TF32's 10 mantissa
bits, which is what those tensor cores multiply).
"""

from __future__ import annotations

import contextlib
from typing import Iterable, List, Optional, Tuple

import torch

_SCORE_ELEMS = 1 << 29  # scores a block holds at once (2 GiB of f32)


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-30)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to nearest on TF32's 10 explicit mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def _matmul_precision(precision: str, device: torch.device):
    if device.type != "cuda":
        yield
        return
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _product(q: torch.Tensor, x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32" and q.device.type != "cuda":
        q, x = round_tf32(q), round_tf32(x)
    with _matmul_precision(precision, q.device):
        return q @ x.T


def distances(q: torch.Tensor, x: torch.Tensor, metric: str,
              precision: str = "f32") -> torch.Tensor:
    """[B, N] distances of queries q [B, d] to rows x [N, d]."""
    if metric == "cosine":
        return 1.0 - _product(normalize(q), normalize(x), precision)
    if metric == "l2":
        dot = _product(q, x, precision)
        return ((q * q).sum(1, keepdim=True) + (x * x).sum(1)[None, :] - 2.0 * dot).clamp_min(0.0)
    if metric == "dot":
        return -_product(q, x, precision)
    raise ValueError(f"unknown metric {metric!r}")


def exact_topk(q: torch.Tensor, blocks: Iterable[Tuple[int, torch.Tensor]], visible: torch.Tensor,
               k: int, metric: str, precision: str = "f32") -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted (distances [B, k] f32, ids [B, k] int64) of the k visible rows
    nearest each query. `blocks` yields (first id, rows [n, d] f32);
    `visible` [ids] bool says which ids may be returned. -1 and +inf pad
    where fewer than k are visible."""
    b = q.shape[0]
    best_d = torch.full((b, k), float("inf"), device=q.device)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=q.device)
    for id0, rows in blocks:
        step = max(1, _SCORE_ELEMS // max(b, 1))
        for s in range(0, rows.shape[0], step):
            x = rows[s : s + step]
            d = distances(q, x, metric, precision)
            ok = visible[id0 + s : id0 + s + x.shape[0]]
            d = torch.where(ok[None, :], d, float("inf"))
            kk = min(k, x.shape[0])
            bd, bi = torch.topk(d, kk, dim=1, largest=False)
            cd = torch.cat([best_d, bd], 1)
            ci = torch.cat([best_i, bi + (id0 + s)], 1)
            best_d, pos = torch.topk(cd, k, dim=1, largest=False)
            best_i = torch.gather(ci, 1, pos)
            del d
    best_i = torch.where(torch.isfinite(best_d), best_i, -1)
    return best_d, best_i


def gather(blocks: List[Tuple[int, torch.Tensor]], ids: torch.Tensor) -> torch.Tensor:
    """Rows of `ids` (any shape, every id valid) from the blocks, [*ids, d]."""
    out = None
    for id0, rows in blocks:
        inside = (ids >= id0) & (ids < id0 + rows.shape[0])
        if out is None:
            out = torch.zeros((*ids.shape, rows.shape[1]), dtype=rows.dtype, device=rows.device)
        out[inside] = rows[ids[inside] - id0]
    return out


def distances_of(q: torch.Tensor, blocks: List[Tuple[int, torch.Tensor]], ids: torch.Tensor,
                 metric: str) -> torch.Tensor:
    """float64 distances [B, C] of each query to its own candidate ids
    [B, C] (-1 gives +inf): the yardstick that answers are judged by."""
    safe = ids.clamp_min(0)
    x = gather(blocks, safe).double()
    qd = q.double()
    if metric == "cosine":
        x = x / x.norm(dim=2, keepdim=True).clamp_min(1e-300)
        qd = qd / qd.norm(dim=1, keepdim=True).clamp_min(1e-300)
        d = 1.0 - torch.einsum("bcd,bd->bc", x, qd)
    elif metric == "l2":
        d = ((x - qd[:, None, :]) ** 2).sum(2)
    elif metric == "dot":
        d = -torch.einsum("bcd,bd->bc", x, qd)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return torch.where(ids >= 0, d, float("inf"))


def visible_mask(total: int, deleted: torch.Tensor, meta: dict, flt: Optional[dict],
                 device) -> torch.Tensor:
    """[total] bool: ids neither deleted nor excluded by the filter."""
    vis = torch.ones(total, dtype=torch.bool, device=device)
    vis[deleted.to(device)] = False
    if flt:
        col = torch.as_tensor(meta[flt["field"]], device=device)
        vis &= _OPS[flt["op"]](col, flt["value"])
    return vis


_OPS = {
    "eq": lambda c, v: c == v,
    "neq": lambda c, v: c != v,
    "lt": lambda c, v: c < v,
    "lte": lambda c, v: c <= v,
    "gt": lambda c, v: c > v,
    "gte": lambda c, v: c >= v,
    "isin": lambda c, v: torch.isin(c, torch.as_tensor(v, device=c.device)),
}
