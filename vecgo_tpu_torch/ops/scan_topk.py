"""Fused distance scan + top-k: the port of `pallas_l2_topk`.

`scan_topk` is the one kernel of the flat path. It carries the flat-segment
pool scan, the compact-gather scan and the memtable chunks. On a CUDA tensor
it launches `csrc/scan_topk.cu` (or raises); on a CPU tensor it runs
`scan_topk_reference`, the plain PyTorch version it is tested against.
"""

from __future__ import annotations

import math

import torch

from vecgo_tpu.model import Metric

MAX_K = 256
_METRIC_CODES = {Metric.L2: 0, Metric.DOT: 1, Metric.COSINE: 2}
# Reference blocks hold at most this many scores ([B, block] f32, 256 MB).
_REF_BLOCK_ELEMS = 1 << 26
# Kernel tiling (must match csrc/scan_topk.cu).
_TQ = _TN = 64
# Merge cost grows with splits * k candidates per query; keep it bounded.
_MAX_MERGE_WIDTH = 8192
_MAX_GRID_Y = 65535  # query tiles run along the grid's y dimension


def metric_code(metric) -> int:
    """0 = l2, 1 = dot, 2 = cos (scores over normalized storage)."""
    if isinstance(metric, str):
        metric = {"cos": Metric.COSINE}.get(metric) or Metric(metric)
    return _METRIC_CODES[metric.compute()]


def _check(q, x, xnorm2, k, code, mask):
    if not 1 <= k <= MAX_K:
        raise ValueError(f"scan_topk supports 1 <= k <= {MAX_K}, got k={k}")
    if q.dtype != torch.float32 or q.dim() != 2:
        raise ValueError(f"q must be [B, d] float32, got {tuple(q.shape)} {q.dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2:
        raise ValueError(f"x must be [N, d] float32 or bfloat16, got {x.dtype}")
    if x.shape[1] != q.shape[1]:
        raise ValueError(f"dim mismatch: q {tuple(q.shape)} vs x {tuple(x.shape)}")
    n = x.shape[0]
    tensors = [q, x]
    if code == 0:
        if xnorm2 is None or xnorm2.shape != (n,) or xnorm2.dtype != torch.float32:
            raise ValueError("l2 needs xnorm2 [N] float32")
        tensors.append(xnorm2)
    if mask is not None:
        if mask.shape != (n,) or mask.dtype not in (torch.bool, torch.uint8):
            raise ValueError("mask must be [N] bool or uint8")
        tensors.append(mask)
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")


def scan_topk(q, x, xnorm2, k: int, metric="l2", mask=None):
    """Top-k smallest scores of each query over the rows of x.

    q [B, d] f32; x [N, d] f32 or bf16; xnorm2 [N] f32 (l2 only; may be None
    otherwise); mask [N] bool/uint8 or None (False = row excluded).
    Returns sorted (d [B, k] f32, i [B, k] int32) with (+inf, -1) where fewer
    than k rows are eligible; ties go to the lower row id.
    """
    code = metric_code(metric)
    _check(q, x, xnorm2, k, code, mask)
    if q.device.type == "cpu":
        return scan_topk_reference(q, x, xnorm2, k, metric, mask)
    if q.device.type != "cuda":
        raise ValueError(f"scan_topk runs on cpu or cuda, not {q.device}")
    from vecgo_tpu_torch.kernels import _build

    lib = _build.library()
    b, d = q.shape
    n = x.shape[0]
    out_d = torch.empty((b, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=q.device)
    if b == 0:
        return out_d, out_i
    if n == 0:
        return out_d.fill_(math.inf), out_i.fill_(-1)
    n_tiles = -(-n // _TN)
    q_tiles = -(-b // _TQ)
    if q_tiles > _MAX_GRID_Y:
        raise ValueError(f"scan_topk takes at most {_MAX_GRID_Y * _TQ} queries per call, got {b}")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = min(n_tiles, max(1, -(-4 * sms // q_tiles)), max(1, _MAX_MERGE_WIDTH // k))
    rows_per_split = -(-n_tiles // splits) * _TN
    splits = -(-n // rows_per_split)
    part_d = part_i = None
    if splits > 1:
        part_d = torch.empty((b, splits, k), dtype=torch.float32, device=q.device)
        part_i = torch.empty((b, splits, k), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):  # the C launch uses the current device
        rc = lib.vecgo_scan_topk(
            q.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16),
            xnorm2.data_ptr() if code == 0 else None,
            mask.data_ptr() if mask is not None else None,
            b, n, d, k, code, rows_per_split, splits,
            part_d.data_ptr() if part_d is not None else None,
            part_i.data_ptr() if part_i is not None else None,
            out_d.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(rc, "scan_topk launch")
    scan_topk.launches += 1
    return out_d, out_i


scan_topk.launches = 0


def scan_topk_reference(q, x, xnorm2, k: int, metric="l2", mask=None):
    """Plain PyTorch version of `scan_topk`, blocked over N so it never holds
    the [B, N] score matrix. Same contract, same tie order."""
    code = metric_code(metric)
    b, n = q.shape[0], x.shape[0]
    dev = q.device
    qc = q.to(torch.bfloat16).float() if x.dtype == torch.bfloat16 else q
    qn = (q * q).sum(1, keepdim=True)
    best_d = torch.full((b, k), math.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    block = max(_TN, _REF_BLOCK_ELEMS // max(b, 1))
    for s in range(0, n, block):
        e = min(n, s + block)
        prod = qc @ x[s:e].float().T
        if code == 0:
            sc = qn + xnorm2[s:e][None, :] - 2.0 * prod
        elif code == 1:
            sc = -prod
        else:
            sc = 1.0 - prod
        ok = torch.isfinite(sc)
        if mask is not None:
            ok &= mask[s:e].bool()[None, :]
        sc = torch.where(ok, sc, math.inf)
        ids = torch.arange(s, e, device=dev).expand(b, -1)
        # Stable sort: the running list (lower ids, already (d, id)-ordered)
        # precedes the block's rows in id order, so equal scores keep the
        # lower id first.
        cd = torch.cat([best_d, sc], 1)
        ci = torch.cat([best_i, ids], 1)
        cd, order = torch.sort(cd, dim=1, stable=True)
        best_d = cd[:, :k].contiguous()
        best_i = torch.gather(ci, 1, order[:, :k])
    found = torch.isfinite(best_d)
    return (
        torch.where(found, best_d, math.inf),
        torch.where(found, best_i, -1).to(torch.int32),
    )
