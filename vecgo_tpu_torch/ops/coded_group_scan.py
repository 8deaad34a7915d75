"""Coded IVF group scan + top-kk: the port of `pallas_coded_group_scan`.

`coded_group_scan` is the one kernel of the graph-segment path: it scores the
SQ8 residual codes of every probed cluster against the queries that probe
it, and keeps each (cluster, query) pair's kk nearest slots. On a CUDA tensor
it launches `csrc/coded_group_scan.cu` (or raises); on a CPU tensor it runs
`coded_group_scan_reference`, the plain PyTorch version it is tested against.
Any 1 <= kk <= S: up to 64 each query's list lives in the kernel's shared
memory; past it each (cluster, query slot) pools its survivors in a global
scratch that the wrapper allocates, and a second kernel selects and sorts.
"""

from __future__ import annotations

import ctypes
import math

import torch

LIST_KK = 64  # up to here one or two list entries a lane; past it, pools
_BIG = 3.0e38
_MAX_SMEM = 232_448  # shared memory a block may opt into (sm_90)
_MAX_GRID_X = 2**31 - 1
# Reference blocks hold at most this many scores ([clusters, qcap, S] f32).
_REF_BLOCK_ELEMS = 1 << 26
# Devices on which the kernel may use the whole opt-in shared memory.
_prepared: set = set()


def _layout(lib, d: int, qcap: int, kk: int, s: int):
    """(query slots per block, dynamic shared memory bytes, pool entries of a
    (cluster, query slot) past LIST_KK) of the kernel at this (d, qcap, kk,
    S), as the library computes them."""
    qg, smem, pool = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib.vecgo_coded_group_scan_layout(d, qcap, kk, s, ctypes.byref(qg), ctypes.byref(smem),
                                      ctypes.byref(pool))
    return qg.value, smem.value, pool.value


def _check(q, qtab, codes, bn, scale, cent, kk):
    if q.dtype != torch.float32 or q.dim() != 2:
        raise ValueError(f"q must be [B, d] float32, got {tuple(q.shape)} {q.dtype}")
    b, d = q.shape
    if qtab.dtype != torch.int32 or qtab.dim() != 2:
        raise ValueError(f"qtab must be [K, qcap] int32, got {qtab.dtype}")
    k, qcap = qtab.shape
    if codes.dtype != torch.int8 or codes.dim() != 3 or codes.shape[0] != k \
            or codes.shape[2] != d:
        raise ValueError(f"codes must be [K, S, d] int8, got {tuple(codes.shape)} {codes.dtype}")
    s = codes.shape[1]
    for name, t, shape in (("bn", bn, (k, s)), ("scale", scale, (k,)), ("cent", cent, (k, d))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} float32, got {tuple(t.shape)} {t.dtype}")
    if not 1 <= kk <= s:
        raise ValueError(f"coded_group_scan supports 1 <= kk <= S={s}, got {kk}")
    for t in (qtab, codes, bn, scale, cent):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got {t.device}")
    for t in (q, qtab, codes, bn, scale, cent):
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")


def coded_group_scan(q, qtab, codes, bn, scale, cent, kk: int):
    """Top-kk slots of every (cluster, probing query) pair.

    q [B, d] f32 queries (normalized upstream for cosine); qtab [K, qcap]
    int32, the queries probing each cluster (B marks an empty slot); codes
    [K, S, d] int8 SQ8 residual codes; bn [K, S] f32 |x^ - c|^2 (+inf at
    padded or masked slots); scale [K] f32; cent [K, d] f32.
    Returns sorted (ld [K, qcap, kk] f32, lc [K, qcap, kk] int32 in-cluster
    column) with (+inf, -1) for empty slots and missing entries; ties go to
    the lower column.
    """
    _check(q, qtab, codes, bn, scale, cent, kk)
    if q.device.type == "cpu":
        return coded_group_scan_reference(q, qtab, codes, bn, scale, cent, kk)
    if q.device.type != "cuda":
        raise ValueError(f"coded_group_scan runs on cpu or cuda, not {q.device}")
    b, d = q.shape
    k, qcap = qtab.shape
    s = codes.shape[1]
    from vecgo_tpu_torch.kernels import _build

    lib = _build.library()
    qg, smem, pool_cap = _layout(lib, d, qcap, kk, s)
    if smem > _MAX_SMEM:
        raise ValueError(f"coded_group_scan: d={d} needs {smem} bytes of shared memory "
                         f"(at most {_MAX_SMEM})")
    if k * -(-qcap // qg) > _MAX_GRID_X or (kk > LIST_KK and k * qcap > _MAX_GRID_X):
        raise ValueError(f"coded_group_scan supports K * ceil(qcap / {qg}) <= {_MAX_GRID_X} "
                         f"(and K * qcap past kk {LIST_KK}), got K={k}, qcap={qcap}")
    _prepare(lib, q.device)
    out_d = torch.empty((k, qcap, kk), dtype=torch.float32, device=q.device)
    out_i = torch.empty((k, qcap, kk), dtype=torch.int32, device=q.device)
    if k == 0 or qcap == 0:
        return out_d, out_i
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), qtab.data_ptr(), codes.data_ptr(), bn.data_ptr(), scale.data_ptr(),
            cent.data_ptr(), b, k, qcap, s, d, kk)
    with torch.cuda.device(q.device):  # the C launch uses the current device
        if kk <= LIST_KK:
            rc = lib.vecgo_coded_group_scan(*ptrs, out_d.data_ptr(), out_i.data_ptr(), stream)
        else:
            # Each (cluster, query slot)'s pool of 64-bit keys and its count.
            pool = torch.empty(k * qcap * pool_cap, dtype=torch.int64, device=q.device)
            pool_n = torch.empty(k * qcap, dtype=torch.int32, device=q.device)
            rc = lib.vecgo_coded_group_scan_pooled(*ptrs, pool.data_ptr(), pool_n.data_ptr(),
                                                   out_d.data_ptr(), out_i.data_ptr(), stream)
    _build.check(rc, "coded_group_scan launch")
    coded_group_scan.launches += 1
    return out_d, out_i


coded_group_scan.launches = 0


def _prepare(lib, device) -> None:
    """Let the kernel use the device's opt-in shared memory, once per device."""
    if device.index not in _prepared:
        from vecgo_tpu_torch.kernels import _build

        with torch.cuda.device(device):
            _build.check(lib.vecgo_coded_group_scan_prepare(), "coded_group_scan prepare")
        _prepared.add(device.index)


def coded_group_scan_reference(q, qtab, codes, bn, scale, cent, kk: int):
    """Plain PyTorch version of `coded_group_scan` (the coded branch of the
    JAX package's `_scan_groups`), blocked over clusters. Same contract, same
    tie order."""
    b, d = q.shape
    k, qcap = qtab.shape
    s = codes.shape[1]
    dev = q.device
    out_d = torch.full((k, qcap, kk), math.inf, dtype=torch.float32, device=dev)
    out_i = torch.full((k, qcap, kk), -1, dtype=torch.int32, device=dev)
    q_ext = torch.cat([q, torch.zeros((1, d), dtype=q.dtype, device=dev)])
    step = max(1, _REF_BLOCK_ELEMS // max(qcap * s, 1))
    for c0 in range(0, k, step):
        c1 = min(k, c0 + step)
        qt = qtab[c0:c1].long()
        live = (qt >= 0) & (qt < b)
        qr = q_ext[torch.where(live, qt, b)] - cent[c0:c1, None, :]  # [g, qcap, d]
        qrn = (qr * qr).sum(-1)
        prod = torch.matmul(qr.to(torch.bfloat16).float(), codes[c0:c1].float().transpose(1, 2))
        dd = qrn[:, :, None] + bn[c0:c1, None, :] - 2.0 * (scale[c0:c1, None, None] * prod)
        ok = torch.isfinite(dd) & (dd < _BIG) & live[:, :, None]
        dd = torch.where(ok, dd, math.inf)
        sd, idx = torch.sort(dd, dim=-1, stable=True)
        sd, idx = sd[..., :kk], idx[..., :kk]
        found = torch.isfinite(sd)
        out_d[c0:c1] = torch.where(found, sd, math.inf)
        out_i[c0:c1] = torch.where(found, idx, -1).to(torch.int32)
    return out_d, out_i
