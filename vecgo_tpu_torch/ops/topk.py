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
from vecgo_tpu_torch.utils.tensors import host_tensor

# A plain score block holds at most this many scores ([B, rows] f32, 256 MB).
_SCORE_BLOCK_ELEMS = 1 << 26
# Plain score blocks narrower than this select with a stable sort (ties to the
# lower row, as `lax.top_k`); from here up with `torch.topk`, which is exact
# but leaves the order of equal scores open. The JAX package switches to
# `lax.approx_min_k` at the same width, so its tie order ends there too.
_STABLE_BELOW = 16384


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


class BlockScanner:
    """Top-k of one query batch over blocks of a quantizer's codes.

    `BlockScanner(quant, metric)(q, k)` prepares the batch once and returns
    `scan(blk, mask_blk) -> (d [B, k] f32, rows [B, k] int64 within the
    block, -1 missing)`, where blk maps the quantizer's code arrays to
    tensors on q's device. Where the quantizer's score has `scan_topk`'s form
    (`Quantizer.scan_form`), the block is decoded to a transient bf16 table
    and handed to the kernel with the transformed query; the per-query
    constant the transform drops is added to the returned distances (it
    changes no ranking). Any k goes to the kernel.
    Where the score has no such form (cosine's and RaBitQ's per-row factors,
    symmetric Hamming), the block's plain [B, rows] score matrix goes through
    a plain selection, in sub-blocks of at most 2^26 scores.
    """

    def __init__(self, quant, metric: Metric):
        self.quant = quant
        self.metric = metric.compute()

    def __call__(self, q: torch.Tensor, k: int):
        quant, metric = self.quant, self.metric
        form = quant.scan_form(q, metric)
        if form is not None:
            qp, const, kmetric = form

            def scan(blk, mask_blk):
                table, rn = quant.scan_table(blk)
                d, i = scan_topk(qp, table.contiguous(),
                                 rn.contiguous() if kmetric == Metric.L2 else None,
                                 k, kmetric, mask_blk)
                if const is not None:
                    d = d + const[:, None]
                if kmetric == Metric.L2:
                    d = d.clamp_min(0.0)
                return d, i.long()

            return scan

        def scan_plain(blk, mask_blk):
            n = next(iter(blk.values())).shape[0]
            b = q.shape[0]
            best_d = torch.full((b, k), math.inf, dtype=torch.float32, device=q.device)
            best_i = torch.full((b, k), -1, dtype=torch.int64, device=q.device)
            step = max(128, _SCORE_BLOCK_ELEMS // max(b, 1))
            for s in range(0, n, step):
                e = min(n, s + step)
                sc = quant.score(q, {name: v[s:e] for name, v in blk.items()}, metric)
                if mask_blk is not None:
                    sc = torch.where(mask_blk[s:e][None, :], sc, math.inf)
                if e - s < _STABLE_BELOW:
                    d, i = topk_smallest(sc, min(k, e - s))
                else:
                    d, i = torch.topk(sc, min(k, e - s), dim=1, largest=False)
                best_d, best_i = merge_topk_sorted(best_d, best_i, d, i + s, k)
            return best_d, torch.where(torch.isfinite(best_d), best_i, -1)

        return scan_plain


def blockwise_topk_scored(q, enc: dict, n: int, k: int, scanner, *, mask=None,
                          block_rows: int = 131072, rows=None):
    """Running top-k of q [B, d] over device-resident code arrays (enc: name
    -> tensor [n, ...]) in blocks of `block_rows` rows, restricted to the row
    range rows=(r0, r1) when given. mask [n] bool on the device (False = row
    excluded). Returns (d [B, k] f32, rows [B, k] int64, -1 missing)."""
    r0, r1 = rows if rows is not None else (0, n)
    scan = scanner(q, k)
    b = q.shape[0]
    best_d = torch.full((b, k), math.inf, dtype=torch.float32, device=q.device)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=q.device)
    block_rows = max(128, block_rows)
    for s in range(r0, r1, block_rows):
        e = min(r1, s + block_rows)
        d, i = scan({name: v[s:e] for name, v in enc.items()},
                    None if mask is None else mask[s:e])
        best_d, best_i = merge_topk_sorted(
            best_d, best_i, d, torch.where(i >= 0, i + s, -1), k)
    return best_d, torch.where(torch.isfinite(best_d), best_i, -1)


def streaming_topk_scored(q, enc_host: dict, n: int, k: int, scanner, *, mask=None,
                          block_rows: int = 131072, rows=None):
    """Beyond-device streaming scan: the code arrays (enc_host: name -> numpy
    [n, ...]) stay in host memory; row blocks are uploaded on demand and
    folded into a running top-k on the device, so device memory stays
    O(block_rows) whatever n is.

    On a card two blocks are in flight: each block is copied into one of two
    pinned staging buffers (the host arrays are often read-only views of a
    container and never pinned) and uploaded on a copy stream while the
    previous block is scanned; events order the reuse of both the pinned and
    the device buffers. The tail block is scanned short. mask: [n] bool on
    the device (one byte a row, uploaded once by the caller). Same results
    as `blockwise_topk_scored` over the same arrays."""
    r0, r1 = rows if rows is not None else (0, n)
    scan = scanner(q, k)
    b = q.shape[0]
    dev = q.device
    best_d = torch.full((b, k), math.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    block_rows = max(128, min(block_rows, max(r1 - r0, 1)))
    starts = list(range(r0, r1, block_rows))
    if not starts:
        return best_d, best_i

    def fold(blk, s, e):
        nonlocal best_d, best_i
        d, i = scan(blk, None if mask is None else mask[s:e])
        best_d, best_i = merge_topk_sorted(
            best_d, best_i, d, torch.where(i >= 0, i + s, -1), k)

    if dev.type != "cuda":
        for s in starts:
            e = min(r1, s + block_rows)
            fold({name: host_tensor(arr[s:e]) for name, arr in enc_host.items()}, s, e)
        return best_d, torch.where(torch.isfinite(best_d), best_i, -1)

    cur = torch.cuda.current_stream(dev)
    copy_stream = torch.cuda.Stream(dev)
    slots = []
    for _ in range(2):
        bufs = {}
        for name, arr in enc_host.items():
            probe = host_tensor(arr[0:0])
            shape = (block_rows,) + tuple(probe.shape[1:])
            bufs[name] = (torch.empty(shape, dtype=probe.dtype, pin_memory=True),
                          torch.empty(shape, dtype=probe.dtype, device=dev))
        slots.append({"bufs": bufs, "uploaded": torch.cuda.Event(), "scanned": torch.cuda.Event()})
        slots[-1]["scanned"].record(cur)

    def upload(bi):
        s = starts[bi]
        e = min(r1, s + block_rows)
        slot = slots[bi % 2]
        # The pinned buffer is free once its last upload has finished; the
        # device buffer once the scan that read it has.
        slot["uploaded"].synchronize()
        for name, arr in enc_host.items():
            slot["bufs"][name][0][: e - s].copy_(host_tensor(arr[s:e]))
        with torch.cuda.stream(copy_stream):
            copy_stream.wait_event(slot["scanned"])
            for pinned, device_buf in slot["bufs"].values():
                device_buf[: e - s].copy_(pinned[: e - s], non_blocking=True)
            slot["uploaded"].record(copy_stream)

    upload(0)
    for bi, s in enumerate(starts):
        e = min(r1, s + block_rows)
        slot = slots[bi % 2]
        cur.wait_event(slot["uploaded"])
        fold({name: device_buf[: e - s] for name, (_, device_buf) in slot["bufs"].items()}, s, e)
        slot["scanned"].record(cur)
        if bi + 1 < len(starts):
            upload(bi + 1)
    # Every upload was awaited by a scan on the current stream, so the device
    # buffers (allocated on it) can go back to the allocator in stream order.
    return best_d, torch.where(torch.isfinite(best_d), best_i, -1)


def probed_topk(q, k: int, probes: torch.Tensor, bounds, scan_rows):
    """Top-k of each query over the rows of its probed partitions only.

    The rows are sorted by partition, so partition p is the contiguous row
    range bounds[p]:bounds[p+1] (host ints). The probes [B, P] are inverted
    (for each partition, the queries that probe it: one sort and one count,
    read back to the host), `scan_rows(query index tensor, r0, r1) ->
    (d [b', k], rows [b', k])` scans one partition's range for those queries
    only, and each query's P lists are merged. Rows of unprobed partitions
    are excluded exactly, and never read."""
    b, p = probes.shape
    parts = len(bounds) - 1
    flat = probes.reshape(-1)
    order = torch.sort(flat, stable=True).indices  # pairs grouped by partition
    qidx = order // p
    counts = torch.bincount(flat, minlength=parts).cpu().tolist()
    pair_d = torch.full((b * p, k), math.inf, dtype=torch.float32, device=q.device)
    pair_i = torch.full((b * p, k), -1, dtype=torch.int64, device=q.device)
    start = 0
    for part, c in enumerate(counts):
        r0, r1 = int(bounds[part]), int(bounds[part + 1])
        if c and r1 > r0:
            d, i = scan_rows(qidx[start : start + c], r0, r1)
            pair_d[start : start + c] = d
            pair_i[start : start + c] = i
        start += c
    inv = torch.empty_like(order)
    inv[order] = torch.arange(b * p, device=q.device)
    return topk_smallest_with_ids(pair_d[inv].reshape(b, p * k), pair_i[inv].reshape(b, p * k), k)
