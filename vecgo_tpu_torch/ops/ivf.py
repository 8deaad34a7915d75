"""Blocked IVF tables and their scan (port of vecgo_tpu/ops/ivf.py).

A graph segment serves from an SQ8-residual coded table: rows are bucketed
into K capacity-capped clusters (the graph build's own membership, or
`build_ivf_table`'s for the beam build), each cluster's residuals
x - centroid are int8-coded with a per-cluster scale, and the codes are the
only vector data on the device. `compact=True` first repacks the membership
to one slot per row (`compact_members_primary`). A query batch

  1. scores the centroids [B, K] and takes its `n_probe` nearest clusters,
  2. inverts the probe lists into, per cluster, the queries that probe it
     (one device sort plus run arithmetic),
  3. scans every probed cluster's codes against its queries and keeps each
     (cluster, query) pair's kk nearest slots: kernel B, `coded_group_scan`,
  4. scatters those winners back into per-query candidate tables.

Steps 2-4 are `scan_groups`, which takes its probes from the caller: the
cluster cache (ops/ivf_cache.py) probes every centroid of a segment but scans
only the clusters it holds, so its probe space and its scan space differ.

On a CUDA tensor step 3 launches the kernel at every dimension (the JAX
package's d % 128 and VMEM gates were the TPU compiler's); on a CPU tensor
it runs the kernel's plain version, the coded branch of `_scan_groups`.

The uncoded table (`IVFDeviceTable`, bf16 residual blocks, `device_table`)
is scanned with plain torch ops, as the JAX package scans it with XLA: no
Pallas kernel lies on that branch.
"""

from __future__ import annotations

import logging
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from vecgo_tpu_torch.ops import topk as T
from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan

# int16 refinement step as a multiple of the int8 scale (vecgo_tpu.ops.ivf).
RSCALE_RATIO = 127.0 / 32767.0
# Clusters encoded per step of the table build (bounds the f32 transient).
_BUILD_CLUSTERS = 64
# Rows encoded per step of the int16 refinement plane.
_REFINE_ROWS = 131072
# Elements of the [clusters, qcap, S] distance block of the uncoded scan.
_SCAN_ELEMS = 1 << 24


class IVFDeviceTable(NamedTuple):
    """bf16 residual blocked layout on the device (see vecgo_tpu.ops.ivf):
    the scan scores d(q, x) = |q-c|^2 + |x-c|^2 - 2 (q-c).(x-c)."""

    blocks: torch.Tensor  # [K, S, d] bf16 residuals (x - centroid), padding zero
    bnorm2: torch.Tensor  # [K, S] f32 |x - c|^2, +inf at padded slots
    rows: torch.Tensor  # [K, S] int32 segment row per slot, -1 padded
    centroids: torch.Tensor  # [K, d] f32
    cnorm2: torch.Tensor  # [K] f32, +inf for empty/padded clusters


class IVFCodedTable(NamedTuple):
    """SQ8-residual blocked layout on the device (see vecgo_tpu.ops.ivf)."""

    codes: torch.Tensor  # [K, S, d] int8 residual codes, padding zero
    scale: torch.Tensor  # [K] f32 dequant scale (max|res| / 127 per cluster)
    bnorm2: torch.Tensor  # [K, S] f32 |x^ - c|^2 (decoded), +inf at padded slots
    xnorm2: torch.Tensor  # [K, S] f32 |x^|^2 (decoded absolute), +inf padded
    rows: torch.Tensor  # [K, S] int32 segment row per slot, -1 padded
    slot_of_row: torch.Tensor  # [N] int32 a slot containing each row
    centroids: torch.Tensor  # [K, d] f32 (member means)
    cnorm2: torch.Tensor  # [K] f32, +inf for empty/padded clusters
    rcodes: Optional[torch.Tensor] = None  # [N, d] int16 refinement plane


def _coded_build(mdev: torch.Tensor, x: torch.Tensor) -> IVFCodedTable:
    """Encode the SQ8-residual table from a membership mdev [K, S] int32
    (-1 padded) over rows x [N, d] (f32 or bf16, on the same device).
    Centroids are the member means."""
    k_pad, s = mdev.shape
    n, d = x.shape
    dev = x.device
    codes = torch.empty((k_pad, s, d), dtype=torch.int8, device=dev)
    scale = torch.empty(k_pad, dtype=torch.float32, device=dev)
    bn = torch.empty((k_pad, s), dtype=torch.float32, device=dev)
    xn = torch.empty((k_pad, s), dtype=torch.float32, device=dev)
    cent = torch.empty((k_pad, d), dtype=torch.float32, device=dev)
    cn = torch.empty(k_pad, dtype=torch.float32, device=dev)
    for g0 in range(0, k_pad, _BUILD_CLUSTERS):
        g1 = min(k_pad, g0 + _BUILD_CLUSTERS)
        mg = mdev[g0:g1]
        valid = mg >= 0
        v = x[mg.clamp_min(0).reshape(-1).long()].reshape(g1 - g0, s, d).float()
        v = torch.where(valid[:, :, None], v, 0.0)
        cnt = valid.sum(1).float()
        c = v.sum(1) / cnt.clamp_min(1.0)[:, None]
        res = torch.where(valid[:, :, None], v - c[:, None, :], 0.0)
        sc = (res.abs().amax(dim=(1, 2)) / 127.0).clamp_min(1e-12)
        cd = torch.round(res / sc[:, None, None]).clamp(-127, 127).to(torch.int8)
        res_hat = cd.float() * sc[:, None, None]
        xhat = c[:, None, :] + res_hat
        codes[g0:g1] = cd
        scale[g0:g1] = sc
        bn[g0:g1] = torch.where(valid, (res_hat * res_hat).sum(-1), math.inf)
        xn[g0:g1] = torch.where(valid, (xhat * xhat).sum(-1), math.inf)
        cent[g0:g1] = c
        cn[g0:g1] = torch.where(cnt > 0, (c * c).sum(-1), math.inf)
    # slot_of_row: one slot per row; where overlap memberships hold a row
    # twice, the higher slot id (the last write of the JAX scatter) wins.
    flat_rows = mdev.reshape(-1).long()
    target = torch.where(flat_rows >= 0, flat_rows, n)
    slot_ids = torch.arange(k_pad * s, device=dev)
    sor = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    sor.scatter_reduce_(0, target, slot_ids, reduce="amax", include_self=True)
    slot_of_row = sor[:n].clamp_min(0).to(torch.int32)
    return IVFCodedTable(codes, scale, bn, xn, mdev, slot_of_row, cent, cn)


def _refine_codes(xf: torch.Tensor, slot_of_row, cents, scale, s: int) -> torch.Tensor:
    """Per-row int16 residual codes against the row's own (slot_of_row)
    cluster centroid: the refinement plane for pool rescoring."""
    n, d = xf.shape
    out = torch.empty((n, d), dtype=torch.int16, device=xf.device)
    for r0 in range(0, n, _REFINE_ROWS):
        r1 = min(n, r0 + _REFINE_ROWS)
        cl = (slot_of_row[r0:r1] // s).long()
        rs = scale[cl] * RSCALE_RATIO
        qv = torch.round((xf[r0:r1].float() - cents[cl]) / rs[:, None])
        out[r0:r1] = qv.clamp(-32767, 32767).to(torch.int16)
    return out


def _padded_members(members, group: int, dev) -> torch.Tensor:
    """Membership [K, S] (numpy or tensor) as int32 on dev, padded with
    empty clusters to a multiple of `group`."""
    m = torch.as_tensor(np.asarray(members) if not isinstance(members, torch.Tensor)
                        else members).to(device=dev, dtype=torch.int32)
    k, s = m.shape
    k_pad = -(-k // group) * group
    if k_pad > k:
        m = torch.cat([m, torch.full((k_pad - k, s), -1, dtype=torch.int32, device=dev)])
    return m.contiguous()


def _member_res_norms(mdev: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-slot |x - cluster mean|^2 [K, S] (+inf padded): pass 1 of the
    compact repack."""
    k_pad, s = mdev.shape
    rn = torch.empty((k_pad, s), dtype=torch.float32, device=x.device)
    for g0 in range(0, k_pad, _BUILD_CLUSTERS):
        mg = mdev[g0 : g0 + _BUILD_CLUSTERS]
        valid = mg >= 0
        v = x[mg.clamp_min(0).reshape(-1).long()].reshape(mg.shape[0], s, -1).float()
        v = torch.where(valid[:, :, None], v, 0.0)
        cent = v.sum(1) / valid.sum(1).float().clamp_min(1.0)[:, None]
        res = v - cent[:, None, :]
        rn[g0 : g0 + _BUILD_CLUSTERS] = torch.where(valid, (res * res).sum(-1), math.inf)
    return rn


def compact_members_primary(members, vectors: torch.Tensor, group: int = 8) -> np.ndarray:
    """Repack a (possibly overlapping) membership so that every row keeps
    one slot, the one whose cluster mean is nearest (ties to the smallest
    slot id): the serve_compact table. Returns the host membership [K', S']
    (K' the clusters padded to `group`; S' the largest occupancy left,
    rounded up to 128, at least 32, at most S), each cluster's rows first."""
    dev = vectors.device
    mdev = _padded_members(members, group, dev)
    n = vectors.shape[0]
    flat_rows = mdev.reshape(-1).long()
    flat_rn = _member_res_norms(mdev, vectors).reshape(-1)
    safe = torch.where(flat_rows >= 0, flat_rows, n)
    best = torch.full((n + 1,), math.inf, dtype=torch.float32, device=dev)
    best.scatter_reduce_(0, safe, flat_rn, reduce="amin", include_self=True)
    is_best = (flat_rn <= best[safe]) & (flat_rows >= 0)
    slot_ids = torch.arange(flat_rows.shape[0], device=dev)
    big = 1 << 30
    best_slot = torch.full((n + 1,), big, dtype=torch.int64, device=dev)
    best_slot.scatter_reduce_(0, torch.where(is_best, safe, n),
                              torch.where(is_best, slot_ids, big), reduce="amin",
                              include_self=True)
    kept = torch.where(slot_ids == best_slot[safe], flat_rows, -1).reshape(mdev.shape)
    # Valid entries first within each cluster (their order carries no meaning).
    kept = kept.gather(1, torch.sort((kept < 0).int(), dim=1, stable=True).indices)
    occupancy = int((kept >= 0).sum(1).max())
    s2 = max(32, -(-occupancy // 128) * 128)
    return kept[:, :s2].to(torch.int32).cpu().numpy()


def device_table_coded(members, vectors: torch.Tensor, group: int = 8,
                       compact: bool = False, refine=None) -> IVFCodedTable:
    """The SQ8-residual serving table on `vectors.device` from a membership
    table [K, S] (numpy or tensor; -1 padded), padded to a multiple of
    `group` clusters as the JAX package pads it. compact=True first repacks
    the membership to one slot per row (`compact_members_primary`). refine:
    an f32 [N, d] source for the int16 refinement plane (`rcodes`), or None."""
    dev = vectors.device
    if compact:
        members = compact_members_primary(members, vectors, group)
    m = _padded_members(members, group, dev)
    table = _coded_build(m, vectors)
    if refine is not None:
        xf = torch.as_tensor(refine, dtype=torch.float32).to(dev)
        table = table._replace(rcodes=_refine_codes(
            xf, table.slot_of_row, table.centroids, table.scale, m.shape[1]))
    return table


def device_table(members, centroids: np.ndarray, vectors: torch.Tensor,
                 group: int = 8) -> IVFDeviceTable:
    """The bf16 residual table on `vectors.device` ([N, d], any float type):
    residuals against the given centroids; K padded to a multiple of `group`
    with empty clusters (+inf centroid norm, never probed)."""
    dev = vectors.device
    m = _padded_members(members, group, dev)
    k_pad, s = m.shape
    k, d = centroids.shape
    c = np.zeros((k_pad, d), np.float32)
    c[:k] = centroids
    cn = np.full(k_pad, np.inf, np.float32)
    cn[:k] = np.einsum("kd,kd->k", centroids, centroids, dtype=np.float64)
    cdev = torch.from_numpy(c).to(dev)
    valid = m >= 0
    blocks = torch.empty((k_pad, s, d), dtype=torch.bfloat16, device=dev)
    bn = torch.empty((k_pad, s), dtype=torch.float32, device=dev)
    for g0 in range(0, k_pad, _BUILD_CLUSTERS):
        mg, vg = m[g0 : g0 + _BUILD_CLUSTERS], valid[g0 : g0 + _BUILD_CLUSTERS]
        v = vectors[mg.clamp_min(0).reshape(-1).long()].reshape(mg.shape[0], s, d).float()
        res = torch.where(vg[:, :, None], v - cdev[g0 : g0 + _BUILD_CLUSTERS, None, :], 0.0)
        bn[g0 : g0 + _BUILD_CLUSTERS] = torch.where(vg, (res * res).sum(-1), math.inf)
        blocks[g0 : g0 + _BUILD_CLUSTERS] = res.to(torch.bfloat16)
    return IVFDeviceTable(blocks, bn, m, cdev, torch.from_numpy(cn).to(dev))


def build_ivf_table(x: np.ndarray, *, capacity: int = 512, slack: float = 1.5,
                    overlap: int = 4, seed: int = 42, kmeans_iters: int = 5,
                    device="cuda"):
    """Train centroids on a sample and bucket every row into its `overlap`
    nearest of K = ceil(N * slack / capacity) capacity-capped clusters (the
    beam build's serving membership). k-means and the assignment run on
    `device`; the membership is the build's hash-scatter form. Returns
    (centroids [K, d] f32, members [K, capacity] int32, -1 padded), every
    row in at least one slot (`_fixup_coverage`)."""
    from vecgo_tpu_torch.index import build_fast as bf
    from vecgo_tpu_torch.quantization import kmeans as km

    n, d = x.shape
    x = np.ascontiguousarray(x, np.float32)
    k = max(2, math.ceil(n * slack / capacity))
    rng = np.random.default_rng(seed)
    n_sample = min(n, max(32768, 12 * k))
    idx = rng.choice(n, n_sample, replace=False)
    centroids, _ = km.train_kmeans(x[idx], k, iters=kmeans_iters, seed=seed, sample=n_sample,
                                   device=device)
    block = 8192
    n_pad = -(-n // block) * block
    dev = torch.device(device)
    x16 = torch.zeros((n_pad, d), dtype=torch.bfloat16, device=dev)
    x16[:n] = torch.from_numpy(x).to(dev)
    rn = np.full(n_pad, np.inf, np.float32)
    rn[:n] = np.einsum("nd,nd->n", x, x, dtype=np.float64).astype(np.float32)
    ov = max(1, min(overlap, 4, k))
    a_dev, d_dev = bf._assign_topk(x16, torch.from_numpy(rn).to(dev),
                                   torch.from_numpy(centroids).to(dev), ov, block)
    del x16
    # Padded rows go to a dump cluster k, then the capacity-capped membership.
    a_dev = torch.where((torch.arange(n_pad, device=dev) < n)[:, None], a_dev, k)
    members, _, _, covered = bf._membership_scatter(a_dev, d_dev, k + 1, capacity)
    members = members[:k].cpu().numpy()
    covered = covered[:n].cpu().numpy()
    if not covered.all():
        _fixup_coverage(members, covered, a_dev[:n].cpu().numpy())
    return np.asarray(centroids, np.float32), members


def _fixup_coverage(members: np.ndarray, covered: np.ndarray, assign: np.ndarray):
    """Place every uncovered point in a slot, preferring its own clusters
    (host numpy, a copy of the JAX package's). Free slots come from unused
    padding first, then from evicting redundant overlap memberships (entries
    whose point is covered elsewhere), so coverage holds whenever the slots
    outnumber the rows. Mutates `members` in place."""
    rows_idx, cols_idx = np.nonzero(members >= 0)
    pts = members[rows_idx, cols_idx]
    # Evictable = all-but-one slot of every multiply-covered point.
    order = np.argsort(pts, kind="stable")
    pe = pts[order]
    first = np.concatenate([[True], pe[1:] != pe[:-1]]) if len(pe) else np.zeros(0, bool)
    ev_ok = np.ones(len(pts), bool)
    ev_ok[order[first]] = False
    ev_sel = np.nonzero(ev_ok)[0]
    sp_rows, sp_cols = np.nonzero(members == -1)
    # Spares first in pool order so eviction is the last resort per cluster.
    pool_rows = np.concatenate([sp_rows, rows_idx[ev_sel]])
    pool_cols = np.concatenate([sp_cols, cols_idx[ev_sel]])
    porder = np.argsort(pool_rows, kind="stable")
    pr = pool_rows[porder]
    k = members.shape[0]
    ends = np.searchsorted(pr, np.arange(k) + 1)
    cursor = np.searchsorted(pr, np.arange(k))
    used = np.zeros(len(pool_rows), bool)
    spill = []
    for p in np.flatnonzero(~covered):
        for c in assign[p]:
            c = int(c)
            if c < k and cursor[c] < ends[c]:
                i = porder[cursor[c]]
                cursor[c] += 1
                members[pool_rows[i], pool_cols[i]] = p
                used[i] = True
                break
        else:
            spill.append(p)
    if spill:
        free = np.nonzero(~used)[0]
        take = min(len(spill), len(free))
        members[pool_rows[free[:take]], pool_cols[free[:take]]] = np.asarray(
            spill[:take], members.dtype)
        if take < len(spill):
            logging.getLogger("vecgo_tpu_torch").warning(
                "ivf table: %d rows uncovered", len(spill) - take)


def slot_mask_from_rows(table: IVFCodedTable, row_mask: torch.Tensor) -> torch.Tensor:
    """Lift a [N] row mask into the [K, S] slot space (padding -> False)."""
    rows = table.rows.reshape(-1).long()
    ok = row_mask[rows.clamp_min(0)] & (rows >= 0)
    return ok.reshape(table.rows.shape)


def _invert_probes(probes: torch.Tensor, k_pad: int, qcap: int):
    """probes [B, P] cluster ids, or k_pad for a probe that is dropped (the
    cluster cache's dump id) -> (qtab [k_pad, qcap] int32 query index or B
    as empty, qslot [k_pad, qcap] int32 probe slot). Within a cluster the
    queries keep (probe slot, query) order, so earlier probes survive qcap
    pressure first; the (cluster, column) pairs written are unique."""
    b, p = probes.shape
    dev = probes.device
    cl = probes.reshape(-1).long()
    sl = torch.arange(p, device=dev).repeat(b)
    qid = torch.arange(b, device=dev).repeat_interleave(p)
    order = torch.sort(cl * p + sl, stable=True).indices
    cl_s, sl_s, qid_s = cl[order], sl[order], qid[order]
    pos_all = torch.arange(b * p, device=dev)
    boundary = torch.ones(b * p, dtype=torch.bool, device=dev)
    boundary[1:] = cl_s[1:] != cl_s[:-1]
    run_start = torch.cummax(torch.where(boundary, pos_all, 0), 0).values
    pos = pos_all - run_start
    # Fixed shapes, no host sync: pairs past qcap land in a dump column
    # (qcap) and dropped probes in a dump row (k_pad), both dropped.
    col = pos.clamp_max(qcap)
    qtab = torch.full((k_pad + 1, qcap + 1), b, dtype=torch.int32, device=dev)
    qslot = torch.zeros((k_pad + 1, qcap + 1), dtype=torch.int32, device=dev)
    qtab[cl_s, col] = qid_s.to(torch.int32)
    qslot[cl_s, col] = sl_s.to(torch.int32)
    return qtab[:k_pad, :qcap].contiguous(), qslot[:k_pad, :qcap].contiguous()


def default_qcap(b: int, n_probe: int, k_pad: int) -> int:
    """3x the average probes per cluster, in multiples of 32, at most B."""
    return min(max(32, ((3 * b * n_probe // max(k_pad, 1)) + 31) // 32 * 32), b)


def ivf_scan(q: torch.Tensor, table, *, n_probe: int, kk: int,
             qcap: int = 0, mask_flat: Optional[torch.Tensor] = None):
    """Blocked IVF scan over an IVFCodedTable (kernel B) or an
    IVFDeviceTable (plain torch). q [B, d] f32 (normalized upstream for
    cosine); mask_flat [K, S] bool or None (filters and tombstones in slot
    space). Returns (dists [B, n_probe*kk] f32 vs the decoded (coded) or
    bf16-residual rows, rows [B, n_probe*kk] int64 segment rows, -1
    missing)."""
    b = q.shape[0]
    k_pad = table.bnorm2.shape[0]
    n_probe = min(n_probe, k_pad)
    qcap = min(qcap, b) if qcap else default_qcap(b, n_probe, k_pad)
    qf = q.float().contiguous()
    qn = (qf * qf).sum(-1)
    cd = qn[:, None] + table.cnorm2[None, :] - 2.0 * (
        qf.to(torch.bfloat16).float() @ table.centroids.to(torch.bfloat16).float().T)
    _, probes = T.topk_smallest(cd, n_probe)
    return scan_groups(qf, table, probes, mask_flat, kk=kk, qcap=qcap)


def scan_groups(qf: torch.Tensor, table, probes: torch.Tensor,
                mask_flat: Optional[torch.Tensor], *, kk: int, qcap: int):
    """Steps 2-4 of the coded scan with the caller's probes (the port of
    `_scan_groups`): invert probes [B, P] (cluster ids into the table's
    cluster axis, or K for a dropped probe), run kernel B over every probed
    cluster, and scatter the winners. `table` carries codes [K, S, d] int8,
    scale [K], bnorm2 [K, S] (+inf empty), rows [K, S] and centroids [K, d]
    on qf's device; its cluster axis may be a cache. mask_flat: [K, S] or
    [K * S] bool, or None. Returns (dists [B, P*kk] f32, seg_rows [B, P*kk]
    int64, -1 missing)."""
    b = qf.shape[0]
    k_pad, s = table.bnorm2.shape
    n_probe = probes.shape[1]
    qtab, qslot = _invert_probes(probes, k_pad, qcap)
    bn = table.bnorm2 if mask_flat is None else torch.where(
        mask_flat.reshape(k_pad, s), table.bnorm2, math.inf)
    if isinstance(table, IVFDeviceTable):
        ld, lc = _scan_residual_blocks(qf, qtab, table.blocks, bn, table.centroids, kk)
    else:
        ld, lc = coded_group_scan(qf, qtab, table.codes, bn.contiguous(), table.scale,
                                  table.centroids, kk)
    base = (torch.arange(k_pad, device=qf.device) * s)[:, None, None]
    lrow = torch.where(lc >= 0, base + lc, -1)
    # Scatter every (cluster, slot) pair into [B + 1, n_probe, kk] with no
    # host sync: empty slots all land in the extra row B, which is dropped;
    # live (query, probe slot) pairs are unique.
    qi = torch.where(qtab < b, qtab, b).long()
    out_d = torch.full((b + 1, n_probe, kk), math.inf, dtype=torch.float32, device=qf.device)
    out_r = torch.full((b + 1, n_probe, kk), -1, dtype=torch.int64, device=qf.device)
    out_d[qi, qslot.long()] = ld
    out_r[qi, qslot.long()] = lrow
    out_d = out_d[:b].reshape(b, n_probe * kk)
    out_r = out_r[:b].reshape(b, n_probe * kk)
    seg_rows = torch.where(out_r >= 0, table.rows.reshape(-1)[out_r.clamp_min(0)].long(), -1)
    return torch.where(seg_rows >= 0, out_d, math.inf), seg_rows


def _scan_residual_blocks(qf, qtab, blocks, bn, cent, kk: int):
    """The uncoded table's grouped scan (plain torch, as the JAX package's
    XLA scan): per cluster and query slot, the kk nearest of its S slots by
    |q-c|^2 + |x-c|^2 - 2 bf16(q-c).blocks, summed in f32, ties to the lower
    slot. qtab [K, qcap] (B = empty). Returns (d [K, qcap, kk] f32, +inf
    where nothing scored; slot [K, qcap, kk] int64, -1 there)."""
    b, d = qf.shape
    k_pad, s, _ = blocks.shape
    qcap = qtab.shape[1]
    kk_eff = min(kk, s)
    q_ext = torch.cat([qf, qf.new_zeros((1, d))])
    out_d = torch.full((k_pad, qcap, kk), math.inf, dtype=torch.float32, device=qf.device)
    out_i = torch.full((k_pad, qcap, kk), -1, dtype=torch.int64, device=qf.device)
    g = max(1, _SCAN_ELEMS // max(1, qcap * s))
    for c0 in range(0, k_pad, g):
        c1 = min(k_pad, c0 + g)
        qr = q_ext[qtab[c0:c1].long()] - cent[c0:c1, None, :]  # [g, qcap, d]
        prod = torch.bmm(qr.to(torch.bfloat16).float(), blocks[c0:c1].float().transpose(1, 2))
        dd = (qr * qr).sum(-1)[:, :, None] + bn[c0:c1, None, :] - 2.0 * prod
        ld, lc = T.topk_smallest(dd, kk_eff)
        ok = torch.isfinite(ld)
        out_d[c0:c1, :, :kk_eff] = torch.where(ok, ld, math.inf)
        out_i[c0:c1, :, :kk_eff] = torch.where(ok, lc, -1)
    return out_d, out_i


__all__ = [
    "IVFCodedTable", "IVFDeviceTable", "RSCALE_RATIO", "build_ivf_table",
    "compact_members_primary", "device_table", "device_table_coded", "ivf_scan",
    "scan_groups", "slot_mask_from_rows",
]
