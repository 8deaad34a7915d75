"""Sharded search and build over a grid of devices (port of
vecgo_tpu/parallel/mesh.py).

The JAX package shards with `shard_map` over a `jax.sharding.Mesh`: corpus
rows split along a "shard" axis, query batches along a "dp" axis, and the
collectives ride the chips' interconnect. The port keeps the two axes and
the functions' names, but it is single-controller: one process holds a
[dp, shard] grid of torch devices, launches each grid entry's work on that
entry's device (every launch returns at once, so distinct cards overlap),
then moves the small per-entry results to a merge device and reduces them
there. The JAX collectives become plain copies:

- `all_gather` over "shard": each shard's [B, k] result moved to the
  slice's merge device (`.to(..., non_blocking=True)`), then a `cat`;
- `psum`: a sum of the moved partials;
- `pmax`: an elementwise max of the moved partials.

A grid may repeat a device: `["cpu"] * 8` on the CPU, `["cuda:0"] * 4` on
one card. Every shard split, row offset, mask and merge then runs as it
would on distinct devices, and `.to()` of a tensor already on its device
returns it, so entries on one device share storage (no replica per entry).
Each shard's scan is `ops/topk.blockwise_topk_search` (kernel A,
`scan_topk`, on a card) or `ops/ivf.ivf_scan` (kernel B,
`coded_group_scan`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from vecgo_tpu_torch.model import Metric
from vecgo_tpu_torch.ops import ivf as ivf_ops
from vecgo_tpu_torch.ops import topk as T
from vecgo_tpu_torch.ops.beam import _dedup_topk
from vecgo_tpu_torch.utils.tensors import checked_device, host_tensor

# Rows per distance block of the k-means step: the [rows, K] f32 block at
# K = 1,024 centres is 256 MB.
_KMEANS_ROWS = 65536


class Mesh:
    """A [dp, shard] grid of torch devices (the port's jax Mesh): `shape`
    {"dp": dp, "shard": shard}, `axis_names` ("dp", "shard"),
    `devices[i, j]` the device at one grid position."""

    axis_names = ("dp", "shard")

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        dp, shard = self.devices.shape
        return {"dp": dp, "shard": shard}

    @property
    def size(self) -> int:
        return self.devices.size

    def entries(self) -> List[torch.device]:
        """Every grid entry's device, row-major over (dp, shard): the order
        of an axis over ("dp", "shard") in the JAX package."""
        return list(self.devices.reshape(-1))


def _device(d) -> torch.device:
    """A torch.device with its index ("cuda" -> the current card), so that
    it compares equal to a tensor's device."""
    dev = checked_device(d, "make_mesh")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(shard: Optional[int] = None, dp: int = 1, devices=None) -> Mesh:
    """A ("dp", "shard") grid over `devices` (default: every visible CUDA
    device; raises without one). Entries may repeat a device. shard
    defaults to all devices left after dp."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() needs a CUDA device; none is available "
                               "(pass devices=['cpu'] * n for a grid on the CPU)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = len(devices)
    if shard is None:
        shard = n // dp
    assert dp * shard == n, f"dp({dp}) * shard({shard}) != devices({n})"
    grid = np.empty((dp, shard), dtype=object)
    for i, d in enumerate(devices):
        grid[i // shard, i % shard] = d
    return Mesh(grid)


def replicate(t: torch.Tensor, mesh: Mesh) -> Dict[torch.device, torch.Tensor]:
    """`t` on every distinct device of the grid, one copy per device."""
    return {dev: t.to(dev) for dev in dict.fromkeys(mesh.entries())}


def _on(t, dev: torch.device):
    """A host array or a tensor on `dev`; a replica map gives its copy."""
    if isinstance(t, dict):
        return t[dev]
    if isinstance(t, np.ndarray):
        t = host_tensor(t)
    return t.to(dev, non_blocking=True)


def split_rows(x, mesh: Mesh) -> List[torch.Tensor]:
    """Rows of x (numpy or tensor) split in order over every grid entry,
    row-major over (dp, shard), each part on its entry's device: the
    layout of an array sharded over ("dp", "shard")."""
    entries = mesh.entries()
    per = -(-x.shape[0] // len(entries))
    return [_on(x[e * per:(e + 1) * per], dev) for e, dev in enumerate(entries)]


def _dp_slices(q: torch.Tensor, dp: int):
    """q padded with zero rows to a multiple of dp, cut into dp slices."""
    b = q.shape[0]
    pad = (-b) % dp
    if pad:
        q = torch.cat([q, q.new_zeros((pad, q.shape[1]))])
    return q.chunk(dp) if dp > 1 else (q,)


def _query_tensor(q) -> torch.Tensor:
    return q.float() if isinstance(q, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(q, np.float32))


class ShardedFlat:
    """A flat corpus split row-wise over the grid's "shard" axis, each
    shard's rows, norms and mask on the devices of its grid column (shared
    along dp where they repeat a device). Queries split along "dp"; results
    are the exact global top-k.

    x: [N, d] numpy (uploaded shard by shard) or a tensor (sliced; on the
    shard's own device no copy is made). The JAX package pads N to a
    multiple of the shard count with zero rows that a mask drops; here the
    last shard holds the remainder, so no padded row exists to drop.
    block_rows is the JAX signature's: `scan_topk` tiles rows itself.
    """

    def __init__(self, x, mesh: Mesh, metric: Metric = Metric.L2, block_rows: int = 8192,
                 mask=None):
        self.mesh = mesh
        self.metric = metric.compute() if hasattr(metric, "compute") else metric
        self.n, self.dim = x.shape
        self.block_rows = block_rows
        n_shards = mesh.shape["shard"]
        self.shard_rows = max(1, -(-self.n // n_shards))
        host = isinstance(x, np.ndarray)
        if host:
            x = np.asarray(x, np.float32)
        if self.metric == Metric.COSINE:
            if host:
                x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
            else:
                x = x.float() / torch.linalg.vector_norm(x.float(), dim=1,
                                                         keepdim=True).clamp_min(1e-30)
        # shard j -> {device: (rows, norms, mask)}
        self._shards: List[Dict[torch.device, tuple]] = []
        for j in range(n_shards):
            a, b = min(j * self.shard_rows, self.n), min((j + 1) * self.shard_rows, self.n)
            xs = x[a:b]
            rn = _norms_sq(xs)
            ms = None if mask is None else mask[a:b]
            self._shards.append({
                dev: (_on(xs, dev).float().contiguous(), _on(rn, dev),
                      None if ms is None else _on(ms, dev).bool().contiguous())
                for dev in dict.fromkeys(mesh.devices[:, j])
            })

    def search(self, q, k: int):
        """Exact sharded top-k of q [B, d] (numpy or tensor; any B). Returns
        (dists [B, k] f32, rows [B, k] int64, -1 missing) on the grid's
        first device."""
        mesh = self.mesh
        q = _query_tensor(q)
        b = q.shape[0]
        out_d, out_i = [], []
        for i, qs in enumerate(_dp_slices(q, mesh.shape["dp"])):
            merge = mesh.devices[i, 0]
            q_on = {dev: qs.to(dev) for dev in dict.fromkeys(mesh.devices[i])}
            parts_d, parts_i = [], []
            for j, shard in enumerate(self._shards):
                dev = mesh.devices[i, j]
                x, rn, m = shard[dev]
                d, r = T.blockwise_topk_search(q_on[dev], x, k, metric=self.metric,
                                               x_norms_sq=rn, mask=m, x_normalized=True)
                r = torch.where(r >= 0, r + j * self.shard_rows, -1)
                parts_d.append(d.to(merge, non_blocking=True))
                parts_i.append(r.to(merge, non_blocking=True))
            d, r = T.topk_smallest_with_ids(torch.cat(parts_d, 1), torch.cat(parts_i, 1), k)
            out_d.append(d.to(mesh.devices[0, 0], non_blocking=True))
            out_i.append(r.to(mesh.devices[0, 0], non_blocking=True))
        return torch.cat(out_d)[:b], torch.cat(out_i)[:b]


def _norms_sq(x):
    """Row norms |x|^2 as f32, summed in f64 (the JAX package's host sum)."""
    if isinstance(x, np.ndarray):
        return np.einsum("nd,nd->n", x, x, dtype=np.float64).astype(np.float32)
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], _KMEANS_ROWS):
        xd = x[s:s + _KMEANS_ROWS].double()
        out[s:s + _KMEANS_ROWS] = (xd * xd).sum(1).float()
    return out


class ShardedIVF:
    """The SQ8-residual coded table (`ops/ivf.IVFCodedTable`) split on its
    cluster axis over "shard"; queries split over "dp". Each shard probes
    its own top `n_probe_local` clusters and scans them with kernel B
    (`ivf_scan`); the shards' winners gather to the slice's merge device,
    which keeps the pool's best by coded distance, one entry per row.

    Every shard's probe ranking is the global one restricted to its
    clusters, so with n_probe_local >= ceil(n_probe / shards) the probed
    set covers the single-device one. The JAX package pads the cluster
    axis to a multiple of shard * group with empty clusters; here each
    shard holds whole slices of `kps` clusters and the last the remainder
    (empty clusters have +inf norms and are never scanned), and the
    per-shard qcap rule reads `kps` as the JAX rule does. Graph refinement
    is not part of this scan (`engine_shard.ShardedEngineSearcher` adds it).
    """

    def __init__(self, table, mesh: Mesh, group: int = 8):
        self.mesh = mesh
        self.group = group
        n_sh = mesh.shape["shard"]
        k_pad, s, d = table.codes.shape
        step = n_sh * group
        self.k_full = -(-k_pad // step) * step
        self.kps = self.k_full // n_sh
        self.s, self.d = s, d
        # shard j -> {device: IVFCodedTable slice}, None where j holds no cluster
        self._shards: List[Optional[Dict[torch.device, ivf_ops.IVFCodedTable]]] = []
        for j in range(n_sh):
            a, b = min(j * self.kps, k_pad), min((j + 1) * self.kps, k_pad)
            if a == b:
                self._shards.append(None)
                continue
            self._shards.append({dev: ivf_ops.IVFCodedTable(
                codes=table.codes[a:b].to(dev), scale=table.scale[a:b].to(dev),
                bnorm2=table.bnorm2[a:b].to(dev), xnorm2=table.xnorm2[a:b].to(dev),
                rows=table.rows[a:b].to(dev), slot_of_row=table.slot_of_row[:0].to(dev),
                centroids=table.centroids[a:b].to(dev), cnorm2=table.cnorm2[a:b].to(dev),
            ) for dev in dict.fromkeys(mesh.devices[:, j])})

    def search(self, q, n_probe_local: int = 8, kk: int = 16):
        """Sharded shortlist scan of q [B, d] (numpy or tensor; any B).
        Returns (dists, rows) [B, W] on the grid's first device: the global
        candidate pool sorted by coded distance, rows the table's segment
        rows (-1 missing), W = min(n_probe_local * kk * shards,
        max(64, 2 * n_probe_local * kk))."""
        mesh = self.mesh
        n_sh = mesh.shape["shard"]
        q = _query_tensor(q)
        b = q.shape[0]
        width = n_probe_local * kk
        w = min(width * n_sh, max(64, 2 * width))
        out_d, out_r = [], []
        for i, qs in enumerate(_dp_slices(q, mesh.shape["dp"])):
            b_local = qs.shape[0]
            qcap = min(max(32, ((3 * b_local * n_probe_local // max(self.kps, 1)) + 31)
                           // 32 * 32), b_local)
            merge = mesh.devices[i, 0]
            q_on = {dev: qs.to(dev) for dev in dict.fromkeys(mesh.devices[i])}
            parts_d, parts_r = [], []
            for j, shard in enumerate(self._shards):
                if shard is None:
                    parts_d.append(torch.full((b_local, width), math.inf, device=merge))
                    parts_r.append(torch.full((b_local, width), -1, dtype=torch.int64,
                                              device=merge))
                    continue
                dev = mesh.devices[i, j]
                sd, sr = ivf_ops.ivf_scan(q_on[dev], shard[dev], n_probe=n_probe_local, kk=kk,
                                          qcap=qcap)
                if sd.shape[1] < width:  # a shard with fewer clusters than probes
                    sd = torch.cat([sd, sd.new_full((b_local, width - sd.shape[1]), math.inf)], 1)
                    sr = torch.cat([sr, sr.new_full((b_local, width - sr.shape[1]), -1)], 1)
                parts_d.append(sd.to(merge, non_blocking=True))
                parts_r.append(sr.to(merge, non_blocking=True))
            d, r = _dedup_topk(torch.cat(parts_d, 1), torch.cat(parts_r, 1), w)
            out_d.append(d.to(mesh.devices[0, 0], non_blocking=True))
            out_r.append(r.to(mesh.devices[0, 0], non_blocking=True))
        return torch.cat(out_d)[:b], torch.cat(out_r)[:b]


def _kmeans_partial(x: torch.Tensor, centers: torch.Tensor):
    """One shard's Lloyd statistics: per-centre sums [K, d] and counts [K]
    of the rows nearest to each centre (ties to the lower centre), and the
    sum of those nearest squared distances (clamped at 0)."""
    k = centers.shape[0]
    cn = (centers * centers).sum(1)
    sums = torch.zeros_like(centers)
    counts = torch.zeros(k, dtype=torch.float32, device=x.device)
    inertia = torch.zeros((), dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], _KMEANS_ROWS):
        xb = x[s:s + _KMEANS_ROWS].float()
        dmat = (xb * xb).sum(1)[:, None] + cn[None, :] - 2.0 * (xb @ centers.T)
        assign = torch.argmin(dmat, dim=1)
        inertia += dmat.gather(1, assign[:, None]).clamp_min(0.0).sum()
        sums.index_add_(0, assign, xb)
        counts += torch.bincount(assign, minlength=k).float()
    return sums, counts, inertia


def sharded_kmeans_step(mesh: Mesh):
    """One Lloyd iteration over rows split across every grid entry. Returns
    step(x_shards, centers) -> (centers', inertia): x_shards one tensor per
    entry, on its device, row-major over (dp, shard) (`split_rows`);
    centers [K, d] on any device. Each entry computes its cluster sums,
    counts and inertia (an `index_add_` and a `bincount` where the JAX
    package takes a one-hot product); the partials are summed on the
    first entry's device, where the result lands. Empty clusters keep
    their centre."""
    entries = mesh.entries()

    def step(x_shards, centers):
        assert len(x_shards) == len(entries), (len(x_shards), len(entries))
        home = entries[0]
        c = {dev: centers.float().to(dev) for dev in dict.fromkeys(entries)}
        parts = [_kmeans_partial(xs, c[dev]) for xs, dev in zip(x_shards, entries)]
        sums, counts, inertia = (sum(p[t].to(home, non_blocking=True) for p in parts)
                                 for t in range(3))
        new = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None], c[home])
        return new, inertia

    return step


__all__ = ["Mesh", "ShardedFlat", "ShardedIVF", "make_mesh", "replicate", "sharded_kmeans_step",
           "split_rows"]
