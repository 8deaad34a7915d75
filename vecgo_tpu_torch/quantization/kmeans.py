"""Lloyd's k-means on the device (port of vecgo_tpu/quantization/kmeans.py).

`train_kmeans_dev` works on a device tensor; `train_kmeans`,
`train_kmeans_grouped`, `assign_partitions` and `closest_centroids` are the
host entry points (numpy in, numpy out) and take the device to compute on.

Assignment is a blockwise [block, K] distance product, and the cluster sums
are a one-hot product (deterministic, unlike atomic scatter-adds), so memory
stays O(block * K). The k-means++ draws come from a seeded `torch.Generator`
on the data's device in place of `jax.random`: the same seed gives other
draws than the JAX package, so a test that needs equal centres feeds both
packages the same initial centres.
"""

from __future__ import annotations

import numpy as np
import torch

from vecgo_tpu_torch.ops import distance as D


def _lloyd(x: torch.Tensor, centers: torch.Tensor, iters: int, block_rows: int):
    """x [N, d] f32 (N % block_rows == 0), centers [K, d] -> (centers,
    inertia of the last iteration)."""
    n, d = x.shape
    k = centers.shape[0]
    xn = D.row_norms_sq(x)
    ks = torch.arange(k, device=x.device)
    inertia = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(iters):
        cn = D.row_norms_sq(centers)
        sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
        counts = torch.zeros(k, dtype=torch.float32, device=x.device)
        inertia = torch.zeros((), dtype=torch.float32, device=x.device)
        for b0 in range(0, n, block_rows):
            blk = x[b0 : b0 + block_rows]
            dmat = xn[b0 : b0 + block_rows, None] + cn[None, :] - 2.0 * (blk @ centers.T)
            assign = dmat.argmin(dim=1)  # ties: the first centre, as jnp.argmin
            best = dmat.gather(1, assign[:, None])[:, 0]
            onehot = (assign[:, None] == ks[None, :]).float()
            sums += onehot.T @ blk
            counts += onehot.sum(0)
            inertia = inertia + best.clamp_min(0.0).sum()
        centers = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None], centers)
    return centers, inertia


def _kmeanspp_init(x: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """k-means++ D^2 seeding on the device; uniform draws where every
    distance is zero (duplicate-heavy samples)."""
    n, d = x.shape
    xn = D.row_norms_sq(x)

    def dist_to(c):
        return (xn + (c * c).sum() - 2.0 * (x @ c)).clamp_min(0.0)

    i0 = torch.randint(0, n, (1,), generator=generator, device=x.device)
    centers = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    centers[0] = x[i0[0]]
    d2 = dist_to(centers[0])
    for i in range(1, k):
        weights = torch.where((d2 > 0).any(), d2, torch.ones_like(d2))
        idx = torch.multinomial(weights, 1, generator=generator)
        centers[i] = x[idx[0]]
        d2 = torch.minimum(d2, dist_to(centers[i]))
    return centers


def train_kmeans_dev(x: torch.Tensor, k: int, iters: int = 15, seed: int = 42,
                     block_rows: int = 4096, sample: int = 65536):
    """k-means over a device tensor x [N, d] (N >= k); returns (centers
    [k, d] f32, inertia) on the same device. The sample and the random init
    of large k come from numpy's generator exactly as in the JAX package;
    k <= 256 seeds with k-means++ from a torch.Generator(seed)."""
    r = np.random.default_rng(seed)
    n = int(x.shape[0])
    if n > sample:
        idx = r.choice(n, sample, replace=False)
        x = x[torch.from_numpy(idx).to(x.device)]
        n = sample
    x = x.float()
    block_rows = min(block_rows, n)
    pad = (-n) % block_rows
    if pad:
        x = torch.cat([x, x[:pad]])
    if k <= 256:
        gen = torch.Generator(device=x.device).manual_seed(seed)
        init = _kmeanspp_init(x[:n], k, gen)
    else:
        init = x[torch.from_numpy(r.choice(n, k, replace=False)).to(x.device)]
    return _lloyd(x, init, iters, block_rows)


def _padded(x: np.ndarray, block_rows: int) -> np.ndarray:
    """Rows padded to a multiple of block_rows with repeats of the first rows
    (they only weight the means slightly)."""
    pad = (-x.shape[0]) % block_rows
    return np.concatenate([x, x[:pad]], 0) if pad else x


def train_kmeans(x: np.ndarray, k: int, iters: int = 15, seed: int = 42,
                 block_rows: int = 4096, sample: int = 65536, device="cuda"):
    """Train k centroids on host rows x [N, d]; returns (centers [k, d] f32
    numpy, inertia). Subsamples to `sample` rows; fewer rows than clusters
    are padded with jittered repeats, as in the JAX package."""
    r = np.random.default_rng(seed)
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    if n > sample:
        x = x[r.choice(n, sample, replace=False)]
        n = sample
    if n < k:
        reps = (x[r.integers(0, max(n, 1), size=k - n)] if n
                else np.zeros((k, x.shape[1]), np.float32))
        jitter = r.standard_normal(reps.shape).astype(np.float32) * 1e-4
        centers = np.concatenate([x, reps + jitter], 0)
        return centers.astype(np.float32), 0.0
    block_rows = min(block_rows, n)
    xd = torch.from_numpy(_padded(x, block_rows)).to(device)
    if k <= 256:
        gen = torch.Generator(device=xd.device).manual_seed(seed)
        init = _kmeanspp_init(xd[:n], k, gen)
    else:
        init = xd[torch.from_numpy(r.choice(n, k, replace=False)).to(xd.device)]
    centers, inertia = _lloyd(xd, init, iters, block_rows)
    return centers.cpu().numpy(), float(inertia)


def _lloyd_grouped(x: torch.Tensor, centers: torch.Tensor, iters: int, block_rows: int):
    """`_lloyd` over G independent groups at once: x [G, N, d], centers
    [G, K, d] -> centers [G, K, d] (batched products in place of a vmap)."""
    g, n, d = x.shape
    k = centers.shape[1]
    xn = (x * x).sum(-1)
    ks = torch.arange(k, device=x.device)
    for _ in range(iters):
        cn = (centers * centers).sum(-1)
        sums = torch.zeros((g, k, d), dtype=torch.float32, device=x.device)
        counts = torch.zeros((g, k), dtype=torch.float32, device=x.device)
        for b0 in range(0, n, block_rows):
            blk = x[:, b0 : b0 + block_rows]
            dmat = (xn[:, b0 : b0 + block_rows, None] + cn[:, None, :]
                    - 2.0 * torch.bmm(blk, centers.transpose(1, 2)))
            onehot = (dmat.argmin(dim=2)[:, :, None] == ks).float()
            sums += torch.bmm(onehot.transpose(1, 2), blk)
            counts += onehot.sum(1)
        centers = torch.where(counts[:, :, None] > 0,
                              sums / counts.clamp_min(1.0)[:, :, None], centers)
    return centers


def train_kmeans_grouped(x_groups: np.ndarray, k: int, iters: int = 15, seed: int = 42,
                         sample: int = 65536, device="cuda") -> np.ndarray:
    """Train G codebooks at once (PQ subspaces): x_groups [G, N, dsub] ->
    [G, k, dsub] f32 numpy. The sample and the initial rows come from numpy's
    generator exactly as in the JAX package."""
    r = np.random.default_rng(seed)
    g, n, dsub = x_groups.shape
    x_groups = np.asarray(x_groups, np.float32)
    if n > sample:
        x_groups = x_groups[:, r.choice(n, sample, replace=False)]
        n = sample
    if n < k:
        return np.stack([train_kmeans(x_groups[i], k, iters, seed + i, device=device)[0]
                         for i in range(g)])
    init = x_groups[:, r.choice(n, k, replace=False)]  # [G, k, dsub]
    block_rows = min(4096, n)
    pad = (-n) % block_rows
    if pad:
        x_groups = np.concatenate([x_groups, x_groups[:, :pad]], 1)
    centers = _lloyd_grouped(torch.from_numpy(np.ascontiguousarray(x_groups)).to(device),
                             torch.from_numpy(np.ascontiguousarray(init)).to(device),
                             iters, block_rows)
    return centers.cpu().numpy()


def assign_partitions(x: np.ndarray, centers: np.ndarray, block_rows: int = 65536,
                      transfer_dtype=None, device="cuda"):
    """Nearest-centroid assignment of host rows: (assign [N] int32, dist [N]
    f32), numpy. transfer_dtype=torch.bfloat16 halves the uploaded bytes and
    rounds both operands of the product to bf16 (coarse assignment tolerates
    fuzz at the boundaries)."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    c = torch.from_numpy(np.ascontiguousarray(centers, np.float32)).to(device)
    cn = D.row_norms_sq(c)
    assign = np.empty(n, np.int32)
    dist = np.empty(n, np.float32)
    block_rows = min(block_rows, max(n, 1))
    for s in range(0, n, block_rows):
        blk = torch.from_numpy(x[s : s + block_rows])
        if transfer_dtype is not None:
            blk = blk.to(transfer_dtype)
        dmat = D.squared_l2(blk.to(c.device), c, cn, compute_dtype=transfer_dtype)
        best, a = dmat.min(dim=1)
        assign[s : s + block_rows] = a.cpu().numpy()
        dist[s : s + block_rows] = best.cpu().numpy()
    return assign, dist


def closest_centroids(q: np.ndarray, centers: np.ndarray, nprobe: int, device="cuda"):
    """Per-query nprobe nearest centroids: (idx [B, nprobe], dist), numpy."""
    from vecgo_tpu_torch.ops import topk as T

    qd = torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(device)
    cd = torch.from_numpy(np.ascontiguousarray(centers, np.float32)).to(device)
    d, i = T.topk_smallest(D.squared_l2(qd, cd), min(nprobe, centers.shape[0]))
    return i.cpu().numpy(), d.cpu().numpy()
