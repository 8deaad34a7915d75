"""Lloyd's k-means on the device (port of vecgo_tpu/quantization/kmeans.py:
`_lloyd`, the k-means++ seeding and `train_kmeans_dev`).

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
