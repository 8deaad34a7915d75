"""The port's counterparts of `__graft_entry__.py`: the flagship query step
and the multi-device dry run.

    fn, args = entry()        # on the card; entry(device="cpu") on the CPU
    res_d, res_i = fn(*args)  # [64, 10] distances and row ids
    dryrun_multichip(8)       # the cards present, round-robin; or device="cpu"

`entry` builds a beam-mode graph over 2,048 Gaussian 128-d rows (r 16,
l_build 32, blocks of 1,024) and returns the search (ef 32, k 10, beam
width 4) with its example arguments: 64 queries, the bf16 traversal copy,
the row norms, the graph and the medoid as the entry.

`dryrun_multichip(n)` builds a (dp, shard) grid of n entries (dp 2 where n
is even and at least 4) and runs one sharded exact search, one sharded
k-means step and `parallel.engine_shard.dryrun_engine_sharded` on it.
"""

from __future__ import annotations

import numpy as np
import torch

from vecgo_tpu_torch.index.vamana import build_graph
from vecgo_tpu_torch.ops import beam as beam_ops


def _gaussian(n: int, d: int, seed: int) -> np.ndarray:
    """Rows as the JAX package's test utilities draw them (standard normal)."""
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def entry(device="cuda"):
    n, d, b, r = 2048, 128, 64, 16
    x = _gaussian(n, d, 42)
    graph, medoid, _, _ = build_graph(x, r=r, l_build=32, block=1024, device=device)
    q = _gaussian(b, d, 43)
    dev = torch.device(device)
    vectors = torch.from_numpy(x).to(dev, torch.bfloat16)
    rnorm2 = torch.from_numpy(np.einsum("nd,nd->n", x, x, dtype=np.float64)
                              .astype(np.float32)).to(dev)
    graph_dev = torch.from_numpy(graph).to(dev)
    entries = torch.tensor([medoid], dtype=torch.int64, device=dev)

    def fn(q, vectors, rnorm2, graph, entries):
        return beam_ops.beam_search(q, vectors, rnorm2, graph, entries, ef=32, k=10,
                                    beam_width=4)

    return fn, (torch.from_numpy(q).to(dev), vectors, rnorm2, graph_dev, entries)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One sharded search, one k-means step and the sharded engine plane on
    a grid of n_devices entries: the visible cards, repeated round-robin
    where there are fewer cards than entries, or n CPU entries with
    device="cpu"."""
    from vecgo_tpu_torch.model import Metric
    from vecgo_tpu_torch.parallel import mesh as pm
    from vecgo_tpu_torch.parallel.engine_shard import dryrun_engine_sharded
    from vecgo_tpu_torch.utils.tensors import checked_device

    if checked_device(device, "dryrun_multichip").type == "cpu":
        devices = ["cpu"] * n_devices
    else:
        cards = torch.cuda.device_count()
        devices = [torch.device("cuda", i % cards) for i in range(n_devices)]
    dp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = pm.make_mesh(shard=n_devices // dp, dp=dp, devices=devices)

    n, d, k = 64 * n_devices, 32, 5
    x = _gaussian(n, d, 44)
    q = _gaussian(4 * dp, d, 45)

    # The query plane: dp x shard, merged on each slice's first device.
    _, ids = pm.ShardedFlat(x, mesh, metric=Metric.L2, block_rows=64).search(q, k)
    ids = ids.cpu().numpy()
    assert ids.shape == (4 * dp, k) and (ids >= 0).all() and (ids < n).all()

    # The build plane: one Lloyd iteration with its statistics summed over
    # every grid entry.
    step = pm.sharded_kmeans_step(mesh)
    centers, inertia = step(pm.split_rows(x, mesh), torch.from_numpy(x[:8]))
    assert np.isfinite(float(inertia)) and bool(torch.isfinite(centers).all())

    dryrun_engine_sharded(mesh)
    print(f"dryrun_multichip OK: mesh={dict(mesh.shape)} search ids ok, "
          f"kmeans inertia={float(inertia):.3f}")
