"""The port's counterpart of `__graft_entry__.entry()`: the flagship query
step, batched lockstep beam search over a Vamana graph.

    fn, args = entry()        # on the card; entry(device="cpu") on the CPU
    res_d, res_i = fn(*args)  # [64, 10] distances and row ids

`entry` builds a beam-mode graph over 2,048 Gaussian 128-d rows (r 16,
l_build 32, blocks of 1,024) and returns the search (ef 32, k 10, beam
width 4) with its example arguments: 64 queries, the bf16 traversal copy,
the row norms, the graph and the medoid as the entry.
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
