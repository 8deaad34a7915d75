"""The port's clustered Vamana build, held to the JAX build's recall floors
(tests/test_build_fast.py: >= 0.95 single-cluster, >= 0.90 multi-cluster).

The port draws its random far ids and k-means++ seeds from torch
generators, so its graph is not the JAX-built graph; the floors are what
both are held to. Recall is measured as there: a beam search from
IVF-guided entries (the port's), then an exact rerank of the ef-list.
"""

import numpy as np
import torch

from vecgo_tpu.model import Metric
from vecgo_tpu_torch.model import Metric as PMetric
from vecgo_tpu.utils import testutil as tu
from vecgo_tpu_torch.index import build_fast as bf
from vecgo_tpu_torch.index.vamana import VamanaSegment, VamanaWriter
from vecgo_tpu_torch.ops import beam as beam_ops

torch.set_num_threads(1)


def search_recall(x, graph, medoid, ecent, enodes, q, true_ids, k=10, ef=96):
    xt = torch.from_numpy(x)
    rn = torch.from_numpy(np.einsum("nd,nd->n", x, x, dtype=np.float64).astype(np.float32))
    cd = ((q[:, None, :] - ecent[None]) ** 2).sum(-1)
    probes = np.argsort(cd, 1, kind="stable")[:, : min(4, len(ecent))]
    entry = np.concatenate([enodes[probes], np.full((len(q), 1), medoid)], 1)
    _, _, _, ci = beam_ops.beam_search(
        torch.from_numpy(q), xt.to(torch.bfloat16), rn, torch.from_numpy(graph).long(),
        torch.from_numpy(entry), ef=ef, k=k, beam_width=4, with_visited=True)
    ci = ci.numpy()
    dx = ((x[np.maximum(ci, 0)] - q[:, None, :]) ** 2).sum(-1)
    dx[ci < 0] = np.inf
    top = np.take_along_axis(ci, np.argsort(dx, 1)[:, :k], 1)
    return tu.recall_at_k(top, true_ids)


def test_clustered_build_recall_small():
    """Single-cluster exact path (n <= 2 * cluster_size)."""
    n, d = 1500, 32
    x, _ = tu.clustered_vectors(n, d, n_clusters=16, seed=7)
    graph, medoid, ecent, enodes = bf.build_graph_clustered(x, r=24, seed=42)
    assert graph.shape == (n, 24) and graph.dtype == np.int32
    assert not (graph == np.arange(n)[:, None]).any()
    q = x[:64] + np.random.default_rng(8).standard_normal((64, d)).astype(np.float32) * 0.01
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    assert search_recall(x, graph, medoid, ecent, enodes, q, ti) >= 0.95


def test_clustered_build_recall_multicluster():
    """Multi-cluster path (k-means partition, overlap membership, descent,
    prune), from numpy input and from a tensor (the writer's input)."""
    n, d = 6000, 32
    x, _ = tu.clustered_vectors(n, d, n_clusters=32, seed=9)
    q = x[:64] + np.random.default_rng(10).standard_normal((64, d)).astype(np.float32) * 0.01
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    for inp in (x, torch.from_numpy(x)):
        graph, medoid, ecent, enodes, members = bf.build_graph_clustered(
            inp, r=24, cluster_size=512, seed=42, return_membership=True)
        deg = (graph >= 0).sum(1)
        assert deg.mean() > 4 and deg.max() <= 24
        assert not (graph == np.arange(n)[:, None]).any()
        flat = members.reshape(-1)
        assert set(flat[flat >= 0]) == set(range(n))  # every row reachable by the scan
        assert search_recall(x, graph, medoid, ecent, enodes, q, ti) >= 0.90


def test_clustered_build_tiny_and_empty():
    g, _, _, _ = bf.build_graph_clustered(np.zeros((0, 8), np.float32), r=8)
    assert g.shape == (0, 8)
    x = np.random.default_rng(0).standard_normal((5, 8)).astype(np.float32)
    g, _, _, _ = bf.build_graph_clustered(x, r=8)
    assert g.shape == (5, 8)
    assert (np.sort(g[0][g[0] >= 0]) == [1, 2, 3, 4]).all()


def test_build_is_deterministic():
    """Same seed, same graph and membership: every scatter with colliding
    indices resolves by a deterministic reduction."""
    n, d = 5000, 32
    x, _ = tu.clustered_vectors(n, d, n_clusters=16, seed=7)
    a = bf.build_graph_clustered(x, r=16, cluster_size=256, return_membership=True, seed=3)
    b = bf.build_graph_clustered(x, r=16, cluster_size=256, return_membership=True, seed=3)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[4], b[4])
    assert a[1] == b[1]


def test_reverse_edges_are_in_edges():
    r = np.random.default_rng(2)
    edges = torch.from_numpy(r.integers(-1, 300, (300, 12)))
    rev = bf._reverse_dev(edges, 8).numpy()
    e = edges.numpy()
    for v in range(300):
        for u in rev[v][rev[v] >= 0]:
            assert v in e[u]


def test_writer_roundtrip_and_search():
    n, d = 600, 16
    x = tu.gaussian_vectors(n, d, seed=11)
    w = VamanaWriter(d, PMetric.L2, r=16)
    w.add_batch(x, np.arange(n))
    seg = VamanaSegment.open(w.finish())
    assert seg.n == n and seg.ivf_members is None  # under ivf_min_n: graph walk
    _, rows = seg.search(torch.from_numpy(x[:16]), 5, ef=64)
    assert (rows[:, 0].numpy() == np.arange(16)).all()
