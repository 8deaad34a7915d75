"""The port's clustered Vamana build, held to the JAX build's recall floors
(tests/test_build_fast.py: >= 0.95 single-cluster, >= 0.90 multi-cluster),
and its beam build (index/vamana.build_graph), held to the JAX beam build.

The port draws its random far ids and k-means++ seeds from torch
generators, so its graph is not the JAX-built graph; the floors are what
both are held to. Recall is measured as there: a beam search from
IVF-guided entries (the port's), then an exact rerank of the ef-list.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vecgo_tpu.index import vamana as jvamana
from vecgo_tpu.model import Metric
from vecgo_tpu.ops import beam as jbeam
from vecgo_tpu.ops import ivf as jivf
from vecgo_tpu_torch.model import Metric as PMetric
from vecgo_tpu.utils import testutil as tu
from vecgo_tpu_torch import convert
from vecgo_tpu_torch.entry import entry
from vecgo_tpu_torch.index import build_fast as bf
from vecgo_tpu_torch.index import vamana as tvamana
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
    graph, medoid, ecent, enodes = bf.build_graph_clustered(x, r=24, seed=42, device="cpu")
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
            inp, r=24, cluster_size=512, seed=42, return_membership=True, device="cpu")
        deg = (graph >= 0).sum(1)
        assert deg.mean() > 4 and deg.max() <= 24
        assert not (graph == np.arange(n)[:, None]).any()
        flat = members.reshape(-1)
        assert set(flat[flat >= 0]) == set(range(n))  # every row reachable by the scan
        assert search_recall(x, graph, medoid, ecent, enodes, q, ti) >= 0.90


def test_clustered_build_tiny_and_empty():
    g, _, _, _ = bf.build_graph_clustered(np.zeros((0, 8), np.float32), r=8, device="cpu")
    assert g.shape == (0, 8)
    x = np.random.default_rng(0).standard_normal((5, 8)).astype(np.float32)
    g, _, _, _ = bf.build_graph_clustered(x, r=8, device="cpu")
    assert g.shape == (5, 8)
    assert (np.sort(g[0][g[0] >= 0]) == [1, 2, 3, 4]).all()


def test_build_is_deterministic():
    """Same seed, same graph and membership: every scatter with colliding
    indices resolves by a deterministic reduction."""
    n, d = 5000, 32
    x, _ = tu.clustered_vectors(n, d, n_clusters=16, seed=7)
    a = bf.build_graph_clustered(x, r=16, cluster_size=256, return_membership=True, seed=3,
                                 device="cpu")
    b = bf.build_graph_clustered(x, r=16, cluster_size=256, return_membership=True, seed=3,
                                 device="cpu")
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
    w = VamanaWriter(d, PMetric.L2, r=16, device="cpu")
    w.add_batch(x, np.arange(n))
    seg = VamanaSegment.open(w.finish())
    assert seg.n == n and seg.ivf_members is None  # under ivf_min_n: graph walk
    _, rows = seg.search(torch.from_numpy(x[:16]), 5, ef=64)
    assert (rows[:, 0].numpy() == np.arange(16)).all()


# --- the beam build (build_mode="beam", index/vamana.build_graph) -----------
# The port's k-means++ seeding and coarse assignment run on torch (other
# draws than jax.random), so its graph is not the JAX graph: searches over a
# JAX-built graph carried across are held to the JAX ids, and the port's own
# graph to the JAX graph's recall on the same fixture, less 0.02.

BN, BD = 5000, 32  # tests/test_vamana.py's fixture: Gaussian rows, r 24, l_build 48


@pytest.fixture(scope="module")
def beam_built():
    x = tu.gaussian_vectors(BN, BD, seed=31)
    q = tu.gaussian_vectors(32, BD, seed=32)
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    return x, q, ti, jvamana.build_graph(x, r=24, l_build=48)


def _entries(q, medoid, ecent, enodes):
    near = np.argsort(((q[:, None] - ecent[None]) ** 2).sum(-1), 1, kind="stable")[:, :4]
    return np.concatenate([enodes[near], np.full((len(q), 1), medoid)], 1).astype(np.int32)


def test_beam_search_over_the_jax_beam_graph_returns_the_jax_ids(beam_built):
    """Both packages' beam search over the JAX-built graph from the same
    IVF-guided entries: the same ids (>= 0.99 overlap: bf16 products summed
    in another order move near-ties), distances within 1e-4 relative."""
    x, q, _, (graph, medoid, ecent, enodes) = beam_built
    ent = _entries(q, medoid, ecent, enodes)
    rn = np.einsum("nd,nd->n", x, x).astype(np.float32)
    d_j, i_j = jbeam.beam_search(jnp.asarray(q), jnp.asarray(x, jnp.bfloat16), jnp.asarray(rn),
                                 jnp.asarray(graph), jnp.asarray(ent), ef=64, k=10, beam_width=4)
    d_t, i_t = beam_ops.beam_search(torch.from_numpy(q), torch.from_numpy(x).to(torch.bfloat16),
                                    torch.from_numpy(rn), torch.from_numpy(graph),
                                    torch.from_numpy(ent), ef=64, k=10, beam_width=4)
    i_j, i_t = np.asarray(i_j), i_t.numpy()
    hits = sum(len(set(a) & set(b)) for a, b in zip(i_t, i_j))
    assert hits >= 0.99 * i_j.size
    np.testing.assert_allclose(np.sort(d_t.numpy(), 1), np.sort(np.asarray(d_j), 1),
                               rtol=1e-4, atol=1e-4)


def test_beam_build_recall_within_the_jax_build(beam_built):
    """The port's beam build (two passes of search + RobustPrune, then the
    reverse-edge re-prune) on tests/test_vamana.py's fixture: the graph's
    shape, degree and no self loops, and recall@10 no lower than the JAX
    graph's less 0.02 under the same search."""
    x, q, ti, (g_j, m_j, c_j, e_j) = beam_built
    g_t, m_t, c_t, e_t = tvamana.build_graph(x, r=24, l_build=48, device="cpu")
    assert g_t.shape == (BN, 24) and g_t.dtype == np.int32
    assert not (g_t == np.arange(BN)[:, None]).any() and (g_t < BN).all()
    assert (g_t >= 0).sum(1).mean() > 4
    assert m_t == m_j  # the medoid is host numpy in both
    rec_t = search_recall(x, g_t, m_t, c_t, e_t, q, ti)
    rec_j = search_recall(x, g_j, m_j, c_j, e_j, q, ti)
    assert rec_t >= rec_j - 0.02 and rec_t >= 0.9, (rec_t, rec_j)


def test_reverse_candidates_and_init_are_the_jax_draws():
    """The host steps are copies: the same numpy draws give the same
    cluster-aware init and the same sampled in-edges."""
    r = np.random.default_rng(3)
    assign = r.integers(0, 7, 500)
    a = jvamana._cluster_aware_init(500, 12, assign, np.random.default_rng(4))
    b = tvamana._cluster_aware_init(500, 12, assign, np.random.default_rng(4))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jvamana._reverse_candidates(a, 12, np.random.default_rng(5)),
                                  tvamana._reverse_candidates(b, 12, np.random.default_rng(5)))


def test_beam_writer_segment_serves_from_its_ivf_table(beam_built):
    """VamanaWriter(build_mode="beam") at >= ivf_min_n rows: its membership
    comes from build_ivf_table (K x ivf_capacity, every row covered), and
    the segment's two-stage search reads recall@10 no lower than the JAX
    beam writer's segment (opened in the port) less 0.02; a port segment
    over the JAX build's graph and membership (convert) serves the same."""
    x, q, ti, (g_j, m_j, c_j, e_j) = beam_built
    w = VamanaWriter(BD, PMetric.L2, r=24, l_build=48, build_mode="beam", ivf_capacity=256,
                     device="cpu")
    w.add_batch(x, np.arange(BN))
    seg = VamanaSegment.open(w.finish())
    assert seg.meta["alpha"] == 1.2 and seg.ivf_members.shape == (-(-BN * 3 // 512), 256)
    assert set(seg.ivf_members[seg.ivf_members >= 0].tolist()) == set(range(BN))
    jw = jvamana.VamanaWriter(BD, Metric.L2, r=24, l_build=48, build_mode="beam",
                              ivf_capacity=256)
    jw.add_batch(x, np.arange(BN))
    jseg = VamanaSegment.open(jw.finish())
    _, members = jivf.build_ivf_table(x, capacity=256, seed=42)
    cseg = convert.vamana_segment_from_arrays(x, g_j, m_j, c_j, e_j, members, r=24)
    qt = torch.from_numpy(q)
    rec = [tu.recall_at_k(s.search(qt, 10, ef=96)[1].numpy(), ti) for s in (seg, jseg, cseg)]
    assert rec[0] >= rec[1] - 0.02 and rec[2] >= rec[1] - 0.02 and rec[0] >= 0.9, rec


def test_entry_runs_on_the_cpu_and_matches_the_jax_entry_graph():
    """vecgo_tpu_torch.entry: the step returns [64, 10] finite results; over
    the JAX entry's arrays (__graft_entry__.entry(): build_graph at 2,048 x
    128, r 16, l_build 32) the port's step returns the JAX step's ids
    (>= 0.99 overlap, as above)."""
    fn, args = entry(device="cpu")
    d, i = fn(*args)
    assert d.shape == i.shape == (64, 10) and torch.isfinite(d).all() and (i >= 0).all()
    x = tu.gaussian_vectors(2048, 128, seed=42)
    q = tu.gaussian_vectors(64, 128, seed=43)
    graph, medoid, _, _ = jvamana.build_graph(x, r=16, l_build=32, block=1024)
    rn = np.einsum("nd,nd->n", x, x, dtype=np.float64).astype(np.float32)
    _, i_j = jbeam.beam_search(jnp.asarray(q), jnp.asarray(x, jnp.bfloat16), jnp.asarray(rn),
                               jnp.asarray(graph), jnp.asarray([medoid], jnp.int32), ef=32, k=10,
                               beam_width=4)
    _, i_t = fn(torch.from_numpy(q), torch.from_numpy(x).to(torch.bfloat16),
                torch.from_numpy(rn), torch.from_numpy(graph), torch.tensor([medoid]))
    i_j, i_t = np.asarray(i_j), i_t.numpy()
    assert sum(len(set(a) & set(b)) for a, b in zip(i_t, i_j)) >= 0.99 * i_j.size
