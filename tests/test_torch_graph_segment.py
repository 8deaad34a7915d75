"""The same Vamana segment searched by both packages.

A segment written by the JAX package is opened by both and searched at the
serving profiles of bench.py (IVF shortlist through kernel B's plain
version, optional refine round and int16 rescore), with a mask, by the
masked brute force over the codes, and, under serve_ivf_min_n rows, by the
table-less graph walk: at least 0.99 of the ids overlap (both score exact
bf16 products summed in f32 in another order), and the device rerank of
the same rows agrees to 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vecgo_tpu.index.vamana import VamanaSegment as JaxVamanaSegment
from vecgo_tpu.index.vamana import VamanaWriter as JaxVamanaWriter
from vecgo_tpu.model import Metric
from vecgo_tpu_torch.model import Metric as PMetric
from vecgo_tpu.utils import testutil as tu
from vecgo_tpu_torch.index.vamana import VamanaSegment

torch.set_num_threads(1)

N, D = 6000, 16
# bench.py's graph serving profiles, as VamanaSegment.search arguments.
PROFILES = {
    "serving": dict(ef=48, n_probe=4, refine_steps=0, rescore=False),
    "qcap": dict(ef=48, n_probe=4, refine_steps=0, rescore=False, qcap_factor=1.25),
    "rescore": dict(ef=48, n_probe=8, refine_steps=0, rescore=True),
    "refine": dict(ef=48, n_probe=4),
}


def overlap(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    hits = sum(len(set(x[x >= 0]) & set(y[y >= 0])) for x, y in zip(a, b))
    return hits / max(1, sum(len(set(y[y >= 0])) for y in b))


def corpus(n=N, seed=41):
    x, _ = tu.clustered_vectors(n, D, n_clusters=24, seed=seed)
    rng = np.random.default_rng(seed + 1)
    q = (x[rng.choice(n, 32, replace=False)] + 0.02 * rng.standard_normal((32, D))).astype(np.float32)
    return x, q, rng.integers(0, 100, n)


@pytest.fixture(scope="module")
def jax_blob():
    x, q, u = corpus()
    w = JaxVamanaWriter(D, Metric.L2)
    w.add_batch(x, np.arange(N), [{"u": int(v)} for v in u])
    return w.finish(), x, q, u


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_jax_segment_searched_by_both(jax_blob, profile):
    data, x, q, _ = jax_blob
    js, ts = JaxVamanaSegment.open(data), VamanaSegment.open(data)
    assert ts.ivf_members is not None
    kw = PROFILES[profile]
    _, want = js.search(jnp.asarray(q), 10, **kw)
    d, got = ts.search(torch.from_numpy(q), 10, **kw)
    assert overlap(got.numpy(), want) >= 0.99
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    assert tu.recall_at_k(got.numpy(), ti) >= 0.9
    # The device rerank (int16 plane) of the same rows agrees with JAX's.
    rows = np.asarray(want)
    rd_j = np.asarray(js.rerank(jnp.asarray(q), jnp.asarray(rows)))
    rd_t = ts.rerank(torch.from_numpy(q), torch.from_numpy(rows)).numpy()
    np.testing.assert_allclose(rd_t, rd_j, rtol=1e-4, atol=1e-4)


def test_jax_segment_masked_search_and_scan(jax_blob):
    data, x, q, u = jax_blob
    js, ts = JaxVamanaSegment.open(data), VamanaSegment.open(data)
    mask = u < 50
    _, want = js.search(jnp.asarray(q), 10, mask=mask, ef=64)
    _, got = ts.search(torch.from_numpy(q), 10, mask=mask, ef=64)
    assert overlap(got.numpy(), want) >= 0.99 and mask[got.numpy()[got.numpy() >= 0]].all()
    mask = u < 10
    _, want = js.masked_scan(jnp.asarray(q), 10, mask)
    _, got = ts.masked_scan(torch.from_numpy(q), 10, mask)
    assert overlap(got.numpy(), want) >= 0.99 and mask[got.numpy()[got.numpy() >= 0]].all()


def test_tableless_segment_searched_by_both():
    """Under serve_ivf_min_n rows a segment has no coded table: both walk
    the graph from IVF-guided entries over a bf16 copy."""
    x, q, u = corpus(1500, seed=43)
    w = JaxVamanaWriter(D, Metric.L2, r=16)
    w.add_batch(x, np.arange(len(x)))
    data = w.finish()
    js, ts = JaxVamanaSegment.open(data), VamanaSegment.open(data)
    assert ts.ivf_members is None
    for mask in (None, u < 40):
        _, want = js.search(jnp.asarray(q), 10, mask=mask, ef=48)
        _, got = ts.search(torch.from_numpy(q), 10, mask=mask, ef=48)
        assert overlap(got.numpy(), want) >= 0.99


def test_cosine_segment_searched_by_both():
    """Cosine segments store normalized rows and build on L2 over them; the
    queries arrive normalized and the rerank scores 1 - cos on the decoded
    rows in both packages."""
    from vecgo_tpu_torch.index.vamana import VamanaWriter

    x, q, _ = corpus(seed=47)
    w = VamanaWriter(D, PMetric.COSINE)
    w.add_batch(x, np.arange(N))
    data = w.finish()
    js, ts = JaxVamanaSegment.open(data), VamanaSegment.open(data)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    kw = PROFILES["refine"]
    _, want = js.search(jnp.asarray(qn), 10, **kw)
    _, got = ts.search(torch.from_numpy(qn), 10, **kw)
    assert overlap(got.numpy(), want) >= 0.99
    _, ti = tu.brute_force_knn(q, x, 10, "cosine")
    assert tu.recall_at_k(got.numpy(), ti) >= 0.9
    rows = got.numpy()
    np.testing.assert_allclose(
        ts.rerank(torch.from_numpy(qn), got).numpy(),
        np.asarray(js.rerank(jnp.asarray(qn), jnp.asarray(rows))), rtol=1e-4, atol=1e-4)


def test_int8_table_without_refinement_plane(jax_blob):
    """serve_refine=False: no int16 plane; the rescore and the rerank decode
    the int8 codes in both packages."""
    data, x, q, _ = jax_blob
    js, ts = JaxVamanaSegment.open(data), VamanaSegment.open(data)
    js.serve_refine = ts.serve_refine = False
    kw = PROFILES["refine"]
    _, want = js.search(jnp.asarray(q), 10, **kw)
    _, got = ts.search(torch.from_numpy(q), 10, **kw)
    assert ts.device_state("cpu")["ivfq"].rcodes is None
    assert overlap(got.numpy(), want) >= 0.99
    rows = np.asarray(want)
    np.testing.assert_allclose(
        ts.rerank(torch.from_numpy(q), torch.from_numpy(rows)).numpy(),
        np.asarray(js.rerank(jnp.asarray(q), jnp.asarray(rows))), rtol=1e-4, atol=1e-4)
