"""The port's FreshVamana (index/fresh.py) on tests/test_fresh_vamana.py's
three fixtures, at the JAX tests' floors, and against the JAX FreshVamana.

The port's consolidate() rebuilds with the port's beam build, whose k-means
draws differ from jax.random's, so its graph is not the JAX graph; state
carried across from the JAX index (`convert.fresh_from_jax`) searches to the
JAX ids (>= 0.99 overlap: bf16 products summed in f32 in another order move
near-ties), and the port's own index meets the JAX tests' floors and the
JAX index's recall on the same fixture less 0.05.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vecgo_tpu.index.fresh import FreshVamana as JaxFreshVamana
from vecgo_tpu.utils import testutil as tu
from vecgo_tpu_torch import convert
from vecgo_tpu_torch.index.fresh import FreshVamana

torch.set_num_threads(1)

D = 24


def _overlap(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return sum(len(set(x[x >= 0]) & set(y[y >= 0])) for x, y in zip(a, b)) / max(
        1, sum(len(set(y[y >= 0])) for y in b))


def test_streaming_insert_recall():
    fv = FreshVamana(D, r=16, l_build=32, device="cpu")
    x = tu.gaussian_vectors(3000, D, seed=81)
    for s in range(0, 3000, 500):
        rows = fv.insert_batch(x[s : s + 500])
        np.testing.assert_array_equal(rows, np.arange(s, s + 500))
    q = tu.gaussian_vectors(16, D, seed=82)
    _, true_ids = tu.brute_force_knn(q, x, 10, "l2")
    _, rows = fv.search(q, 10, ef=64)
    rec = tu.recall_at_k(rows.numpy(), true_ids)
    jv = JaxFreshVamana(D, r=16, l_build=32)
    for s in range(0, 3000, 500):
        jv.insert_batch(x[s : s + 500])
    jrec = tu.recall_at_k(np.asarray(jv.search(jnp.asarray(q), 10, ef=64)[1]), true_ids)
    assert rec >= 0.85 and rec >= jrec - 0.05, (rec, jrec)
    # The JAX index's state carried across searches to the JAX ids.
    cv = convert.fresh_from_jax(jv, "cpu")
    assert cv.n == jv.n and cv.capacity == jv.capacity and cv.medoid == jv.medoid
    assert _overlap(cv.search(q, 10, ef=64)[1], jv.search(jnp.asarray(q), 10, ef=64)[1]) >= 0.99


def test_soft_delete_and_consolidate():
    fv = FreshVamana(D, r=16, l_build=32, consolidate_threshold=0.3, device="cpu")
    x = tu.gaussian_vectors(1000, D, seed=83)
    fv.insert_batch(x)
    for row in range(0, 1000, 5):
        fv.delete(row)
    for row in range(1, 1000, 5):
        fv.delete(row)
    assert fv.deleted_ratio == pytest.approx(0.4)
    q = tu.gaussian_vectors(8, D, seed=84)
    _, rows = fv.search(q, 10, ef=64)
    assert (rows.numpy() % 5 >= 2).all()  # deleted rows never returned
    assert fv.maybe_consolidate()
    assert fv.n == 600 and fv.deleted_ratio == 0.0
    _, rows2 = fv.search(q, 5, ef=64)
    live_set = x[sorted(set(range(1000)) - set(range(0, 1000, 5)) - set(range(1, 1000, 5)))]
    _, ti = tu.brute_force_knn(q, live_set, 5, "l2")
    assert tu.recall_at_k(rows2.numpy(), ti) >= 0.8


def test_capacity_growth():
    fv = FreshVamana(D, r=8, l_build=16, device="cpu")
    x = tu.gaussian_vectors(5000, D, seed=85)
    fv.insert_batch(x[:100])
    cap0 = fv.capacity
    fv.insert_batch(x[100:3000])
    assert fv.capacity > cap0 and fv.n == 3000
    _, rows = fv.search(x[:100], 1, ef=32)
    assert (rows.numpy()[:, 0] == np.arange(100)).mean() >= 0.9


def test_deletes_carried_across_stay_masked():
    """A JAX index with soft deletes, carried across: the port masks the
    same rows and returns the JAX ids."""
    jv = JaxFreshVamana(D, r=16, l_build=32)
    x = tu.gaussian_vectors(1200, D, seed=86)
    jv.insert_batch(x[:600])
    jv.insert_batch(x[600:])
    for row in range(0, 1200, 3):
        jv.delete(row)
    q = tu.gaussian_vectors(12, D, seed=87)
    cv = convert.fresh_from_jax(jv, "cpu")
    _, rows = cv.search(q, 10, ef=64)
    assert (rows.numpy() % 3 != 0).all()
    assert _overlap(rows, jv.search(jnp.asarray(q), 10, ef=64)[1]) >= 0.99
