"""The port's coded table, probe inversion and k-means against the JAX package.

`device_table_coded` encodes the same membership over the same rows in both
packages: rows and `slot_of_row` are equal; scales, norms and centroids
agree to 1e-5 relative (member means are f32 sums taken in another order);
the int8 and int16 codes may differ by 1 where that order moves a residual
across a rounding half. `_invert_probes` and `slot_mask_from_rows` are
equal; `_lloyd` from the same initial centres agrees to 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vecgo_tpu.index import build_fast as jbf
from vecgo_tpu.ops import ivf as jivf
from vecgo_tpu.quantization import kmeans as jkm
from vecgo_tpu.utils import testutil as tu
from vecgo_tpu_torch.ops import ivf as tivf
from vecgo_tpu_torch.quantization import kmeans as tkm

torch.set_num_threads(1)


def membership(x, n_clusters, cap, overlap=2, seed=0):
    r = np.random.default_rng(seed)
    cent = x[r.choice(len(x), n_clusters, replace=False)]
    near = np.argsort(((x[:, None, :] - cent[None]) ** 2).sum(-1), 1)[:, :overlap]
    members = np.full((n_clusters, cap), -1, np.int32)
    fill = np.zeros(n_clusters, np.int64)
    for s in range(overlap):
        for i, c in enumerate(near[:, s]):
            if fill[c] < cap:
                members[c, fill[c]] = i
                fill[c] += 1
    return members


@pytest.fixture(scope="module")
def data():
    x, _ = tu.clustered_vectors(3000, 24, n_clusters=12, seed=11)
    return x, membership(x, 21, 384)  # 21 clusters: the table pads to 24


def _close(a, b, rtol=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    fin = np.isfinite(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=rtol, atol=rtol)


@pytest.mark.parametrize("refine", [True, False])
def test_device_table_coded_matches_jax(data, refine):
    x, members = data
    if refine:
        jt = jivf.device_table_coded(members, jnp.asarray(x), refine=x)
        tt = tivf.device_table_coded(members, torch.from_numpy(x), refine=x)
    else:
        jt = jivf.device_table_coded(members, jnp.asarray(x, jnp.bfloat16))
        tt = tivf.device_table_coded(members, torch.from_numpy(x).to(torch.bfloat16))
    assert tt.codes.shape == jt.codes.shape == (24, 384, 24)
    np.testing.assert_array_equal(tt.rows.numpy(), np.asarray(jt.rows))
    np.testing.assert_array_equal(tt.slot_of_row.numpy(), np.asarray(jt.slot_of_row))
    for name in ("scale", "centroids", "cnorm2"):
        _close(getattr(tt, name).numpy(), getattr(jt, name), rtol=1e-5)
    dc = np.abs(tt.codes.numpy().astype(np.int32) - np.asarray(jt.codes, np.int32))
    assert dc.max() <= 1 and (dc > 0).mean() < 1e-3
    same = (dc == 0).all(-1)  # a slot's decoded norms move with its codes
    for name in ("bnorm2", "xnorm2"):
        _close(getattr(tt, name).numpy()[same], np.asarray(getattr(jt, name))[same], rtol=1e-5)
    if refine:
        dr = np.abs(tt.rcodes.numpy().astype(np.int32) - np.asarray(jt.rcodes, np.int32))
        # 254x finer steps than int8: an ulp of the centroid crosses more halves.
        assert dr.max() <= 1 and (dr > 0).mean() < 1e-2
    else:
        assert tt.rcodes is None and jt.rcodes is None


def test_slot_mask_matches_jax(data):
    x, members = data
    jt = jivf.device_table_coded(members, jnp.asarray(x))
    tt = tivf.device_table_coded(members, torch.from_numpy(x))
    mask = np.random.default_rng(3).random(len(x)) < 0.3
    np.testing.assert_array_equal(
        tivf.slot_mask_from_rows(tt, torch.from_numpy(mask)).numpy(),
        np.asarray(jivf.slot_mask_from_rows(jt, jnp.asarray(mask))))


@pytest.mark.parametrize("b,p,k_pad,qcap", [(64, 4, 40, 8), (300, 8, 24, 32), (5, 3, 16, 1)])
def test_invert_probes_matches_jax(b, p, k_pad, qcap):
    r = np.random.default_rng(b)
    # Skewed probes (distinct per query) so that some clusters overflow qcap.
    weights = np.r_[[0.3], np.full(k_pad - 1, 0.7 / (k_pad - 1))]
    probes = np.stack([r.choice(k_pad, p, replace=False, p=weights)
                       for _ in range(b)]).astype(np.int32)
    qt_j, qs_j = jivf._invert_probes(jnp.asarray(probes), k_pad, qcap)
    qt_t, qs_t = tivf._invert_probes(torch.from_numpy(probes), k_pad, qcap)
    np.testing.assert_array_equal(qt_t.numpy(), np.asarray(qt_j))
    np.testing.assert_array_equal(qs_t.numpy(), np.asarray(qs_j))


def test_lloyd_matches_jax_from_same_init():
    x, _ = tu.clustered_vectors(4000, 16, n_clusters=24, seed=5)
    init = x[np.random.default_rng(6).choice(len(x), 24, replace=False)]
    c_j, i_j = jkm._lloyd(jnp.asarray(x), jnp.asarray(init), 6, 1000)
    c_t, i_t = tkm._lloyd(torch.from_numpy(x), torch.from_numpy(init), 6, 1000)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-4, atol=1e-4)
    assert abs(float(i_t) - float(i_j)) <= 1e-4 * abs(float(i_j))


def test_train_kmeans_dev_matches_jax_on_random_init():
    """k > 256 draws its sample and initial centres from numpy's generator in
    both packages, so the trained centres agree; k <= 256 seeds k-means++
    from a torch.Generator and is held to the JAX inertia instead."""
    x, _ = tu.clustered_vectors(4000, 16, n_clusters=24, seed=5)
    c_j, i_j = jkm.train_kmeans_dev(jnp.asarray(x), 300, iters=4, seed=9, sample=2048)
    c_t, i_t = tkm.train_kmeans_dev(torch.from_numpy(x), 300, iters=4, seed=9, sample=2048)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-4, atol=1e-4)
    _, i_j = jkm.train_kmeans_dev(jnp.asarray(x), 24, iters=6, seed=9, sample=2048)
    c_t, i_t = tkm.train_kmeans_dev(torch.from_numpy(x), 24, iters=6, seed=9, sample=2048)
    assert c_t.shape == (24, 16) and torch.isfinite(c_t).all()
    assert float(i_t) <= 1.5 * float(i_j)


def test_membership_sort_matches_jax():
    """The sort form of the build's capacity-capped membership equals the
    JAX package's `_membership_sort` (which `_membership_dev` runs with
    BUILD_SORT_MEMBERSHIP=1; its default hash-scatter form places members
    differently by design)."""
    from vecgo_tpu_torch.index import build_fast as tbf

    r = np.random.default_rng(7)
    n, ov, k, cmax = 2000, 2, 33, 64  # 4000 memberships into 32 x 64 slots + a dump row
    assign = r.integers(0, k - 1, (n, ov)).astype(np.int32)
    assign[:, 1] = (assign[:, 0] + 1 + r.integers(0, k - 2, n)) % (k - 1)
    assign[-50:] = k - 1  # rows routed to the dump cluster
    dists = np.round(r.random((n, ov)), 2).astype(np.float32)  # many ties
    dists.sort(1)
    want = jbf._membership_sort(jnp.asarray(assign), jnp.asarray(dists), k, cmax)
    got = tbf._membership_sort(torch.from_numpy(assign), torch.from_numpy(dists), k, cmax)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    members, covered = want[0][: k - 1], want[3]
    np.testing.assert_array_equal(
        tbf._complete_membership(torch.from_numpy(np.array(members)),
                                 torch.from_numpy(np.array(covered))).numpy(),
        np.asarray(jbf._complete_membership_dev(members, covered)))
