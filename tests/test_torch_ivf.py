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
from vecgo_tpu_torch import convert
from vecgo_tpu_torch.index import build_fast as tbf
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
    """The build's capacity-capped membership equals the JAX package's
    default form, `_membership_dev` without BUILD_SORT_MEMBERSHIP: the
    hash-scatter rounds in four distance waves (the port's clustered build
    took the sort form until its probes were found to cover less than the
    JAX writer's; the sort form is gone, the test keeps its name)."""
    r = np.random.default_rng(7)
    n, ov, k, cmax = 2000, 2, 33, 64  # 4000 memberships into 32 x 64 slots + a dump row
    assign = r.integers(0, k - 1, (n, ov)).astype(np.int32)
    assign[:, 1] = (assign[:, 0] + 1 + r.integers(0, k - 2, n)) % (k - 1)
    assign[-50:] = k - 1  # rows routed to the dump cluster
    dists = np.round(r.random((n, ov)), 2).astype(np.float32)  # many ties
    dists.sort(1)
    want = jbf._membership_dev(jnp.asarray(assign), jnp.asarray(dists), k, cmax)
    got = tbf._membership_scatter(torch.from_numpy(assign), torch.from_numpy(dists), k, cmax)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    members, covered = want[0][: k - 1], want[3]
    np.testing.assert_array_equal(
        tbf._complete_membership(torch.from_numpy(np.array(members)),
                                 torch.from_numpy(np.array(covered))).numpy(),
        np.asarray(jbf._complete_membership_dev(members, covered)))


# --- the compact (serve_compact) table, the beam build's table and the
# uncoded table, on tests/test_ivf.py's corpus ---------------------------


@pytest.fixture(scope="module")
def corpus():
    x, _ = tu.clustered_vectors(20_000, 32, n_clusters=64, seed=7)
    rng = np.random.default_rng(9)
    q = x[rng.choice(len(x), 64, replace=False)] + 0.02 * rng.standard_normal(
        (64, 32)).astype(np.float32)
    return x, q.astype(np.float32)


@pytest.fixture(scope="module")
def build_members(corpus):
    """The JAX clustered build's overlap-2 membership (tests/test_ivf.py's
    test_compact_members_primary)."""
    x, _ = corpus
    return jbf.build_graph_clustered(x, r=16, cluster_size=256, overlap=2,
                                     return_membership=True)[4]


def _containment(rows, gt_i):
    return sum(len(set(r[r >= 0].tolist()) & set(map(int, g)))
               for r, g in zip(rows, gt_i)) / gt_i.size


def test_compact_members_primary_matches_jax(corpus, build_members):
    """The same rows in each cluster and the same S' as the JAX repack (the
    keeper is the nearest cluster mean; ties to the smallest slot id); the
    order inside a cluster carries no meaning."""
    x, _ = corpus
    want = np.asarray(jivf.compact_members_primary(build_members, jnp.asarray(x)))
    got = tivf.compact_members_primary(build_members, torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == np.int32
    assert got.shape[1] % 128 == 0 and got.shape[1] <= build_members.shape[1]
    for a, b in zip(got, want):
        assert set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
        assert (a[: (a >= 0).sum()] >= 0).all()  # rows first
    live = got[got >= 0]
    assert len(live) == len(np.unique(live)) == len(x)  # exactly one slot per row


def test_compact_coded_table_scan_holds_the_jax_containment(corpus, build_members):
    """device_table_coded(compact=True) keeps one slot per row, and its scan
    at 16 probes holds >= 0.95 of the exact top-10, as
    tests/test_ivf.py::test_compact_members_primary holds the JAX table."""
    x, q = corpus
    t = tivf.device_table_coded(build_members, torch.from_numpy(x), compact=True, refine=x)
    rows = t.rows.numpy()
    assert (rows >= 0).sum() == len(x) and rows.shape[1] <= build_members.shape[1]
    np.testing.assert_array_equal(np.sort(rows[rows >= 0]), np.arange(len(x)))
    flat = rows.reshape(-1)
    assert (flat[t.slot_of_row.numpy()] == np.arange(len(x))).all()
    _, gt_i = tu.brute_force_knn(q, x, 10, "l2")
    _, got = tivf.ivf_scan(torch.from_numpy(q), t, n_probe=16, kk=16)
    assert _containment(got.numpy(), gt_i) >= 0.95


def test_assign_topk_full_matches_jax(corpus):
    """The JAX `_assign_topk_full` against the port's one assignment
    routine (`index/build_fast._assign_topk`, which `build_ivf_table` calls):
    the same nearest centroids per row up to near-ties (bf16 products
    summed in f32 in another order: >= 0.999 of the entries equal), the
    distances by rank within 1e-5 relative (padded rows carry +inf norms)."""
    x, _ = corpus
    cent = x[np.random.default_rng(4).choice(len(x), 40, replace=False)]
    block = 4096
    n_pad = -(-len(x) // block) * block
    import ml_dtypes

    xb = np.zeros((n_pad, x.shape[1]), ml_dtypes.bfloat16)
    xb[: len(x)] = x.astype(ml_dtypes.bfloat16)
    rn = np.full(n_pad, np.inf, np.float32)
    rn[: len(x)] = (x * x).sum(1)
    a_j, d_j = jivf._assign_topk_full(jnp.asarray(xb), jnp.asarray(rn), jnp.asarray(cent), 4,
                                      block)
    a_t, d_t = tbf._assign_topk(torch.from_numpy(xb.astype(np.float32)).to(torch.bfloat16),
                                torch.from_numpy(rn), torch.from_numpy(cent), 4, block)
    assert (a_t.numpy() == np.asarray(a_j)).mean() >= 0.999
    _close(d_t.numpy(), np.asarray(d_j), rtol=1e-5)


def test_fixup_coverage_byte_for_byte():
    """The host fix-up is a copy: the same placements (spares first, then
    evictions of redundant overlap memberships, then spill) as the JAX one."""
    r = np.random.default_rng(12)
    n, k, s, ov = 900, 12, 96, 3
    assign = np.stack([r.choice(k, ov, replace=False) for _ in range(n)])
    members = np.full((k, s), -1, np.int32)
    fill = np.zeros(k, np.int64)
    for p in r.permutation(n)[:800]:
        for c in assign[p][: r.integers(1, ov + 1)]:
            if fill[c] < s:
                members[c, fill[c]] = p
                fill[c] += 1
    covered = np.zeros(n, bool)
    covered[members[members >= 0]] = True
    assert (~covered).sum() > 50
    want, got = members.copy(), members.copy()
    jivf._fixup_coverage(want, covered, assign)
    tivf._fixup_coverage(got, covered, assign)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[got >= 0])) == n


@pytest.mark.parametrize("case", ["corpus", "overflow", "tiny_k"])
def test_build_ivf_table_covers_every_row(corpus, case):
    """tests/test_ivf.py's three coverage fixtures through the port's build
    (its own k-means draws): every row in a slot, the JAX table's shape."""
    if case == "corpus":
        x, kw = corpus[0], dict(capacity=256, seed=3)
    elif case == "overflow":  # one tight blob: capacity forces spill
        x = np.random.default_rng(0).standard_normal((2000, 16)).astype(np.float32) * 0.01
        kw = dict(capacity=128, slack=1.5, seed=1)
    else:  # k < 4 clusters: the overlap clamps to k
        x = np.random.default_rng(5).standard_normal((5000, 16)).astype(np.float32)
        kw = dict(capacity=4096, seed=2)
    cents, members = tivf.build_ivf_table(x, device="cpu", **kw)
    c_j, m_j = jivf.build_ivf_table(x, **kw)
    assert cents.shape == c_j.shape and members.shape == m_j.shape
    live = members[members >= 0]
    assert len(np.unique(live)) == len(x) and live.max() < len(x)


def test_uncoded_table_and_scan_match_jax(corpus):
    """device_table (bf16 residual blocks) over the same membership and
    centroids: rows equal, blocks equal to one bf16 rounding, norms within
    1e-5; ivf_scan at 8 probes, kk 16: the same probes and the same ids up
    to ties (>= 0.999 of the entries), distances within 1e-4 of
    |q-c|^2 + |x-c|^2; containment >= 0.95 as tests/test_ivf.py holds; the
    JAX table carried across scans the same way."""
    x, q = corpus
    cents, members = jivf.build_ivf_table(x, capacity=256, seed=3)
    xd = jnp.asarray(x)
    jt = jivf.device_table(members, cents, xd, jnp.sum(xd * xd, axis=1))
    tt = tivf.device_table(members, cents, torch.from_numpy(x))
    np.testing.assert_array_equal(tt.rows.numpy(), np.asarray(jt.rows))
    diff = np.abs(tt.blocks.float().numpy() - np.asarray(jt.blocks, np.float32))
    assert (diff <= 2 ** -7 * np.abs(np.asarray(jt.blocks, np.float32)) + 1e-30).all()
    for name in ("bnorm2", "centroids", "cnorm2"):
        _close(getattr(tt, name).numpy(), getattr(jt, name), rtol=1e-5)
    d_j, r_j = jivf.ivf_scan(jnp.asarray(q), jt, n_probe=8, kk=16)
    d_t, r_t = tivf.ivf_scan(torch.from_numpy(q), tt, n_probe=8, kk=16)
    d_j, r_j, d_t, r_t = np.asarray(d_j), np.asarray(r_j), d_t.numpy(), r_t.numpy()
    assert (r_t == r_j).mean() >= 0.999
    same = r_t == r_j
    fin = same & np.isfinite(d_j)
    scale = float(np.nanmax(np.where(np.isfinite(d_j), d_j, np.nan)))
    assert np.abs(d_t[fin] - d_j[fin]).max() <= 1e-4 * scale
    _, gt_i = tu.brute_force_knn(q, x, 10, "l2")
    assert _containment(r_t, gt_i) >= 0.95
    # The JAX table carried across (convert) scans to the same rows.
    ct = convert.ivf_table_from_jax(jt, "cpu")
    assert isinstance(ct, tivf.IVFDeviceTable) and ct.blocks.dtype == torch.bfloat16
    np.testing.assert_array_equal(ct.blocks.float().numpy(), np.asarray(jt.blocks, np.float32))
    _, r_c = tivf.ivf_scan(torch.from_numpy(q), ct, n_probe=8, kk=16)
    assert (r_c.numpy() == r_j).mean() >= 0.999
