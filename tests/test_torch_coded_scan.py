"""Kernel B's plain version against the JAX package: `coded_group_scan_reference`
(what `coded_group_scan` runs on a CPU tensor) against the Pallas kernel
`pallas_coded_group_scan` in interpret mode, and the port's `ivf_scan`
against the JAX package's XLA scan (`_scan_groups`), on the same coded table.

Tolerance: both sides sum the same exact bf16 x int8 products in f32 in
another order, so distances agree within 1e-4 * (|q - c|^2 + |x^ - c|^2),
and ids agree except where two columns' scores tie within that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vecgo_tpu.ops import ivf as jivf
from vecgo_tpu.ops import pallas_scan
from vecgo_tpu.utils import testutil as tu
from vecgo_tpu_torch.ops import ivf as tivf
from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan, coded_group_scan_reference

torch.set_num_threads(1)

REL = 1e-4
BIG = 3.0e38


def membership(x, n_clusters, cap, overlap=2, seed=0):
    """Capacity-capped overlap membership [K, cap] (-1 padded), by nearest
    random centres."""
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


def port_table(jt) -> tivf.IVFCodedTable:
    return tivf.IVFCodedTable(*[torch.from_numpy(np.array(a)) for a in jt[:8]])


@pytest.fixture(scope="module")
def coded():
    x, _ = tu.clustered_vectors(5000, 16, n_clusters=16, seed=3)
    jt = jivf.device_table_coded(membership(x, 40, 256), jnp.asarray(x), group=4)
    rng = np.random.default_rng(4)
    q = (x[rng.choice(len(x), 24, replace=False)]
         + 0.02 * rng.standard_normal((24, 16))).astype(np.float32)
    cent = np.asarray(jt.centroids)
    cn = np.asarray(jt.cnorm2)
    probes = np.argsort((q * q).sum(1)[:, None] + cn[None] - 2 * q @ cent.T, 1, kind="stable")[:, :4]
    return x, jt, port_table(jt), q, probes.astype(np.int32)


def tolerance(q, qtab, cent, bn) -> float:
    live = qtab < len(q)
    qr = q[np.minimum(qtab, len(q) - 1)] - cent[:, None, :]
    qrn = np.where(live, (qr * qr).sum(-1), 0.0)
    return REL * float(qrn.max() + bn[np.isfinite(bn)].max())


def assert_same_lists(d_a, i_a, d_b, i_b, tol):
    """Sorted (dist, id) lists [..., kk] agree: same +inf slots, distances
    within tol, and ids equal except within ties at the list's end."""
    d_a, i_a, d_b, i_b = (a.reshape(-1, a.shape[-1]) for a in (d_a, i_a, d_b, i_b))
    np.testing.assert_array_equal(np.isfinite(d_a), np.isfinite(d_b))
    fin = np.isfinite(d_a)
    assert np.abs(d_a[fin] - d_b[fin]).max(initial=0.0) <= tol
    for row in np.flatnonzero(((i_a != i_b) & fin).any(1)):
        last = d_a[row][fin[row]].max()
        for ids, ds, other in ((i_a, d_a, i_b), (i_b, d_b, i_a)):
            extra = ~np.isin(ids[row], other[row]) & fin[row]
            assert (np.abs(ds[row][extra] - last) <= 2 * tol).all(), (row, ids[row], other[row])


@pytest.mark.parametrize("kk,qcap,masked", [(8, 24, False), (8, 24, True), (1, 3, False),
                                            (48, 24, False), (64, 24, True),
                                            # past the kernel's 64-entry lists
                                            (96, 24, False), (96, 24, True)])
def test_reference_matches_pallas_interpret(coded, kk, qcap, masked):
    x, jt, tt, q, probes = coded
    k_pad, s = jt.bnorm2.shape
    g = 4
    qtab, _ = jivf._invert_probes(jnp.asarray(probes), k_pad, qcap)
    qtab = np.array(qtab)
    bn = np.asarray(jt.bnorm2).copy()
    if masked:
        bn[np.random.default_rng(5).random(bn.shape) < 0.5] = np.inf
    q_ext = np.concatenate([q, np.zeros((1, q.shape[1]), np.float32)])
    ld, lc = pallas_scan.pallas_coded_group_scan(
        jnp.asarray(q_ext[qtab].reshape(k_pad // g, g, qcap, -1)),
        jt.codes.reshape(k_pad // g, g, s, -1), jnp.asarray(bn.reshape(k_pad // g, g, s)),
        jt.scale.reshape(k_pad // g, g), jt.centroids.reshape(k_pad // g, g, -1),
        kk, g, interpret=True,
    )
    ld = np.asarray(ld).reshape(k_pad, qcap, kk)
    lc = np.asarray(lc).reshape(k_pad, qcap, kk)
    ok = np.isfinite(ld) & (ld < BIG)  # what the JAX driver keeps
    ld, lc = np.where(ok, ld, np.inf), np.where(ok, lc, -1)

    d_p, i_p = coded_group_scan_reference(
        torch.from_numpy(q), torch.from_numpy(qtab), tt.codes, torch.from_numpy(bn), tt.scale,
        tt.centroids, kk)
    d_p, i_p = d_p.numpy(), i_p.numpy()
    live = qtab < len(q)
    assert np.isinf(d_p[~live]).all() and (i_p[~live] == -1).all()
    tol = tolerance(q, qtab, np.asarray(jt.centroids), bn)
    assert_same_lists(d_p[live], i_p[live], ld[live], lc[live], tol)
    if masked:
        assert np.isfinite(bn[np.arange(k_pad)[:, None, None], np.maximum(i_p, 0)][i_p >= 0]).all()


@pytest.mark.parametrize("qcap,masked,n_probe", [(24, False, 4), (24, True, 4), (4, False, 4),
                                                 (0, True, 20)])
def test_ivf_scan_matches_xla_scan(coded, qcap, masked, n_probe):
    """The port's ivf_scan (probe selection, inversion, kernel B's plain
    version, scatter) returns the JAX package's XLA candidate sets, with
    dump rows (qcap overflow) and masks; the last case is the segment's
    default knobs (20 probes, default qcap)."""
    x, jt, tt, q, _ = coded
    mask = None
    if masked:
        mask = np.zeros(len(x), bool)
        mask[::2] = True
    jm = None if mask is None else jivf.slot_mask_from_rows(jt, jnp.asarray(mask))
    d_j, r_j = jivf.ivf_scan(jnp.asarray(q), jt, n_probe=n_probe, kk=8, qcap=qcap, group=4,
                             mask_flat=jm)
    tm = None if mask is None else tivf.slot_mask_from_rows(tt, torch.from_numpy(mask))
    d_t, r_t = tivf.ivf_scan(torch.from_numpy(q), tt, n_probe=n_probe, kk=8, qcap=qcap,
                             mask_flat=tm)
    assert_same_candidates(d_j, r_j, d_t, r_t)
    if masked:
        assert (np.asarray(r_t)[np.asarray(r_t) >= 0] % 2 == 0).all()


def assert_same_candidates(d_j, r_j, d_t, r_t):
    """Per query, the same (row, distance) pairs; distances within 1e-4 (f32
    sums of the same products in another order; rows held twice by overlap
    memberships come once per cluster)."""
    d_j, r_j, d_t, r_t = map(np.asarray, (d_j, r_j, d_t, r_t))
    for b in range(len(r_j)):
        want = sorted((int(r), float(d)) for r, d in zip(r_j[b], d_j[b]) if r >= 0)
        got = sorted((int(r), float(d)) for r, d in zip(r_t[b], d_t[b]) if r >= 0)
        assert [r for r, _ in want] == [r for r, _ in got], (b, want, got)
        assert max((abs(a - c) for (_, a), (_, c) in zip(want, got)), default=0.0) <= 1e-4


@pytest.mark.parametrize("kk,masked", [(96, False), (96, True), ("S", False), ("S", True)])
def test_ivf_scan_matches_xla_scan_past_kk64(coded, kk, masked):
    """Past the kernel's 64-entry lists, up to kk = S: the port's ivf_scan
    returns the JAX package's XLA candidate sets at kk 96 and kk = S (every
    slot of a probed cluster), with and without a mask, under
    test_ivf_scan_matches_xla_scan's criteria."""
    x, jt, tt, q, _ = coded
    kk = tt.codes.shape[1] if kk == "S" else kk
    mask = None
    if masked:
        mask = np.random.default_rng(kk).random(len(x)) < 0.6
    jm = None if mask is None else jivf.slot_mask_from_rows(jt, jnp.asarray(mask))
    d_j, r_j = jivf.ivf_scan(jnp.asarray(q), jt, n_probe=4, kk=kk, qcap=24, group=4,
                             mask_flat=jm)
    tm = None if mask is None else tivf.slot_mask_from_rows(tt, torch.from_numpy(mask))
    d_t, r_t = tivf.ivf_scan(torch.from_numpy(q), tt, n_probe=4, kk=kk, qcap=24, mask_flat=tm)
    assert tuple(d_t.shape) == tuple(np.asarray(d_j).shape) == (len(q), 4 * kk)
    assert_same_candidates(d_j, r_j, d_t, r_t)
    if masked:
        got = np.asarray(r_t)
        assert mask[got[got >= 0]].all()


def test_wrapper_checks_and_cpu_route(coded):
    _, _, tt, q, probes = coded
    k_pad = tt.bnorm2.shape[0]
    qtab, _ = tivf._invert_probes(torch.from_numpy(probes), k_pad, 24)
    args = [torch.from_numpy(q), qtab, tt.codes, tt.bnorm2, tt.scale, tt.centroids]
    before = coded_group_scan.launches
    d, i = coded_group_scan(*args, 8)
    d_r, i_r = coded_group_scan_reference(*args, 8)
    assert torch.equal(d, d_r) and torch.equal(i, i_r)
    assert coded_group_scan.launches == before  # a CPU tensor never launches
    # Any 1 <= kk <= S takes the plain version on the CPU, past 64 too.
    for kk in (65, tt.codes.shape[1]):
        d, i = coded_group_scan(*args, kk)
        d_r, i_r = coded_group_scan_reference(*args, kk)
        assert torch.equal(d, d_r) and torch.equal(i, i_r) and d.shape[-1] == kk
    assert coded_group_scan.launches == before
    for kk in (0, tt.codes.shape[1] + 1):
        with pytest.raises(ValueError):
            coded_group_scan(*args, kk)
    with pytest.raises(ValueError):
        coded_group_scan(args[0].double(), *args[1:], 8)
    with pytest.raises(ValueError):
        coded_group_scan(args[0], qtab.long(), *args[2:], 8)
    with pytest.raises(ValueError):
        coded_group_scan(*args[:5], args[5].T.contiguous().T, 8)
