"""The CUDA kernels against their plain PyTorch versions, on the card:
`scan_topk` (kernel A) and `coded_group_scan` (kernel B), and the engine
paths that launch them.

Every test here needs a CUDA card and nvcc and skips without one. This file
imports neither jax nor the JAX-only test config, so on a machine with a card
and no jax it runs as

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance (kernel A): both sides sum the same fp32 (or exact bf16) products
in another order, so distances agree within 2e-5 of |q|^2 + |x|^2 (l2) or
of 1 (dot, cos); ids agree except where the two rows' float64 scores tie
within that. Kernel B's tolerance is stated beside its tests.
"""

import numpy as np
import pytest
import torch

from vecgo_tpu_torch.ops.scan_topk import scan_topk, scan_topk_reference

REL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _exact(q, x, rows, metric):
    v = x[rows.clamp_min(0).long()].double()
    dot = torch.einsum("bkd,bd->bk", v, q.double())
    if metric == "l2":
        s = (q.double() ** 2).sum(1, keepdim=True) + (v * v).sum(-1) - 2 * dot
    else:
        s = -dot if metric == "dot" else 1 - dot
    return torch.where(rows >= 0, s, torch.inf)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,n,d,k,dtype,metric,mask_frac",
    [(13, 777, 32, 5, torch.float32, "l2", 0.0),
     (130, 5000, 128, 18, torch.bfloat16, "l2", 0.0),
     (64, 8192, 128, 16, torch.float32, "l2", 0.3),
     (70, 3000, 96, 256, torch.bfloat16, "dot", 0.5),
     (40, 4096, 768, 10, torch.float32, "cos", 0.0),
     (5, 10, 16, 20, torch.float32, "l2", 0.0)],
)
def test_kernel_matches_plain_version(cuda, b, n, d, k, dtype, metric, mask_frac):
    r = np.random.default_rng(n + k)
    q = torch.from_numpy(r.standard_normal((b, d)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(r.standard_normal((n, d)).astype(np.float32)).to(cuda)
    if metric == "cos":
        q, x = q / q.norm(dim=1, keepdim=True), x / x.norm(dim=1, keepdim=True)
    mask = torch.from_numpy(r.random(n) >= mask_frac).to(cuda) if mask_frac else None
    xn = (x * x).sum(1)
    args = (q, x.to(dtype), xn, k, metric, mask)
    before = scan_topk.launches
    d_k, i_k = scan_topk(*args)
    d_r, i_r = scan_topk_reference(*args)
    torch.cuda.synchronize()
    assert scan_topk.launches == before + 1
    tol = REL * (float((q * q).sum(1).max() + xn.max()) if metric == "l2" else 1.0)
    assert torch.equal(i_k < 0, i_r < 0)
    fin = torch.isfinite(d_r)
    assert float((d_k - d_r).abs()[fin].max()) <= tol
    swapped = (i_k != i_r) & fin
    if swapped.any():
        qo = q.to(dtype).float() if dtype == torch.bfloat16 else q
        xo = x.to(dtype).float()
        gap = (_exact(qo, xo, torch.where(swapped, i_k, -1), metric)
               - _exact(qo, xo, torch.where(swapped, i_r, -1), metric))[swapped]
        assert float(gap.abs().max()) <= 2 * tol
    if mask is not None:
        assert bool(mask[i_k[fin].long()].all())


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_kernel_drops_overflowing_rows_like_plain_version(cuda, metric):
    r = np.random.default_rng(11)
    q = torch.from_numpy(np.abs(r.standard_normal((6, 32))).astype(np.float32)).to(cuda)
    x = torch.from_numpy(r.standard_normal((300, 32)).astype(np.float32)).to(cuda)
    x[[7, 150]] = 3e38  # q.x overflows: dot scores -inf, l2 scores nan
    xn = (x * x).sum(1)
    d_k, i_k = scan_topk(q, x, xn, 8, metric)
    d_r, i_r = scan_topk_reference(q, x, xn, 8, metric)
    torch.cuda.synchronize()
    assert torch.isfinite(d_k).all() and not ((i_k == 7) | (i_k == 150)).any()
    assert torch.equal(i_k, i_r)
    scale = float((q * q).sum(1).max() + xn[torch.isfinite(xn)].max()) if metric == "l2" else 1.0
    assert float((d_k - d_r).abs().max()) <= REL * scale


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(4, 8, device=cuda)
    x = torch.zeros(16, 8, device=cuda)
    xn = torch.zeros(16, device=cuda)
    with pytest.raises(ValueError):
        scan_topk(q, x.half(), xn, 3)
    with pytest.raises(ValueError):
        scan_topk(q, x.cpu(), xn, 3)
    with pytest.raises(ValueError):
        scan_topk(q, x[:, :4], xn, 3)


@pytest.mark.cuda
def test_engine_on_card_goes_through_the_kernel(cuda):
    import vecgo_tpu_torch as vg
    from vecgo_tpu.metadata import eq

    r = np.random.default_rng(5)
    x = r.standard_normal((20_000, 32)).astype(np.float32)
    db = vg.Open(vg.Memory(), vg.Create(dim=32), device="cuda")
    ids = np.asarray(db.insert_batch(x, [{"c": i % 10} for i in range(len(x))]))
    db.commit()
    db.insert_batch(x[:100] + 0.5)
    before = scan_topk.launches
    q = x[:64] + 0.01
    got, _ = db.search_arrays(q, k=5)
    assert scan_topk.launches > before
    assert (got[:, 0] == ids[:64]).all()
    got_f, _ = db.search_arrays(q, k=5, filter=eq("c", 3))
    d2 = ((q[:, None] - x[None, 3::10]) ** 2).sum(-1)
    want = ids[3::10][np.argsort(d2, 1)[:, :5]]
    assert (got_f == want).mean() >= 0.999


# ---- kernel B: coded_group_scan ----
# Tolerance: both sides sum the same exact bf16 x int8 products in f32 in
# another order, so distances agree within 1e-4 of |q - c|^2 + |x^ - c|^2
# and columns agree except where their exact scores tie within that.
CODED_REL = 1e-4


def _coded_inputs(cuda, b, k, s, d, qcap, n_probe, masked, seed):
    from vecgo_tpu_torch.ops import ivf as ivf_ops

    r = np.random.default_rng(seed)
    q = torch.from_numpy(r.standard_normal((b, d)).astype(np.float32)).to(cuda)
    cent = torch.from_numpy(r.standard_normal((k, d)).astype(np.float32)).to(cuda)
    codes = torch.from_numpy(r.integers(-127, 128, (k, s, d)).astype(np.int8)).to(cuda)
    scale = torch.from_numpy((0.005 + 0.01 * r.random(k)).astype(np.float32)).to(cuda)
    bn = torch.from_numpy((r.random((k, s)) * 4 * d * 0.01).astype(np.float32)).to(cuda)
    bn[:, s - s // 5:] = float("inf")  # padded slots
    if masked:
        bn[torch.from_numpy(r.random((k, s)) < 0.4).to(cuda)] = float("inf")
        bn[0] = float("inf")  # an all-masked cluster
    probes = torch.from_numpy(np.stack([r.choice(k - 2, n_probe, replace=False)
                                        for _ in range(b)])).to(cuda)  # 2 clusters unprobed
    qtab, _ = ivf_ops._invert_probes(probes, k, qcap)
    return q, qtab, codes, bn, scale, cent


def _check_coded(args, d_k, i_k, d_r, i_r):
    q, qtab, codes, bn, scale, cent = args
    b = q.shape[0]
    live = qtab < b
    qr = q[qtab.clamp_max(b - 1).long()] - cent[:, None, :]
    qrn = torch.where(live, (qr * qr).sum(-1), 0.0)
    tol = CODED_REL * float(qrn.max() + bn[torch.isfinite(bn)].max())
    assert torch.equal(torch.isfinite(d_k), torch.isfinite(d_r))
    assert torch.equal(i_k >= 0, torch.isfinite(d_k))
    assert (i_k[~live] == -1).all()
    fin = torch.isfinite(d_r)
    if fin.any():
        assert float((d_k - d_r).abs()[fin].max()) <= tol
    bad = (i_k != i_r) & fin
    if bad.any():
        c, j, _ = bad.nonzero(as_tuple=True)
        col = i_k[bad].long()
        v = qr[c, j].to(torch.bfloat16).double()
        exact = (qrn[c, j].double() + bn[c, col].double()
                 - 2.0 * scale[c].double() * (v * codes[c, col].double()).sum(1))
        assert float((exact - d_r[bad].double()).abs().max()) <= 2 * tol


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,k,s,d,qcap,kk,n_probe,masked",
    [(4096, 3008, 1024, 128, 32, 16, 4, False),  # the serving profile's shapes
     (4096, 3008, 1024, 128, 96, 8, 20, True),  # 80% filter, 20 probes
     (300, 40, 100, 16, 37, 1, 3, True),
     (300, 40, 100, 16, 37, 32, 3, False),
     (200, 24, 256, 768, 45, 8, 4, True),
     (64, 10, 40, 18, 64, 16, 2, False)],  # d not a multiple of 4
)
def test_coded_kernel_matches_plain_version(cuda, b, k, s, d, qcap, kk, n_probe, masked):
    from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan, coded_group_scan_reference

    args = _coded_inputs(cuda, b, k, s, d, qcap, n_probe, masked, seed=b + d + kk)
    before = coded_group_scan.launches
    d_k, i_k = coded_group_scan(*args, kk)
    d_r, i_r = coded_group_scan_reference(*args, kk)
    torch.cuda.synchronize()
    assert coded_group_scan.launches == before + 1
    _check_coded(args, d_k, i_k, d_r, i_r)
    if masked:
        assert not torch.isfinite(d_k[0]).any()  # the all-masked cluster
    assert not torch.isfinite(d_k[-2:]).any()  # clusters no query probes


@pytest.mark.cuda
def test_coded_kernel_rejects_and_never_runs_plain_version(cuda, monkeypatch):
    from vecgo_tpu_torch.ops import coded_group_scan as cgs

    def boom(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(cgs, "coded_group_scan_reference", boom)
    q, qtab, codes, bn, scale, cent = _coded_inputs(cuda, 64, 10, 40, 16, 16, 2, False, 3)
    cgs.coded_group_scan(q, qtab, codes, bn, scale, cent, 8)
    torch.cuda.synchronize()
    before = cgs.coded_group_scan.launches
    bad = [
        (q.double(), qtab, codes, bn, scale, cent, 8),
        (q, qtab.long(), codes, bn, scale, cent, 8),
        (q, qtab, codes.to(torch.int16), bn, scale, cent, 8),
        (q, qtab, codes.cpu(), bn, scale, cent, 8),
        (q, qtab, codes, bn.cpu(), scale, cent, 8),
        (q, qtab, codes, bn, scale, cent, 33),
        (q, qtab, codes[:, :4].contiguous(), bn, scale, cent, 8),  # kk > S
        (q, qtab, codes, bn, scale, cent.T.contiguous().T, 8),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            cgs.coded_group_scan(*args)
    assert cgs.coded_group_scan.launches == before


@pytest.mark.cuda
def test_ivf_scan_on_card_launches_kernel_and_matches_cpu(cuda):
    from vecgo_tpu_torch.ops import ivf as ivf_ops
    from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan

    r = np.random.default_rng(8)
    centers = r.standard_normal((24, 32)).astype(np.float32)
    x = centers[r.integers(0, 24, 6000)] + 0.35 * r.standard_normal((6000, 32)).astype(np.float32)
    # Overlap-2 membership by the two nearest centres (distinct probe distances).
    near = np.argsort(((x[:, None] - centers[None]) ** 2).sum(-1), 1)[:, :2]
    members = np.full((24, 1024), -1, np.int32)
    fill = np.zeros(24, np.int64)
    for i, c in enumerate(near.reshape(-1)):
        if fill[c] < 1024:
            members[c, fill[c]] = i // 2
            fill[c] += 1
    q = x[:200] + 0.05 * r.standard_normal((200, 32)).astype(np.float32)
    mask = r.random(len(x)) < 0.7
    out = []
    for dev in (torch.device("cpu"), cuda):
        t = ivf_ops.device_table_coded(members, torch.from_numpy(x).to(dev))
        mflat = ivf_ops.slot_mask_from_rows(t, torch.from_numpy(mask).to(dev))
        before = coded_group_scan.launches
        d, rows = ivf_ops.ivf_scan(torch.from_numpy(q).to(dev), t, n_probe=4, kk=16,
                                   mask_flat=mflat)
        assert coded_group_scan.launches == before + (dev.type == "cuda")
        out.append((d.cpu().numpy(), rows.cpu().numpy()))
    (d_c, r_c), (d_g, r_g) = out
    assert mask[r_g[r_g >= 0]].all()
    # Overlap memberships return a row once per cluster holding it: compare sets.
    same = sum(len(set(a[a >= 0]) & set(c[c >= 0])) for a, c in zip(r_g, r_c))
    assert same >= 0.99 * sum(len(set(c[c >= 0])) for c in r_c)
    np.testing.assert_allclose(np.sort(d_g, 1), np.sort(d_c, 1), rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_engine_graph_on_card_goes_through_kernel_b(cuda):
    import vecgo_tpu_torch as vg
    from vecgo_tpu.metadata import isin
    from vecgo_tpu_torch.index.vamana import VamanaSegment
    from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan

    r = np.random.default_rng(6)
    centers = r.standard_normal((64, 32)).astype(np.float32)
    x = centers[r.integers(0, 64, 20_000)] + 0.35 * r.standard_normal((20_000, 32)).astype(np.float32)
    u = r.integers(0, 100, len(x))
    db = vg.Open(vg.Memory(), vg.Create(dim=32, graph_threshold=8192), device="cuda")
    ids = np.asarray(db.insert_batch(x, [{"u": int(v)} for v in u]))
    db.commit()
    db.compact([h.seg_id for h in db.engine._segments])
    assert type(db.engine._segments[0].segment) is VamanaSegment
    q = x[:256] + 0.01
    for kw, keep in (({}, None), (dict(filter=isin("u", list(range(80)))), u < 80)):
        before = coded_group_scan.launches
        got, _ = db.search_arrays(q, k=10, ef=48, nprobes=4, **kw)
        assert coded_group_scan.launches > before
        elig = np.arange(len(x)) if keep is None else np.flatnonzero(keep)
        d2 = ((q[:, None] - x[None, elig]) ** 2).sum(-1)
        want = ids[elig][np.argsort(d2, 1)[:, :10]]
        rec = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(got, want)])
        assert rec >= 0.95
