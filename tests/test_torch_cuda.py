"""The CUDA kernel against its plain PyTorch version, on the card.

Every test here needs a CUDA card and nvcc and skips without one. This file
imports neither jax nor the JAX-only test config, so on a machine with a card
and no jax it runs as

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: both sides sum the same fp32 (or exact bf16) products in another
order, so distances agree within 2e-5 of |q|^2 + |x|^2 (l2) or of 1 (dot,
cos); ids agree except where the two rows' float64 scores tie within that.
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
