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
within that. The f32 product of tables TMA reads is a split-precision sum
(three tf32 passes), not an IEEE fp32 one: its distances are held to the
float64 answer at the same tolerance (closer to it than the plain version,
whose own fp32 error reaches 2.3e-5 on unnormalized dot rows at d 100).
Kernel B's tolerance is stated beside its tests.
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


def _exact(q, x, rows, metric, xn=None):
    v = x[rows.clamp_min(0).long()].double()
    dot = torch.einsum("bkd,bd->bk", v, q.double())
    if metric == "l2":
        vn = (v * v).sum(-1) if xn is None else xn[rows.clamp_min(0).long()].double()
        s = (q.double() ** 2).sum(1, keepdim=True) + vn - 2 * dot
    else:
        s = -dot if metric == "dot" else 1 - dot
    return torch.where(rows >= 0, s, torch.inf)


def _check_against_plain(q, x, xn, k, metric, mask, d_k, i_k, d_r, i_r):
    dtype = x.dtype
    tol = REL * (float((q * q).sum(1).max() + xn[torch.isfinite(xn)].max())
                 if metric == "l2" else 1.0)
    assert torch.equal(i_k < 0, i_r < 0)
    assert torch.equal(torch.isfinite(d_k), torch.isfinite(d_r))
    fin = torch.isfinite(d_r)
    if fin.any():
        # The split f32 product against the float64 answer for its rows.
        split = dtype == torch.float32 and scan_topk.last_product == "f32"
        ref = _exact(q, x, i_k, metric, xn) if split else d_r
        assert float((d_k - ref).abs()[fin].max()) <= tol
    swapped = (i_k != i_r) & fin
    if swapped.any():
        qo = q.to(dtype).float() if dtype == torch.bfloat16 else q
        xo = x.float()
        # Both sides score l2 with the caller's |x|^2, not the rounded row's.
        gap = (_exact(qo, xo, torch.where(swapped, i_k, -1), metric, xn)
               - _exact(qo, xo, torch.where(swapped, i_r, -1), metric, xn))[swapped]
        assert float(gap.abs().max()) <= 2 * tol
    if mask is not None:
        assert bool(mask[i_k[fin].long()].all())
    # Sorted by (score, row).
    dd, ii = d_k[:, 1:], i_k[:, 1:]
    prev_d, prev_i = d_k[:, :-1], i_k[:, :-1]
    ok = (prev_d < dd) | ((prev_d == dd) & ((prev_i < ii) | (ii < 0)))
    assert bool(ok.all())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,n,d,k,dtype,metric,mask_frac",
    [(13, 777, 32, 5, torch.float32, "l2", 0.0),
     (130, 5000, 128, 18, torch.bfloat16, "l2", 0.0),
     (64, 8192, 128, 16, torch.float32, "l2", 0.3),
     (70, 3000, 96, 256, torch.bfloat16, "dot", 0.5),
     (40, 4096, 768, 10, torch.float32, "cos", 0.0),
     (5, 10, 16, 20, torch.float32, "l2", 0.0),
     # The engine's pools: memtable chunks (f32) and the churn margin (bf16).
     (300, 8192, 128, 74, torch.float32, "l2", 0.3),
     (300, 8192, 128, 82, torch.float32, "l2", 0.0),
     (200, 20000, 128, 82, torch.bfloat16, "l2", 0.1),
     (100, 5000, 128, 256, torch.bfloat16, "l2", 0.2),
     (100, 5000, 64, 256, torch.float32, "cos", 0.0),
     # d neither a multiple of 16 nor of 8; wide rows (the query tile shrinks
     # to 64, and at k=256 its depth chunks ride the ring).
     (77, 3001, 100, 18, torch.bfloat16, "l2", 0.1),
     (77, 3001, 100, 18, torch.float32, "dot", 0.0),
     (150, 4000, 768, 18, torch.bfloat16, "cos", 0.0),
     (60, 2000, 768, 256, torch.bfloat16, "l2", 0.0),
     # N below one 64-row tile; B not a multiple of the query tile.
     (129, 50, 32, 10, torch.bfloat16, "dot", 0.0),
     (129, 50, 32, 10, torch.float32, "cos", 0.0),
     # Every metric on both table types.
     (257, 3000, 64, 10, torch.bfloat16, "cos", 0.0),
     (257, 3000, 64, 10, torch.float32, "dot", 0.0),
     (257, 3000, 64, 10, torch.float32, "l2", 0.5)],
)
def test_kernel_matches_plain_version(cuda, b, n, d, k, dtype, metric, mask_frac):
    r = np.random.default_rng(n + k + d)
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
    _check_against_plain(*args, d_k, i_k, d_r, i_r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_breaks_exact_ties_to_lower_rows_across_splits(cuda, dtype):
    """37 distinct rows repeated over 20,000: every query's 74 best are exact
    ties, spread over several splits; both sides keep the lowest row ids."""
    r = np.random.default_rng(37)
    base = torch.from_numpy(r.standard_normal((37, 64)).astype(np.float32)).to(cuda)
    x = base[torch.arange(20_000, device=cuda) % 37].contiguous()
    q = torch.from_numpy(r.standard_normal((64, 64)).astype(np.float32)).to(cuda)
    xn = (x * x).sum(1)
    args = (q, x.to(dtype), xn, 74, "l2", None)
    d_k, i_k = scan_topk(*args)
    d_r, i_r = scan_topk_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(i_k, i_r)
    best = i_k[:, :1] % 37
    assert torch.equal(i_k, best + 37 * torch.arange(74, device=cuda, dtype=i_k.dtype))
    assert torch.equal(d_k, d_k[:, :1].expand(-1, 74))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_skips_non_finite_and_masked_rows(cuda, dtype):
    r = np.random.default_rng(12)
    n, d = 3000, 48
    q = torch.from_numpy(r.standard_normal((100, d)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(r.standard_normal((n, d)).astype(np.float32)).to(cuda)
    x[5] = float("nan")
    x[700, 3] = float("inf")
    x[2999] = float("-inf")
    xn = (x * x).sum(1)
    mask = torch.from_numpy(r.random(n) >= 0.3).to(cuda)
    mask[:64] = False  # a whole tile masked
    for metric in ("l2", "dot", "cos"):
        args = (q, x.to(dtype), xn, 82, metric, mask)
        d_k, i_k = scan_topk(*args)
        d_r, i_r = scan_topk_reference(*args)
        torch.cuda.synchronize()
        assert torch.isfinite(d_k).all()
        assert not torch.isin(i_k, torch.tensor([5, 700, 2999], device=cuda)).any()
        _check_against_plain(*args, d_k, i_k, d_r, i_r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order,n,k", [("random", 256, 256), ("nearing", 1024, 200),
                                       ("nearing", 1024, 256)])
def test_kernel_merges_full_candidate_buffers_while_lists_fill(cuda, dtype, order, n, k):
    """No mask, so every tile enters a filling pool whole (its threshold is
    +inf until the first compaction). With N = k every row is in the
    answer. With rows that come nearer the queries tile by tile ("nearing":
    radius 40 down to 1 about the origin, queries within 0.01 of it), every
    candidate ranks before every pooled entry, at every compaction."""
    r = np.random.default_rng(n + k)
    q = r.standard_normal((64, 128)).astype(np.float32)
    x = r.standard_normal((n, 128)).astype(np.float32)
    if order == "nearing":
        q *= 0.01
        x *= (np.linspace(40, 1, n) / np.linalg.norm(x, axis=1)).astype(np.float32)[:, None]
    q, x = torch.from_numpy(q).to(cuda), torch.from_numpy(x).to(cuda)
    xn = (x * x).sum(1)
    args = (q, x.to(dtype), xn, k, "l2", None)
    d_k, i_k = scan_topk(*args)
    d_r, i_r = scan_topk_reference(*args)
    torch.cuda.synchronize()
    _check_against_plain(*args, d_k, i_k, d_r, i_r)
    assert torch.equal(i_k.sort(1).values, i_r.sort(1).values)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_merges_splits_when_one_split_holds_the_whole_list(cuda, dtype):
    """Rows in cluster order: the first 300 rows (all in the first split)
    are near the queries and the other 39,700 far, so at k = 256 every
    entry of the first split's list ranks before every other split's best
    entry, whose rank in the merge is then exactly k."""
    from vecgo_tpu_torch.kernels import _build
    from vecgo_tpu_torch.ops import scan_topk as st

    r = np.random.default_rng(256)
    x = r.standard_normal((40_000, 128)).astype(np.float32)
    x[300:] += 100.0
    q = torch.from_numpy(r.standard_normal((64, 128)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(x).to(cuda)
    xn = (x * x).sum(1)
    args = (q, x.to(dtype), xn, 256, "l2", None)
    plan = st._plan(_build.library(), q.device, int(dtype == torch.bfloat16), 128, 256)
    splits, rows_per_split = st.split_plan(64, 40_000, plan.tq, plan.bps * plan.sms, plan.pool,
                                           plan.tn, plan.min_tiles, plan.max_splits)
    assert splits > 1 and rows_per_split >= 300
    d_k, i_k = scan_topk(*args)
    d_r, i_r = scan_topk_reference(*args)
    torch.cuda.synchronize()
    _check_against_plain(*args, d_k, i_k, d_r, i_r)
    assert bool((i_k < 300).all())
    assert torch.equal(i_k.sort(1).values, i_r.sort(1).values)


# ---- kernel A's short and deep bf16 products (TMA + wgmma), f32 product ----
# The short product takes the bf16 tables TMA can read (rows of a multiple of
# 8 bf16, 16-byte aligned) up to d = 256, the deep product those past it;
# other bf16 tables take the tile product's register-staged loads; the f32
# product every f32 table. dot and cos run on unit rows, so both stay within
# REL of 1.


def _unit_rows(r, n, d):
    x = r.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,n,d,k,dtype,metric,mask_frac,product",
    [(130, 5000, 1536, 36, torch.bfloat16, "l2", 0.0, "deep"),
     (130, 5000, 2048, 36, torch.bfloat16, "dot", 0.3, "deep"),
     (70, 3000, 4096, 100, torch.bfloat16, "cos", 0.0, "deep"),
     (300, 3000, 4096, 256, torch.bfloat16, "l2", 0.1, "deep"),
     (200, 20000, 1536, 1000, torch.bfloat16, "l2", 0.0, "deep"),
     (33, 4000, 2048, 1, torch.bfloat16, "cos", 0.5, "deep"),
     (257, 9000, 4096, 36, torch.bfloat16, "dot", 0.0, "deep"),
     # N below one 256-row tile, B not a multiple of 128.
     (129, 50, 1536, 10, torch.bfloat16, "dot", 0.0, "deep"),
     (129, 200, 2048, 100, torch.bfloat16, "l2", 0.2, "deep"),
     # The short product (bf16, d % 8 == 0, d <= 256, k <= 1024): every
     # metric with masks; k 1, 18, 82, 256, 1000 and N; B 1, 63, 129 and
     # 4097; N below one 128-row tile and N not a multiple of it; d 8 to 256;
     # each build (1-4 depth chunks, three warpgroups to k 64, two past it).
     (1, 300, 8, 5, torch.bfloat16, "l2", 0.0, "short"),
     (63, 5000, 16, 1, torch.bfloat16, "dot", 0.3, "short"),
     (129, 100, 64, 18, torch.bfloat16, "cos", 0.0, "short"),
     (129, 4000, 72, 82, torch.bfloat16, "l2", 0.2, "short"),
     (4097, 3000, 96, 18, torch.bfloat16, "l2", 0.1, "short"),
     (300, 20000, 128, 256, torch.bfloat16, "dot", 0.0, "short"),
     (200, 20000, 128, 1000, torch.bfloat16, "cos", 0.5, "short"),
     (70, 1000, 128, 1000, torch.bfloat16, "l2", 0.3, "short"),
     (130, 9000, 192, 36, torch.bfloat16, "cos", 0.1, "short"),
     (70, 5000, 160, 100, torch.bfloat16, "dot", 0.2, "short"),
     (257, 9001, 256, 82, torch.bfloat16, "l2", 0.0, "short"),
     (33, 127, 256, 10, torch.bfloat16, "dot", 0.0, "short"),
     # The deep product past the short one's depth.
     (130, 9000, 264, 36, torch.bfloat16, "l2", 0.2, "deep"),
     # d not a multiple of 8: the tile product's element loads.
     (77, 3001, 4100, 18, torch.bfloat16, "l2", 0.1, "tile"),
     (77, 3001, 4100, 36, torch.bfloat16, "cos", 0.0, "tile"),
     # The f32 product: resident query tiles (d 32, 100, 128), streamed
     # ones (d 768), narrow and wide k, ragged B, N below a tile; rows TMA
     # cannot read (d % 4 != 0) run on the FMA product.
     (300, 8192, 32, 10, torch.float32, "l2", 0.0, "f32"),
     (77, 3001, 100, 82, torch.float32, "dot", 0.2, "f32"),
     (300, 8192, 128, 82, torch.float32, "l2", 0.3, "f32"),
     (129, 90, 128, 10, torch.float32, "cos", 0.0, "f32"),
     (200, 20000, 128, 1000, torch.float32, "l2", 0.1, "f32"),
     (200, 8192, 128, 1000, torch.float32, "l2", 0.1, "f32"),
     (200, 8192, 126, 1000, torch.float32, "l2", 0.1, "f32-fma"),
     (40, 4096, 768, 10, torch.float32, "cos", 0.0, "f32"),
     (130, 5000, 768, 256, torch.float32, "l2", 0.0, "f32"),
     (70, 3000, 100, 300, torch.float32, "cos", 0.0, "f32")],
)
def test_kernel_deep_and_f32_products_match_plain_version(cuda, b, n, d, k, dtype, metric,
                                                          mask_frac, product):
    r = np.random.default_rng(n + k + d)
    unit = metric != "l2"
    q = _unit_rows(r, b, d) if unit else r.standard_normal((b, d)).astype(np.float32)
    x = _unit_rows(r, n, d) if unit else r.standard_normal((n, d)).astype(np.float32)
    q, x = torch.from_numpy(q).to(cuda), torch.from_numpy(x).to(cuda)
    mask = torch.from_numpy(r.random(n) >= mask_frac).to(cuda) if mask_frac else None
    xn = (x * x).sum(1)
    args = (q, x.to(dtype), xn, k, metric, mask)
    before = scan_topk.launches
    d_k, i_k = scan_topk(*args)
    assert scan_topk.last_product == product
    d_r, i_r = scan_topk_reference(*args)
    torch.cuda.synchronize()
    assert scan_topk.launches == before + 1
    _check_against_plain(*args, d_k, i_k, d_r, i_r)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2048, 128])
def test_kernel_deep_product_takes_unaligned_rows_by_element_loads(cuda, d):
    """A bf16 table whose rows are not 16-byte aligned cannot be read by TMA,
    at the deep product's depths or the short product's: the plan gives it
    the tile product (rows staged through registers), which matches the
    plain version."""
    r = np.random.default_rng(5)
    n = 3000
    flat = torch.empty(n * d + 1, dtype=torch.bfloat16, device=cuda)
    x = flat[1:].view(n, d)
    x.copy_(torch.from_numpy(r.standard_normal((n, d)).astype(np.float32)))
    q = torch.from_numpy(r.standard_normal((70, d)).astype(np.float32)).to(cuda)
    xn = (x.float() ** 2).sum(1)
    args = (q, x, xn, 20, "l2", None)
    d_k, i_k = scan_topk(*args)
    assert scan_topk.last_product == "tile"
    d_r, i_r = scan_topk_reference(*args)
    torch.cuda.synchronize()
    _check_against_plain(*args, d_k, i_k, d_r, i_r)


@pytest.mark.cuda
@pytest.mark.parametrize("d,offset,product", [(100, 0, "f32"), (128, 4, "f32"),
                                              (102, 0, "f32-fma"), (128, 1, "f32-fma"),
                                              (100, 3, "f32-fma")])
def test_kernel_f32_rows_tma_cannot_read_take_the_fma_product(cuda, d, offset, product):
    """An f32 table whose rows TMA reads (a pitch of a multiple of 16 bytes
    from a 16-byte aligned base: d 100, or a view that starts 4 floats in)
    takes the split product; one whose pitch is not (d 102) or a view that
    starts mid-row at an unaligned float (1, 3) takes the FMA product. Each
    matches the plain version."""
    r = np.random.default_rng(d + offset)
    n = 20_000
    flat = torch.empty(n * d + offset, device=cuda)
    x = flat[offset:].view(n, d)
    x.copy_(torch.from_numpy(r.standard_normal((n, d)).astype(np.float32)))
    q = torch.from_numpy(r.standard_normal((70, d)).astype(np.float32)).to(cuda)
    xn = (x * x).sum(1)
    for k, metric in ((20, "l2"), (300, "dot")):
        args = (q, x, xn, k, metric, None)
        d_k, i_k = scan_topk(*args)
        assert scan_topk.last_product == product
        d_r, i_r = scan_topk_reference(*args)
        torch.cuda.synchronize()
        _check_against_plain(*args, d_k, i_k, d_r, i_r)


@pytest.mark.cuda
def test_kernel_f32_product_reads_raw_rows_as_their_tf32_high_part(cuda):
    """The split product hands the tensor cores raw f32 rows as their tf32
    high part, which is right only where the tensor cores ignore an
    operand's low 13 bits (truncate, not round), and adds the low part
    x - trunc(x) beside it. Rows of values with 21 significant bits (their
    low part exact in tf32), most with bits below tf32's, against one-hot
    queries: every dot score is a row's value exactly, as the plain
    version's; tensor cores that rounded would miss by up to 2^-11 of it.
    The one-hot queries repeat four times, so both warpgroups of a unit
    multiply them."""
    r = np.random.default_rng(3)
    n, d = 4096, 32
    mant = r.integers(1 << 20, 1 << 21, size=(n, d)).astype(np.float64)
    x = mant * 2.0 ** -20 * r.choice([-1.0, 1.0], size=(n, d)) * 2.0 ** r.integers(-3, 4, (n, d))
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    assert bool(((x.view(torch.int32) & 0x1FFF) != 0).float().mean() > 0.9)
    q = torch.eye(d, device=cuda).repeat(4, 1)
    d_k, i_k = scan_topk(q, x, None, 16, "dot")
    assert scan_topk.last_product == "f32"
    d_r, i_r = scan_topk_reference(q, x, None, 16, "dot")
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_r)
    assert torch.equal(i_k, i_r)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,k,metric", [(4096, 8192, 128, 82, "l2"),
                                            (4096, 1 << 20, 128, 10, "l2"),
                                            (4096, 65536, 768, 10, "cos"),
                                            (77, 3001, 100, 18, "dot")],
                         ids=["chunk-pool82", "f32-1M", "wide-d768", "normal-d100-dot"])
def test_kernel_f32_product_is_fp32_class(cuda, b, n, d, k, metric):
    """The split product's error against float64 at the memtable chunk's,
    ShardedFlat's and the wide rows' shapes (4096 queries; rows around 1,024
    random centres, sigma 0.35, as chip_smoke.py makes them), and on the
    unnormalized normal rows of the dot case above: the 99.9th percentile of
    |score - exact| / (|q|^2 + |x|^2) over the returned scores is at most 8x
    the plain IEEE fp32 version's on the same inputs (TF32 off), each side's
    returned rows scored exactly in float64 with the caller's |x|^2."""
    g = torch.Generator(device=cuda).manual_seed(n + d)
    centres = torch.randn((1024, d), generator=g, device=cuda)

    def made(rows):
        pick = torch.randint(0, 1024, (rows,), generator=g, device=cuda)
        return centres[pick] + 0.35 * torch.randn((rows, d), generator=g, device=cuda)

    x, q = made(n), made(b)
    if metric == "dot":  # the normal rows of test_kernel_matches_plain_version's case
        r = np.random.default_rng(n + k + d)
        q = torch.from_numpy(r.standard_normal((b, d)).astype(np.float32)).to(cuda)
        x = torch.from_numpy(r.standard_normal((n, d)).astype(np.float32)).to(cuda)
    if metric == "cos":
        x, q = x / x.norm(dim=1, keepdim=True), q / q.norm(dim=1, keepdim=True)
    xn = (x * x).sum(1)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        d_k, i_k = scan_topk(q, x, xn, k, metric)
        assert scan_topk.last_product == "f32"
        d_r, i_r = scan_topk_reference(q, x, xn, k, metric)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    _check_against_plain(q, x, xn, k, metric, None, d_k, i_k, d_r, i_r)

    def errors(dd, ii):
        exact = _exact(q, x, ii, metric, xn)
        den = (q.double() ** 2).sum(1, keepdim=True) + (x.double() ** 2).sum(1)[ii.long()]
        err = (dd.double() - exact).abs()[ii >= 0]
        return float(torch.quantile(err / den[ii >= 0], 0.999)), float(err.max())

    (kernel, kernel_max), (plain, plain_max) = errors(d_k, i_k), errors(d_r, i_r)
    print(f"f32 product p99.9 relative error b={b} n={n} d={d} k={k} {metric}: kernel "
          f"{kernel:.3g}, plain {plain:.3g} ({kernel / plain:.2f}x); max |score - exact| "
          f"kernel {kernel_max:.3g}, plain {plain_max:.3g} [{torch.cuda.get_device_name(0)}]")
    assert kernel <= 8 * plain


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "dot", "cos"])
@pytest.mark.parametrize("b,n,d", [(4096, 20_000, 96), (4096, 6000, 1536), (100, 20_000, 96),
                                   (100, 6000, 1536)],
                         ids=["paired-resident", "paired-streamed", "partial-resident",
                              "partial-streamed"])
def test_kernel_f32_product_paired_and_single_warpgroup_units_agree(cuda, b, n, d, metric):
    """The split product's units of 128 queries: the queries scanned at
    once (both warpgroups of a unit live; at B 100 the second holds 36) and
    as 64-query slices (the second warpgroup idle) give bit-identical
    distances and the same ids, with queries resident (d 96) and streamed
    (d 1536), under a mask; the counters read every unit paired at once at
    B 4096 and 100, and none in the slices."""
    from vecgo_tpu_torch.engine import tracing

    r = np.random.default_rng(b + n + d)
    x = r.standard_normal((n, d)).astype(np.float32)
    q = r.standard_normal((b, d)).astype(np.float32)
    if metric != "l2":
        x, q = _unit_rows(r, n, d), _unit_rows(r, b, d)
    x, q = torch.from_numpy(x).to(cuda), torch.from_numpy(q).to(cuda)
    xn = (x * x).sum(1)
    mask = torch.from_numpy(r.random(n) >= 0.2).to(cuda)
    with tracing.recording() as rec:
        d_k, i_k = scan_topk(q, x, xn, 100, metric, mask)
        assert scan_topk.last_product == "f32"
        torch.cuda.synchronize()
    counts = {c.name: c.n for c in rec.counts()}
    assert counts["scan_topk.split_paired_units"] == counts["scan_topk.split_units"] > 0
    with tracing.recording() as rec:
        parts = [scan_topk(q[s:s + 64], x, xn, 100, metric, mask) for s in range(0, b, 64)]
        torch.cuda.synchronize()
    assert sum(c.n for c in rec.counts("scan_topk.split_paired_units")) == 0
    assert torch.equal(d_k, torch.cat([p[0] for p in parts]))
    assert torch.equal(i_k, torch.cat([p[1] for p in parts]))
    d_r, i_r = scan_topk_reference(q, x, xn, 100, metric, mask)
    torch.cuda.synchronize()
    _check_against_plain(q, x, xn, 100, metric, mask, d_k, i_k, d_r, i_r)


def _descending_rows(r, b, n, d, metric, order):
    """Queries and rows whose scores fall row by row for every query, so
    that each tile of a filling pool pushes and compacts: l2 rows of norm
    40 down to 1 about queries near 0; dot and cos rows that turn towards
    the queries' common direction (dot's also grow). "ties": the table's
    second half repeats its first, exact ties across tiles and splits."""
    if metric == "l2":
        q = 0.01 * r.standard_normal((b, d))
        x = r.standard_normal((n, d))
        x *= (np.linspace(40, 1, n) / np.linalg.norm(x, axis=1))[:, None]
    else:
        u = r.standard_normal(d)
        u /= np.linalg.norm(u)
        q = u + 0.1 * r.standard_normal((b, d)) / np.sqrt(d)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        x = u + np.linspace(3, 0.05, n)[:, None] * r.standard_normal((n, d)) / np.sqrt(d)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        if metric == "dot":
            x *= np.linspace(1, 2, n)[:, None]
    if order == "ties":
        x = x[np.arange(n) % -(-n // 2)]
    return q.astype(np.float32), x.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["descending", "ties"])
@pytest.mark.parametrize("metric", ["l2", "dot", "cos"])
@pytest.mark.parametrize("d", [96, 1536], ids=["resident-d96", "streamed-d1536"])
@pytest.mark.parametrize("b", [100, 4096])
@pytest.mark.parametrize("n", [128, 256, 20_000], ids=["1-tile", "2-tiles", "many-tiles"])
def test_kernel_f32_product_on_rows_that_push_every_tile(cuda, n, b, d, metric, order):
    """The split product where every tile pushes and the pools compact pass
    after pass: units of one tile, two and many; B 100 (the second
    warpgroup of the one unit holds 36 queries; at 4096 both are full);
    queries resident (d 96) and streamed (d 1536); every metric; rows whose
    scores fall row by row, with a 10% mask, and with exact ties. It
    matches the plain version (ids, order, ties, masks, the 2e-5
    tolerance)."""
    r = np.random.default_rng(n + b + d + len(metric) + len(order))
    q, x = _descending_rows(r, b, n, d, metric, order)
    q, x = torch.from_numpy(q).to(cuda), torch.from_numpy(x).to(cuda)
    xn = (x * x).sum(1)
    mask = torch.from_numpy(r.random(n) >= 0.1).to(cuda)
    d_k, i_k = scan_topk(q, x, xn, 100, metric, mask)
    assert scan_topk.last_product == "f32"
    d_r, i_r = scan_topk_reference(q, x, xn, 100, metric, mask)
    torch.cuda.synchronize()
    _check_against_plain(q, x, xn, 100, metric, mask, d_k, i_k, d_r, i_r)


@pytest.mark.cuda
def test_kernel_f32_product_build_keeps_wgmma_async_and_spills_nothing(cuda):
    """ptxas's report of csrc/scan_topk.cu (kept beside the library by
    `_build`): no C7518 (wgmma serialized) for scan_split_kernel, and no
    spill stores or loads in it at its setmaxnreg split (56 / 224
    registers)."""
    from vecgo_tpu_torch.kernels import _build

    _build.library()
    log = _build.BUILD_LOG["scan_topk.cu"]
    lines = log.splitlines()
    serialized = [ln for ln in lines if "C7518" in ln]
    assert not [ln for ln in serialized if "scan_split_kernel" in ln or "_Z" not in ln]
    at = [i for i, ln in enumerate(lines)
          if "Compiling entry function" in ln and "scan_split_kernel" in ln]
    assert len(at) == 1
    props = next(ln for ln in lines[at[0] + 1:] if "spill stores" in ln)
    assert "0 bytes spill stores, 0 bytes spill loads" in props, props


@pytest.mark.cuda
@pytest.mark.parametrize("d,metric", [(128, "l2"), (96, "dot"), (256, "cos")])
def test_kernel_short_product_on_row_slices(cuda, d, metric):
    """Probed partitions and decoded blocks hand the kernel row-slice views
    of one table, at row offsets TMA reads from their own base: each
    slice's answer (slice-local row ids) matches the plain version's on the
    same view, with the slice's own mask and norms."""
    r = np.random.default_rng(d)
    n = 20_000
    x = _unit_rows(r, n, d) if metric != "l2" else r.standard_normal((n, d)).astype(np.float32)
    q = _unit_rows(r, 100, d) if metric != "l2" else r.standard_normal((100, d)).astype(np.float32)
    x, q = torch.from_numpy(x).to(cuda), torch.from_numpy(q).to(cuda)
    xn = (x * x).sum(1)
    xb = x.to(torch.bfloat16)
    mask = torch.from_numpy(r.random(n) >= 0.2).to(cuda)
    for lo, hi in [(0, 1000), (1, 130), (4999, 12000), (19_900, 20_000)]:
        args = (q, xb[lo:hi], xn[lo:hi], 18, metric, mask[lo:hi])
        d_k, i_k = scan_topk(*args)
        assert scan_topk.last_product == "short"
        d_r, i_r = scan_topk_reference(*args)
        torch.cuda.synchronize()
        _check_against_plain(*args, d_k, i_k, d_r, i_r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 2048), (torch.float32, 128),
                                     (torch.bfloat16, 128), (torch.bfloat16, 256)])
def test_kernel_new_products_break_exact_ties_across_splits(cuda, dtype, d):
    """As the tie test above, at the deep, f32 and short products' tiles: 37
    distinct rows repeated over 40,000 (several splits of 256- or 128-row
    tiles); both sides keep the lowest row ids of every tie."""
    r = np.random.default_rng(d)
    base = torch.from_numpy(r.standard_normal((37, d)).astype(np.float32)).to(cuda)
    x = base[torch.arange(40_000, device=cuda) % 37].contiguous()
    q = torch.from_numpy(r.standard_normal((150, d)).astype(np.float32)).to(cuda)
    xn = (x * x).sum(1)
    args = (q, x.to(dtype), xn, 74, "l2", None)
    d_k, i_k = scan_topk(*args)
    d_r, i_r = scan_topk_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(i_k, i_r)
    best = i_k[:, :1] % 37
    assert torch.equal(i_k, best + 37 * torch.arange(74, device=cuda, dtype=i_k.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,product", [(torch.bfloat16, 2048, "deep"),
                                             (torch.float32, 128, "f32-fma"),
                                             (torch.float32, 128, "f32"),
                                             (torch.bfloat16, 128, "short")])
@pytest.mark.parametrize("order,n,k", [("random", 512, 256), ("nearing", 2048, 200),
                                       ("nearing", 3000, 1000)])
def test_kernel_new_products_merge_full_buffers_while_lists_fill(cuda, monkeypatch, dtype, d,
                                                                 product, order, n, k):
    """No mask, so every tile of a filling list enters it whole: the deep
    product's 256-row tiles and the short and split f32 products' 128-row
    tiles in 64-row passes, the FMA f32 product's 128-row tiles in two
    passes of 64 rows. The f32 products run by their own plans (the FMA
    one's is that of rows TMA cannot read) on the same table. With rows that
    come nearer the queries tile by tile ("nearing"), every candidate ranks
    before every pooled entry at every compaction."""
    if dtype == torch.float32:
        from vecgo_tpu_torch.kernels import _build
        from vecgo_tpu_torch.ops import scan_topk as st

        plan = st._plan(_build.library(), cuda, 0, d, k, int(product == "f32"))
        monkeypatch.setattr(st, "_plan", lambda *a, **kw: plan)
    r = np.random.default_rng(n + k + d)
    q = r.standard_normal((130, d)).astype(np.float32)
    x = r.standard_normal((n, d)).astype(np.float32)
    if order == "nearing":
        q *= 0.01
        x *= (np.linspace(40, 1, n) / np.linalg.norm(x, axis=1)).astype(np.float32)[:, None]
    q, x = torch.from_numpy(q).to(cuda), torch.from_numpy(x).to(cuda)
    xn = (x * x).sum(1)
    args = (q, x.to(dtype), xn, k, "l2", None)
    d_k, i_k = scan_topk(*args)
    assert scan_topk.last_product == product
    d_r, i_r = scan_topk_reference(*args)
    torch.cuda.synchronize()
    _check_against_plain(*args, d_k, i_k, d_r, i_r)
    assert torch.equal(i_k.sort(1).values, i_r.sort(1).values)


# ---- kernel A past k = 256 (pools wider than 512 entries) ----


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,dtype,metric,mask_frac",
    [(257, torch.bfloat16, "l2", 0.3), (257, torch.float32, "dot", 0.0),
     (1000, torch.bfloat16, "cos", 0.0), (1000, torch.float32, "l2", 0.2),
     (4096, torch.bfloat16, "l2", 0.1), (4096, torch.float32, "cos", 0.0),
     (4096, torch.bfloat16, "dot", 0.0),
     # k = N: every row is in the answer (with a mask, the eligible ones and
     # then (+inf, -1)).
     (20_000, torch.bfloat16, "dot", 0.0), (20_000, torch.float32, "l2", 0.5)],
)
def test_kernel_wide_pool_matches_plain_version(cuda, k, dtype, metric, mask_frac):
    r = np.random.default_rng(k + int(100 * mask_frac))
    b, n, d = 130, 20_000, 64
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
    _check_against_plain(*args, d_k, i_k, d_r, i_r)
    if k == n:
        assert torch.equal(i_k.sort(1).values, i_r.sort(1).values)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order,n,k", [("random", 700, 600), ("nearing", 3000, 600),
                                       ("nearing", 5000, 4096)])
def test_kernel_wide_merges_while_lists_fill(cuda, dtype, order, n, k):
    """As the test above past k = 256: with rows that come nearer the
    queries tile by tile, every candidate ranks before every pooled entry,
    so every compaction keeps the newest rows; with random rows and k near
    N, pools fill over many compactions."""
    r = np.random.default_rng(n + k)
    q = r.standard_normal((70, 128)).astype(np.float32)
    x = r.standard_normal((n, 128)).astype(np.float32)
    if order == "nearing":
        q *= 0.01
        x *= (np.linspace(40, 1, n) / np.linalg.norm(x, axis=1)).astype(np.float32)[:, None]
    q, x = torch.from_numpy(q).to(cuda), torch.from_numpy(x).to(cuda)
    xn = (x * x).sum(1)
    args = (q, x.to(dtype), xn, k, "l2", None)
    d_k, i_k = scan_topk(*args)
    d_r, i_r = scan_topk_reference(*args)
    torch.cuda.synchronize()
    _check_against_plain(*args, d_k, i_k, d_r, i_r)
    assert torch.equal(i_k.sort(1).values, i_r.sort(1).values)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_wide_merges_splits_when_one_split_holds_the_whole_list(cuda, dtype):
    """As the test of the same name at k = 256, at k = 1000 over 200,000
    rows: one split's pool holds every row of the answer."""
    from vecgo_tpu_torch.kernels import _build
    from vecgo_tpu_torch.ops import scan_topk as st

    r = np.random.default_rng(1000)
    x = r.standard_normal((200_000, 128)).astype(np.float32)
    x[1200:] += 100.0
    q = torch.from_numpy(r.standard_normal((64, 128)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(x).to(cuda)
    xn = (x * x).sum(1)
    args = (q, x.to(dtype), xn, 1000, "l2", None)
    plan = st._plan(_build.library(), q.device, int(dtype == torch.bfloat16), 128, 1000)
    splits, rows_per_split = st.split_plan(64, 200_000, plan.tq, plan.bps * plan.sms, plan.pool,
                                           plan.tn, plan.min_tiles, plan.max_splits)
    assert splits > 1 and rows_per_split >= 1200
    d_k, i_k = scan_topk(*args)
    d_r, i_r = scan_topk_reference(*args)
    torch.cuda.synchronize()
    _check_against_plain(*args, d_k, i_k, d_r, i_r)
    assert bool((i_k < 1200).all())
    assert torch.equal(i_k.sort(1).values, i_r.sort(1).values)


# The selection (pools, at every k) in each product: (product, B, N, d, k,
# table type, metric, share of rows kept, rows).
# "dup": 37 distinct rows repeated, so exact ties straddle every threshold;
# "nonfinite": NaN and inf rows, never listed. N below one split's minimum
# runs one split; k = N and k > N end in (+inf, -1) past the eligible rows.
WIDE_CASES = [
    ("short", 130, 20_000, 64, 257, torch.bfloat16, "l2", 0.1, "random"),
    ("short", 70, 3000, 128, 1000, torch.bfloat16, "l2", 0.9, "dup"),
    # Pools past 1,024 at d <= 128: the tile product (the plan's rule).
    ("tile", 70, 9000, 128, 4096, torch.bfloat16, "dot", 1.0, "nonfinite"),
    ("tile", 40, 3000, 64, 3000, torch.bfloat16, "l2", 1.0, "random"),
    ("tile", 40, 2000, 64, 2500, torch.bfloat16, "cos", 0.9, "random"),
    ("short", 40, 1024, 64, 1024, torch.bfloat16, "cos", 0.9, "random"),
    ("short", 100, 50_000, 128, 1000, torch.bfloat16, "l2", 1.0, "random"),
    # d not a multiple of 8: the tile product.
    ("tile", 130, 20_000, 100, 257, torch.bfloat16, "l2", 0.1, "random"),
    ("tile", 70, 3000, 100, 1000, torch.bfloat16, "dot", 0.9, "dup"),
    ("tile", 70, 9000, 100, 4096, torch.bfloat16, "l2", 1.0, "nonfinite"),
    ("deep", 130, 20_000, 1536, 73, torch.bfloat16, "l2", 1.0, "random"),
    ("deep", 130, 40_000, 1536, 100, torch.bfloat16, "cos", 0.9, "dup"),
    ("deep", 64, 6000, 1536, 1000, torch.bfloat16, "l2", 0.1, "nonfinite"),
    ("f32", 200, 8192, 128, 300, torch.float32, "l2", 1.0, "random"),
    ("f32", 100, 20_000, 768, 300, torch.float32, "cos", 0.9, "dup"),
    ("f32", 60, 1500, 128, 300, torch.float32, "dot", 0.1, "nonfinite"),
    ("f32", 200, 8192, 128, 1000, torch.float32, "l2", 1.0, "random"),
    ("f32-fma", 200, 8192, 126, 1000, torch.float32, "l2", 1.0, "random"),
    ("f32-fma", 60, 1500, 126, 1000, torch.float32, "dot", 0.1, "nonfinite"),
    # Small k, whose pools hold k + 128 entries (the pools' least room).
    ("short", 130, 20_000, 128, 18, torch.bfloat16, "l2", 0.9, "random"),
    ("short", 70, 40_000, 128, 256, torch.bfloat16, "dot", 1.0, "dup"),
    ("short", 130, 20_000, 256, 100, torch.bfloat16, "cos", 0.9, "nonfinite"),
    ("tile", 130, 20_000, 100, 18, torch.bfloat16, "l2", 0.9, "random"),
    ("deep", 130, 20_000, 1536, 36, torch.bfloat16, "cos", 1.0, "random"),
    ("f32", 300, 8192, 128, 74, torch.float32, "l2", 0.7, "dup"),
    ("f32", 60, 1500, 128, 10, torch.float32, "dot", 0.1, "nonfinite"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("product,b,n,d,k,dtype,metric,keep,rows", WIDE_CASES)
def test_kernel_wide_shape_in_each_product(cuda, product, b, n, d, k, dtype, metric, keep,
                                           rows):
    """The selection (pools, radix compaction, the finishing kernel) against
    the plain version in the short, tile, deep and f32 products: masks keeping
    10% and 90% of rows, exact ties, non-finite rows, one split and several,
    k = N and k > N."""
    from vecgo_tpu_torch.kernels import _build
    from vecgo_tpu_torch.ops import scan_topk as st

    r = np.random.default_rng(n + k + d)
    base = r.standard_normal((37 if rows == "dup" else n, d)).astype(np.float32)
    x = base[np.arange(n) % len(base)]
    q = r.standard_normal((b, d)).astype(np.float32)
    if metric == "cos":
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    if rows == "nonfinite":
        x[::97] = np.nan
        x[5::101] = np.inf
    q, x = torch.from_numpy(q).to(cuda), torch.from_numpy(x).to(cuda)
    mask = torch.from_numpy(r.random(n) < keep).to(cuda) if keep < 1 else None
    xn = (x * x).sum(1)
    args = (q, x.to(dtype), xn, k, metric, mask)
    before = st.scan_topk.launches
    d_k, i_k = st.scan_topk(*args)
    assert st.scan_topk.last_product == product
    assert st.scan_topk.launches == before + 1
    d_r, i_r = scan_topk_reference(*args)
    torch.cuda.synchronize()
    _check_against_plain(*args, d_k, i_k, d_r, i_r)
    if rows == "nonfinite":
        assert not bool(((i_k % 97 == 0) | (i_k % 101 == 5)).any())
    if rows == "dup" or k >= n:
        assert torch.equal(i_k.sort(1).values, i_r.sort(1).values)
    plan = st._plan(_build.library(), cuda, int(dtype == torch.bfloat16), d, k)
    assert plan.pool >= k + 64


@pytest.mark.cuda
def test_kernel_never_runs_plain_version_on_card(cuda, monkeypatch):
    from vecgo_tpu_torch.ops import scan_topk as st

    def boom(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(st, "scan_topk_reference", boom)
    q = torch.zeros(4, 8, device=cuda)
    x = torch.ones(100, 8, device=cuda)
    d_k, i_k = st.scan_topk(q, x, (x * x).sum(1), 3)
    torch.cuda.synchronize()
    assert i_k.tolist() == [[0, 1, 2]] * 4


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
    from vecgo_tpu_torch.metadata import eq

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
     (64, 10, 40, 18, 64, 16, 2, False),  # d not a multiple of 4
     # kk past 32: two list entries a lane.
     (300, 40, 100, 16, 37, 33, 3, False),
     (64, 40, 200, 32, 8, 64, 2, False),  # at most 8 queries a block
     (200, 24, 256, 768, 45, 48, 4, True),
     (4096, 256, 1024, 128, 96, 64, 16, True),
     # Past kk 64: pooled survivors, at the serving shapes and kk = S.
     (4096, 3008, 1024, 128, 32, 96, 4, False),
     (4096, 256, 1024, 128, 96, 256, 16, True),
     (300, 40, 100, 16, 37, 65, 3, True),
     (300, 40, 100, 16, 37, 100, 3, False)],
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


def _coded_case(cuda, case):
    """Inputs for the redesign's edge cases: (args, kk, expected live pairs
    of cluster 0 or None). "CASE@KK" is the same case at kk KK ("S": kk =
    S), past the 64-entry lists where KK > 64."""
    from vecgo_tpu_torch.ops import ivf as ivf_ops

    case, _, kk_at = case.partition("@")
    if case.startswith("skew"):
        # Cluster 0 probed by n queries: past the old 8-slot tiles, the m16
        # query tiles, and (n >= 64) the 64-slot query groups; 180 > qcap.
        # "skewN_kkM": the same at kk M (two list entries a lane past 32).
        n, _, kk = case[4:].partition("_kk")
        n, qcap, kk = int(n), 150, int(kk or 16)
        b, k, s, d = 200, 12, 300, 128
    elif case == "kk_eq_s":
        n, qcap, b, k, s, d, kk = 0, 40, 120, 10, 32, 64, 32
    elif case == "kk_eq_s64":
        n, qcap, b, k, s, d, kk = 0, 40, 120, 10, 64, 64, 64
    elif case == "masked_stages":
        n, qcap, b, k, s, d, kk = 20, 32, 100, 6, 1024, 128, 16
    elif case.startswith("d"):
        d = int(case[1:])
        n, qcap, b, k, s, kk = 20, 64, 150, 8, 200, 8
    elif case in ("s37", "s101", "unaligned"):  # off the bulk-copy path: S % 4, misaligned
        n, qcap, b, k, d, kk = 20, 32, 100, 6, 32, 16
        s = {"s37": 37, "s101": 101}.get(case, 200)
    else:  # 20 probes, qcap 96, 80% of the slots kept
        n, qcap, b, k, s, d, kk = 0, 96, 1024, 256, 512, 128, 8
    r = np.random.default_rng(sum(map(ord, case)))
    n_probe = 20 if case == "probes20" else 2
    probes = np.stack([r.choice(np.arange(1, k), n_probe, replace=False) for _ in range(b)])
    probes[:n, 0] = 0
    q = torch.from_numpy(r.standard_normal((b, d)).astype(np.float32)).to(cuda)
    cent = torch.from_numpy(r.standard_normal((k, d)).astype(np.float32)).to(cuda)
    codes = torch.from_numpy(r.integers(-127, 128, (k, s, d)).astype(np.int8)).to(cuda)
    scale = torch.from_numpy((0.005 + 0.01 * r.random(k)).astype(np.float32)).to(cuda)
    bn = torch.from_numpy((r.random((k, s)) * 4 * d * 0.01).astype(np.float32)).to(cuda)
    if case == "masked_stages":
        # Cluster 0 masked over whole 64-row units (rows 0-191, 320-767), not all.
        bn[0, :192] = float("inf")
        bn[0, 320:768] = float("inf")
    if case == "probes20":
        bn[torch.from_numpy(r.random((k, s)) >= 0.8).to(cuda)] = float("inf")
    if case == "unaligned":  # views one element into larger buffers
        cbuf = torch.empty(codes.numel() + 1, dtype=torch.int8, device=cuda)
        cbuf[1:] = codes.reshape(-1)
        codes = cbuf[1:].view(k, s, d)
        bbuf = torch.empty(bn.numel() + 1, dtype=torch.float32, device=cuda)
        bbuf[1:] = bn.reshape(-1)
        bn = bbuf[1:].view(k, s)
        assert codes.data_ptr() % 16 and bn.data_ptr() % 16
    qtab, _ = ivf_ops._invert_probes(torch.from_numpy(probes).to(cuda), k, qcap)
    if kk_at:
        kk = s if kk_at == "S" else int(kk_at)
    return (q, qtab, codes, bn, scale, cent), kk, min(n, qcap) if n else None


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["skew9", "skew17", "skew33", "skew64", "skew150", "skew180",
                                  "kk_eq_s", "masked_stages", "d100", "d2048", "probes20",
                                  "s37", "unaligned", "skew9_kk64", "skew64_kk48",
                                  "skew150_kk64", "kk_eq_s64"])
def test_coded_kernel_redesign_edges(cuda, case):
    """Shapes where the redesigned kernel changes course: query tiles and
    query groups of one heavily probed cluster, kk = S, whole masked units,
    d off the 16-byte copies and at the 2048 limit, 20 probes at qcap 96,
    and the element-load path (S not a multiple of 4, misaligned tensors)."""
    from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan, coded_group_scan_reference

    args, kk, hot = _coded_case(cuda, case)
    d_k, i_k = coded_group_scan(*args, kk)
    d_r, i_r = coded_group_scan_reference(*args, kk)
    torch.cuda.synchronize()
    _check_coded(args, d_k, i_k, d_r, i_r)
    if hot is not None:
        assert int((args[1][0] < args[0].shape[0]).sum()) == hot
        assert bool(torch.isfinite(d_k[0, :hot]).all())
    if case == "masked_stages":
        live = args[1][0] < args[0].shape[0]
        cols = i_k[0][live]
        assert bool((((cols >= 192) & (cols < 320)) | (cols >= 768)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["skew9@65", "skew64@96", "skew150@128", "skew180@S",
                                  "masked_stages@96", "masked_stages@S", "d100@96",
                                  "d2048@128", "probes20@96", "s101@S", "s101@65",
                                  "unaligned@128"])
def test_coded_kernel_pooled_shape_edges(cuda, case):
    """Kernel B past kk 64 (the pooled shape: each (cluster, query slot)'s
    survivors in a global pool, compacted by radix selection, then a
    finishing kernel) on the redesign's edge cases: skewed clusters, kk = S,
    whole masked units, d 100 and 2048, 20 probes at qcap 96 under a filter,
    and the element-load path (S 101, not a multiple of 4; misaligned
    tensors)."""
    from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan, coded_group_scan_reference

    args, kk, hot = _coded_case(cuda, case)
    assert 64 < kk <= args[2].shape[1]
    before = coded_group_scan.launches
    d_k, i_k = coded_group_scan(*args, kk)
    d_r, i_r = coded_group_scan_reference(*args, kk)
    torch.cuda.synchronize()
    assert coded_group_scan.launches == before + 1
    _check_coded(args, d_k, i_k, d_r, i_r)
    if hot is not None:
        assert bool(torch.isfinite(d_k[0, :hot, 0]).all())
    if kk == args[2].shape[1]:  # every valid slot of a probed cluster, in order
        live = (args[1] < args[0].shape[0])[:, :, None]
        valid = torch.isfinite(args[3])[:, None, :].expand_as(d_k)
        assert torch.equal(torch.isfinite(d_k).sum(-1)[live[..., 0]],
                           valid.sum(-1)[live[..., 0]])


@pytest.mark.cuda
def test_ivf_scan_on_card_makes_no_host_sync(cuda):
    from vecgo_tpu_torch.ops import ivf as ivf_ops

    r = np.random.default_rng(9)
    x = r.standard_normal((4000, 32)).astype(np.float32)
    members = np.full((16, 512), -1, np.int32)
    members[np.arange(4000) % 16, np.arange(4000) // 16] = np.arange(4000)
    t = ivf_ops.device_table_coded(members, torch.from_numpy(x).to(cuda))
    q = torch.from_numpy(x[:300] + 0.01).to(cuda)
    mflat = ivf_ops.slot_mask_from_rows(t, torch.from_numpy(r.random(4000) < 0.8).to(cuda))
    want = ivf_ops.ivf_scan(q, t, n_probe=4, kk=8, mask_flat=mflat)  # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ivf_ops.ivf_scan(q, t, n_probe=4, kk=8, mask_flat=mflat)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert bool((got[1] >= 0).any(1).all())


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
        (q, qtab, codes, bn, scale, cent, 65),
        (q, qtab, codes[:, :4].contiguous(), bn, scale, cent, 8),  # kk > S
        (q, qtab, codes, bn, scale, cent.T.contiguous().T, 8),
    ]
    # d = 8192: a 16-query tile of bf16 residuals passes the card's shared memory.
    wide = _coded_inputs(cuda, 16, 4, 32, 8192, 16, 2, False, 4)
    bad.append((*wide, 8))
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
    from vecgo_tpu_torch.metadata import isin
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


def _coded_corpus(kind, n=20_000, d=64, seed=90):
    from vecgo_tpu_torch import quantization as Q

    r = np.random.default_rng(seed)
    cent = r.standard_normal((50, d)).astype(np.float32)
    x = (cent[r.integers(0, 50, n)] + 0.3 * r.standard_normal((n, d))).astype(np.float32)
    q = (cent[r.integers(0, 50, 70)] + 0.3 * r.standard_normal((70, d))).astype(np.float32)
    quant = Q.create(kind, device="cuda", dim=d,
                     **({"m": 8} if kind in ("pq", "opq") else {}),
                     **({"opq_iters": 2} if kind == "opq" else {}))
    quant.train(x)
    return x, q, quant, quant.encode(x)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "dot", "cosine"])
@pytest.mark.parametrize("kind", ["sq8", "int4", "pq", "opq", "bq", "rabitq"])
def test_block_scanner_on_card_matches_score_matrix(cuda, kind, metric):
    """The segments' scan route on the card (`scan_topk` on a transiently
    decoded bf16 block where the quantizer's score has its form) against
    the top-k of the plain score matrix, and against the same scan on the
    CPU. Tolerance: REL of |q|^2 + |xhat|^2 (the same exact bf16 products,
    summed in another order)."""
    from vecgo_tpu_torch.index.common import enc_tensor
    from vecgo_tpu_torch.model import Metric
    from vecgo_tpu_torch.ops import topk as T

    x, q, quant, enc = _coded_corpus(kind)
    m = Metric(metric)
    mask_np = np.random.default_rng(91).random(len(x)) < 0.5
    out = {}
    for dev in (cuda, torch.device("cpu")):
        e = {k: enc_tensor(v, dev) for k, v in enc.items()}
        qd = torch.from_numpy(q).to(dev)
        before = scan_topk.launches
        d, i = T.blockwise_topk_scored(qd, e, len(x), 20, T.BlockScanner(quant, m),
                                       mask=torch.from_numpy(mask_np).to(dev), block_rows=6000)
        routed = quant.scan_form(qd, m) is not None
        if dev.type == "cuda":
            assert (scan_topk.launches - before == 4) == routed  # 4 blocks, one launch each
            sc = torch.where(torch.from_numpy(mask_np).to(dev)[None, :],
                             quant.score(qd, e, m), torch.inf)
            d_ref, _ = torch.topk(sc, 20, dim=1, largest=False)
            recon = quant.decode(enc)
            tol = REL * (float((q * q).sum(1).max() + (recon * recon).sum(1).max())
                         if metric != "cosine" else 2.0)
            assert float((d - d_ref).abs().max()) <= tol
            assert float((sc.gather(1, i) - d).abs().max()) <= tol
        assert mask_np[i.cpu().numpy()].all()
        out[dev.type] = d.cpu()
    # Card against CPU: the same sums in another order, except OPQ, whose
    # rotated query (an f32 product, rounded differently per device) is then
    # rounded to bf16: one flipped bf16 rounding moves a score by 2^-8 of it.
    cross = tol if kind != "opq" else 2.0**-8 * tol / REL
    assert float((out["cuda"] - out["cpu"]).abs().max()) <= cross


@pytest.mark.cuda
def test_block_scanner_on_card_serves_a_pool_over_256(cuda):
    """A pool wider than 256 goes through `scan_topk`'s wide shape on the
    card (one launch a block) and agrees with the top-k of the plain score
    matrix, and with the same scan on the CPU."""
    from vecgo_tpu_torch.index.common import enc_tensor
    from vecgo_tpu_torch.model import Metric
    from vecgo_tpu_torch.ops import topk as T

    x, q, quant, enc = _coded_corpus("sq8")
    scanner = T.BlockScanner(quant, Metric.L2)
    e = {k: enc_tensor(v, cuda) for k, v in enc.items()}
    qd = torch.from_numpy(q).to(cuda)
    before = scan_topk.launches
    d, i = T.blockwise_topk_scored(qd, e, len(x), 300, scanner, block_rows=6000)
    assert scan_topk.launches - before == 4
    sc = quant.score(qd, e, Metric.L2)
    d_ref, _ = torch.topk(sc, 300, dim=1, largest=False)
    recon = quant.decode(enc)
    tol = REL * float((q * q).sum(1).max() + (recon * recon).sum(1).max())
    assert float((d - d_ref).abs().max()) <= tol
    assert float((sc.gather(1, i) - d).abs().max()) <= tol
    cpu = {k: enc_tensor(v, "cpu") for k, v in enc.items()}
    d_c, _ = T.blockwise_topk_scored(torch.from_numpy(q), cpu, len(x), 300, scanner,
                                     block_rows=6000)
    assert float((d.cpu() - d_c).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sq8", "pq", "rabitq"])
def test_streaming_on_card_equals_resident_scan(cuda, kind):
    """Pinned staging and the copy stream change nothing: the streamed scan
    returns the resident blockwise scan's rows, with a short tail block,
    from read-only host arrays, masked and over a row range; and its peak
    device memory does not grow with the number of blocks."""
    from vecgo_tpu_torch.index.common import enc_tensor
    from vecgo_tpu_torch.model import Metric
    from vecgo_tpu_torch.ops import topk as T

    x, q, quant, enc = _coded_corpus(kind, n=50_000)
    for a in enc.values():
        a.setflags(write=False)
    qd = torch.from_numpy(q).to(cuda)
    e = {k: enc_tensor(v, cuda) for k, v in enc.items()}
    scanner = T.BlockScanner(quant, Metric.L2)
    mask = torch.from_numpy(np.random.default_rng(92).random(len(x)) < 0.4).to(cuda)
    for m, rows in ((None, None), (mask, None), (mask, (7_000, 31_111))):
        d_b, r_b = T.blockwise_topk_scored(qd, e, len(x), 30, scanner, mask=m, block_rows=4096,
                                           rows=rows)
        for _ in range(2):  # the second pass reuses cached pinned buffers
            d_s, r_s = T.streaming_topk_scored(qd, enc, len(x), 30, scanner, mask=m,
                                               block_rows=4096, rows=rows)
            assert torch.equal(r_s, r_b)
            assert float((d_s - d_b).abs().max()) <= 1e-5
    peaks = []
    for n_rows in (8192, 50_000):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        T.streaming_topk_scored(qd, {k: v[:n_rows] for k, v in enc.items()}, n_rows, 30, scanner,
                                block_rows=4096)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
    assert peaks[1] <= peaks[0] + (1 << 20), peaks


@pytest.mark.cuda
def test_quantized_and_streamed_engine_on_card(cuda):
    """quantizer="sq8" with flat IVF at flush, and the same rows streamed
    under a device budget over both transports: the card's answers equal the
    CPU engine's, the scans launch the kernel, and the quantized device state
    takes device_bytes()."""
    import vecgo_tpu_torch as vg

    r = np.random.default_rng(93)
    cent = r.standard_normal((40, 32)).astype(np.float32)
    x = (cent[r.integers(0, 40, 30_000)] + 0.3 * r.standard_normal((30_000, 32))
         ).astype(np.float32)
    q = (cent[r.integers(0, 40, 50)] + 0.3 * r.standard_normal((50, 32))).astype(np.float32)
    got = {}
    for device in ("cuda", "cpu"):
        opts = dict(dim=32, device=device, flush_threshold=10**9)
        db = vg.Open(vg.Memory(), vg.Create(quantizer="sq8", flush_ivf_partitions=True,
                                            ivf_rows_per_partition=3000, **opts))
        db.insert_batch(x)
        db.commit()
        before = scan_topk.launches
        got[device, "sq8"] = db.search_arrays(q, k=10, refine_factor=5)[0]
        got[device, "probed"] = db.search_arrays(q, k=10, refine_factor=5, nprobes=10)[0]
        seg = db.engine._segments[0].segment
        if device == "cuda":
            assert scan_topk.launches > before
            held = sum(t.numel() * t.element_size() for t in seg._dev.values())
            assert held == seg.device_bytes() and all(t.is_cuda for t in seg._dev.values())
        db.close()
        for transport in ("sq8", "pq"):
            db = vg.Open(vg.Memory(), vg.Create(hbm_budget_bytes=4096,
                                                stream_transport=transport, **opts))
            db.insert_batch(x)
            db.commit()
            before = scan_topk.launches
            got[device, transport + "-stream"] = db.search_arrays(q, k=10)[0]
            assert db.stats()["hbm"]["resident"] == 0
            assert device == "cpu" or scan_topk.launches > before
            db.close()
    # The IVF partitions and the PQ transport come from a k-means seeded per
    # device, so those two may differ in a few rows; the others are exact.
    for name in ("sq8", "sq8-stream"):
        assert np.array_equal(got["cuda", name], got["cpu", name]), name
    for name in ("probed", "pq-stream"):
        same = np.mean([len(set(a) & set(b)) / 10 for a, b in
                        zip(got["cuda", name], got["cpu", name])])
        assert same >= 0.97, (name, same)


# ---- the cluster cache (graph_cached) and wide pools on the engine paths ----


def _cache_corpus(seed=94, n=6000, d=32, clusters=24, s=1024):
    """Clustered rows with an overlap-2 membership by the two nearest
    centres (distinct probe distances), and queries near the rows."""
    r = np.random.default_rng(seed)
    centers = r.standard_normal((clusters, d)).astype(np.float32)
    x = (centers[r.integers(0, clusters, n)]
         + 0.35 * r.standard_normal((n, d))).astype(np.float32)
    near = np.argsort(((x[:, None] - centers[None]) ** 2).sum(-1), 1)[:, :2]
    members = np.full((clusters, s), -1, np.int32)
    fill = np.zeros(clusters, np.int64)
    for i, c in enumerate(near.reshape(-1)):
        if fill[c] < s:
            members[c, fill[c]] = i // 2
            fill[c] += 1
    q = x[r.choice(n, 96, replace=False)] + 0.05 * r.standard_normal((96, d)).astype(np.float32)
    return x, members, q


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sq8", "pq"])
def test_cluster_cache_on_card_matches_cpu(cuda, kind):
    """The cache on the card (pinned staging, one upload a batch, in-place
    `index_copy_`, the PQ decode at admission, kernel B over the cache
    tensors) against the same cache on the CPU, over three batches that
    churn a cache of 8 clusters: the same LRU counts batch for batch, the
    same rows up to ties, distances within 1e-4 of |q-c|^2 + |x^-c|^2."""
    from vecgo_tpu_torch.ops import ivf_cache as IC
    from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan

    x, members, q = _cache_corpus()
    h = (IC._encode_host(members, x) if kind == "sq8"
         else IC._encode_host_pq(members, x, m=8, device="cpu"))
    caches = {dev.type: IC.ClusterCachedTable(host=IC.MemHostTable(h), cache_clusters=8,
                                              device=dev)
              for dev in (torch.device("cpu"), cuda)}
    for lo in (0, 32, 0):
        qb = q[lo : lo + 32]
        out = {}
        for name, cc in caches.items():
            before = coded_group_scan.launches
            d, rows = cc.probe_and_scan(qb, n_probe=4, kk=16)
            assert coded_group_scan.launches - before == (name == "cuda")
            out[name] = (d.cpu().numpy(), rows.cpu().numpy())
        assert caches["cuda"].stats == caches["cpu"].stats
        (d_c, r_c), (d_g, r_g) = out["cpu"], out["cuda"]
        assert np.array_equal(np.isfinite(d_g), np.isfinite(d_c))
        same = sum(len(set(a[a >= 0]) & set(c[c >= 0])) for a, c in zip(r_g, r_c))
        assert same >= 0.99 * sum(len(set(c[c >= 0])) for c in r_c)
        fin = np.isfinite(d_c)
        np.testing.assert_allclose(np.sort(d_g, 1)[fin], np.sort(d_c, 1)[fin], rtol=1e-4,
                                   atol=1e-3)
    cc = caches["cuda"]
    assert cc.stats["misses"] > 0 and cc.stats["hits"] > 0
    held = sum(t.numel() * t.element_size() for t in
               (cc.codes_c, cc.bn_c, cc.rows_c, cc.scale_c, cc.cent_c, cc.cent_dev,
                cc.cnorm2_dev))
    assert held == cc.device_bytes()


def _graph_db(device, backend, n=20_000, seed=6, **kw):
    import vecgo_tpu_torch as vg

    r = np.random.default_rng(seed)
    centers = r.standard_normal((64, 32)).astype(np.float32)
    x = (centers[r.integers(0, 64, n)] + 0.35 * r.standard_normal((n, 32))).astype(np.float32)
    db = vg.Open(backend, vg.Create(dim=32, graph_threshold=8192, device=device, **kw))
    ids = np.asarray(db.insert_batch(x))
    db.commit()
    db.compact([h.seg_id for h in db.engine._segments])
    return db, x, ids


@pytest.mark.cuda
@pytest.mark.parametrize("store_codes", [False, "sq8", "pq"])
def test_engine_graph_cached_on_card(cuda, store_codes):
    """A graph segment reopened under a budget between cache_bytes() and
    device_bytes() plans graph_cached on the card, serves through kernel B
    over the cache, and holds recall; with persisted codes the reopen is
    lazy and the vectors are never loaded (128 queries: the rerank's rows
    stay under half the segment's, past which it reads the whole section
    by design)."""
    import vecgo_tpu_torch as vg
    from vecgo_tpu_torch.engine import search as S
    from vecgo_tpu_torch.index.vamana import VamanaSegment
    from vecgo_tpu_torch.model import SearchOptions
    from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan

    backend = vg.Memory()
    db, x, ids = _graph_db("cuda", backend, store_codes=store_codes)
    seg = db.engine._segments[0].segment
    assert type(seg) is VamanaSegment
    budget = (seg.cache_bytes() + seg.device_bytes()) // 2
    db.close()
    db = vg.Open(backend, vg.Create(dim=0, hbm_budget_bytes=budget, device="cuda"))
    e = db.engine
    snap = e.snapshot()
    try:
        plan = S._plan_snapshot(snap, SearchOptions(k=10), e.options, e._device_budget)
    finally:
        snap.release()
    assert [s.kind for s in plan.sources] == ["graph_cached"]
    seg = e._segments[0].segment
    q = x[:128] + 0.01
    before = coded_group_scan.launches
    got, _ = db.search_arrays(q, k=10)
    assert coded_group_scan.launches > before
    assert seg._ccache.device.type == "cuda" and seg._ccache.codes_c.is_cuda
    assert seg._ccache.device_bytes() <= seg.cache_bytes()
    if store_codes:
        assert seg._vectors_arr is None
    d2 = ((q[:, None] - x[None]) ** 2).sum(-1)
    want = ids[np.argsort(d2, 1)[:, :10]]
    rec = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(got, want)])
    assert rec >= 0.85, rec  # the lower of tests/test_ivf_cache.py's floors
    db.close()


@pytest.mark.cuda
def test_engine_wide_pools_on_card(cuda):
    """Every engine path that pools past 256 serves on the card through
    `scan_topk`'s wide shape and returns the CPU engine's ids: the flat
    segment at k = 300 (pool 308), under churn (the margin), with a filter
    at 10% (compact-gather) and at 80% (the masked scan), a quantized
    segment at k * refine_factor = 600, and the PQ stream at fetch 100
    (pool 400)."""
    import vecgo_tpu_torch as vg
    from vecgo_tpu_torch.metadata import isin

    r = np.random.default_rng(95)
    cent = r.standard_normal((40, 32)).astype(np.float32)
    x = (cent[r.integers(0, 40, 30_000)] + 0.3 * r.standard_normal((30_000, 32))
         ).astype(np.float32)
    u = r.integers(0, 100, len(x))
    q = (cent[r.integers(0, 40, 40)] + 0.3 * r.standard_normal((40, 32))).astype(np.float32)
    got = {}
    for device in ("cuda", "cpu"):
        opts = dict(dim=32, device=device, flush_threshold=10**9)
        for name, kw in (("flat", {}), ("sq8", dict(quantizer="sq8")),
                         ("pq-stream", dict(hbm_budget_bytes=4096, stream_transport="pq"))):
            db = vg.Open(vg.Memory(), vg.Create(**kw, **opts))
            ids = db.insert_batch(x[:25_000], [{"u": int(v)} for v in u[:25_000]])
            db.commit()
            before = scan_topk.launches
            if name == "flat":
                got[device, "k300"] = db.search_arrays(q, k=300)[0]
                got[device, "sel10"] = db.search_arrays(q, k=300, filter=isin("u", list(range(10))))[0]
                got[device, "sel80"] = db.search_arrays(q, k=300, filter=isin("u", list(range(80))))[0]
                db.insert_batch(x[25_000:], [{"u": int(v)} for v in u[25_000:]])
                for i in ids[::97]:
                    db.delete(i)
                got[device, "churn"] = db.search_arrays(q, k=300)[0]
            elif name == "sq8":
                got[device, name] = db.search_arrays(q, k=200, refine_factor=3)[0]
            else:
                got[device, name] = db.search_arrays(q, k=100)[0]
            assert device == "cpu" or scan_topk.launches > before
            db.close()
    for key in ("k300", "sel10", "sel80", "churn", "sq8", "pq-stream"):
        a, b = got["cuda", key], got["cpu", key]
        assert a.shape == b.shape and (a >= 0).all(), key
        same = np.mean([len(set(s) & set(t)) / len(t) for s, t in zip(a, b)])
        # bf16 pools, exact rerank: rows differ only at ties of the last rank.
        assert same >= 0.995, (key, same)


def _clustered_rows(n, d, clusters, seed):
    r = np.random.default_rng(seed)
    centers = r.standard_normal((clusters, d)).astype(np.float32)
    return (centers[r.integers(0, clusters, n)]
            + 0.35 * r.standard_normal((n, d))).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["compact", "overlap4"])
def test_coded_kernel_on_compact_and_overlap4_tables(cuda, table):
    """Kernel B at the two new table shapes, against its plain version
    (tolerance as above): the serve_compact table (S' a multiple of 128,
    at most the build's S) at twice the probes, and the beam build's table
    (build_ivf_table: overlap 4, S = ivf_capacity 512)."""
    from vecgo_tpu_torch.index.build_fast import build_graph_clustered
    from vecgo_tpu_torch.ops import ivf as ivf_ops
    from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan, coded_group_scan_reference

    x = _clustered_rows(60_000, 128, 96, seed=13)
    xd = torch.from_numpy(x).to(cuda)
    if table == "compact":
        members = build_graph_clustered(xd, r=16, return_membership=True)[4]
        t = ivf_ops.device_table_coded(members, xd, compact=True)
        assert t.rows.shape[1] % 128 == 0 and t.rows.shape[1] <= members.shape[1]
        n_probe = 8
    else:
        _, members = ivf_ops.build_ivf_table(x, capacity=512, device=cuda)
        t = ivf_ops.device_table_coded(members, xd)
        assert t.rows.shape[1] == 512 and len(np.unique(members[members >= 0])) == len(x)
        n_probe = 16
    assert (t.rows >= 0).sum() >= len(x)
    q = xd[:2048] + 0.01
    k_pad = t.bnorm2.shape[0]
    cd = (q * q).sum(1)[:, None] + t.cnorm2[None, :] - 2.0 * (
        q.to(torch.bfloat16).float() @ t.centroids.to(torch.bfloat16).float().T)
    probes = torch.sort(cd, dim=1, stable=True).indices[:, :n_probe]
    qtab, _ = ivf_ops._invert_probes(probes, k_pad, ivf_ops.default_qcap(2048, n_probe, k_pad))
    args = (q, qtab, t.codes, t.bnorm2, t.scale, t.centroids)
    before = coded_group_scan.launches
    d_k, i_k = coded_group_scan(*args, 16)
    d_r, i_r = coded_group_scan_reference(*args, 16)
    torch.cuda.synchronize()
    assert coded_group_scan.launches == before + 1
    _check_coded(args, d_k, i_k, d_r, i_r)


@pytest.mark.cuda
@pytest.mark.parametrize("serve_compact", [False, True])
def test_engine_beam_build_on_card(cuda, serve_compact):
    """graph_build_mode="beam" compacts on the card (its table from
    build_ivf_table) and serves through kernel B, from the overlap table or
    the one-slot-per-row table, at recall@10 >= 0.95."""
    import vecgo_tpu_torch as vg
    from vecgo_tpu_torch.index.vamana import VamanaSegment
    from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan

    x = _clustered_rows(20_000, 32, 64, seed=6)
    db = vg.Open(vg.Memory(), vg.Create(dim=32, graph_threshold=8192, graph_build_mode="beam",
                                        serve_compact=serve_compact), device="cuda")
    ids = np.asarray(db.insert_batch(x))
    db.commit()
    db.compact([h.seg_id for h in db.engine._segments])
    seg = db.engine._segments[0].segment
    assert type(seg) is VamanaSegment and seg.meta["alpha"] == 1.2
    assert seg.ivf_members.shape[1] == 512
    q = x[:256] + 0.01
    before = coded_group_scan.launches
    got, _ = db.search_arrays(q, k=10)
    assert coded_group_scan.launches > before
    rows = seg.device_state(cuda)["ivfq"].rows
    assert ((rows >= 0).sum() == len(x)) == serve_compact
    d2 = ((q[:, None] - x[None]) ** 2).sum(-1)
    want = ids[np.argsort(d2, 1)[:, :10]]
    rec = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(got, want)])
    assert rec >= 0.95, rec
    db.close()


@pytest.mark.cuda
def test_cached_search_in_chunks_on_card(cuda):
    """A broad batch over an 8-cluster cache on the card: scanned in chunks
    through kernel B with no probe dropped, the ids of the CPU search over
    a cache that holds every cluster (>= 0.99: bf16 products summed in
    another order move near-ties)."""
    from vecgo_tpu_torch.index.vamana import VamanaSegment, VamanaWriter

    x = _clustered_rows(20_000, 32, 64, seed=7)
    w = VamanaWriter(32, device=cuda)
    w.add_batch(x, np.arange(len(x)))
    blob = w.finish()
    small, big = VamanaSegment.open(blob), VamanaSegment.open(blob)
    small.CACHE_CLUSTERS = 8
    q = x[::80]
    _, r_s = small.search_cached(torch.from_numpy(q).to(cuda), 10)
    _, r_b = big.search_cached(torch.from_numpy(q), 10)
    st = small._ccache.stats
    assert st["dropped_probes"] == 0 and st["batches"] > 1 and small._ccache.device.type == "cuda"
    r_s, r_b = r_s.cpu().numpy(), r_b.numpy()
    assert sum(len(set(a) & set(b)) for a, b in zip(r_s, r_b)) >= 0.99 * r_b.size


# ---- BM25 and hybrid search: the dense H-wide sweep through scan_topk ----
# Tolerance: a BM25 score is a sum of <= 16 bf16 weights; both sides add
# the same exact products (0/1 x bf16) in f32, in another order, so scores
# agree within 2e-5 of the score itself and ids agree except where their
# exact (f64) scores tie within that.


def _bm25_like(cuda, b, n, d, seed, nnz_row=12, nnz_query=16, mask_frac=0.1):
    """An [n, d] bf16 table of BM25-like rows (about 12 positive weights a
    row on zipf-drawn columns, drawn from 64 levels so that many scores
    tie bit for bit), multi-hot 0/1 queries of up to 16 columns, a mask."""
    r = np.random.default_rng(seed)
    cols = np.minimum(r.zipf(1.3, (n, nnz_row)) - 1, d - 1)
    levels = (r.random(64) * 3).astype(np.float32)
    x = np.zeros((n, d), np.float32)
    x[np.arange(n)[:, None], cols] = levels[r.integers(0, 64, (n, nnz_row))]
    q = np.zeros((b, d), np.float32)
    for i in range(b):
        q[i, np.minimum(r.zipf(1.3, int(r.integers(1, nnz_query + 1))) - 1, d - 1)] = 1.0
    mask = torch.from_numpy(r.random(n) >= mask_frac).to(cuda)
    return (torch.from_numpy(q).to(cuda), torch.from_numpy(x).to(cuda, torch.bfloat16), mask)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,k", [(300, 6000, 2048, 36), (257, 5000, 4096, 36),
                                     (200, 4000, 2917, 20), (64, 3000, 4096, 256)])
def test_kernel_dot_over_bm25_tables(cuda, b, n, d, k):
    """scan_topk with metric dot over a bf16 table with a mask, on
    multi-hot queries: the device BM25 sweep's shape (H up to 4096, the
    query tile not resident; an unpadded odd width too)."""
    q, x, mask = _bm25_like(cuda, b, n, d, seed=d + k)
    before = scan_topk.launches
    d_k, i_k = scan_topk(q, x, None, k, "dot", mask)
    d_r, i_r = scan_topk_reference(q, x, None, k, "dot", mask)
    torch.cuda.synchronize()
    assert scan_topk.launches == before + 1
    assert torch.equal(torch.isfinite(d_k), torch.isfinite(d_r))
    fin = torch.isfinite(d_r)
    tol = REL * d_r.abs().clamp_min(1.0)
    assert bool(((d_k - d_r).abs() <= tol)[fin].all())
    swapped = (i_k != i_r) & fin
    if swapped.any():
        exact = _exact(q, x.float(), torch.where(swapped, i_k, -1), "dot")
        assert bool(((exact - d_r.double()).abs() <= 2 * tol)[swapped].all())
    assert bool(mask[i_k[fin].long()].all())
    assert int(swapped.sum()) < int(fin.sum())  # ties, not a different answer


# ---- the BM25 sweep as a sparse product: scan_topk_columns ----
# Tolerance: the kernel adds a query's columns in f32 in the order the
# plain version does, so its scores agree with it within 1e-6 of the score
# (bit for bit, but for the sign of a zero), and with the dense function's
# (the multi-hot query through scan_topk's plain version, which sums in
# another order) within the same; ids agree except among exact ties.
REL_COLUMNS = 1e-6


def _bm25_columns(cuda, b, n, h, seed, t=16, mask_frac=0.1, full=False):
    """A BM25-like table (`_bm25_like`'s rows), [b, t] int32 query columns
    (zipf-drawn, a random count of -1 pads, or all t columns with `full`,
    repeats included) and a mask."""
    r = np.random.default_rng(seed)
    _, x, mask = _bm25_like(cuda, 1, n, h, seed, mask_frac=mask_frac)
    cols = np.minimum(r.zipf(1.3, (b, t)) - 1, h - 1).astype(np.int32)
    if not full:
        cols[np.arange(t)[None, :] >= r.integers(1, t + 1, b)[:, None]] = -1
    return torch.from_numpy(cols).to(cuda), x, mask


def _multi_hot_of(cols, h):
    c = cols.long()
    q = torch.zeros((c.shape[0], h), dtype=torch.float32, device=c.device)
    return q.scatter_add_(1, c.clamp_min(0), (c >= 0).float())


def _check_columns(cols, x, mask, got, want):
    (d_k, i_k), (d_r, i_r) = got, want
    assert torch.equal(torch.isfinite(d_k), torch.isfinite(d_r))
    assert torch.equal(i_k < 0, i_r < 0)
    fin = torch.isfinite(d_r)
    assert bool(((d_k - d_r).abs() <= REL_COLUMNS * d_r.abs())[fin].all())
    swapped = (i_k != i_r) & fin
    if swapped.any():  # exact ties only: the two rows score the same
        c = cols.long()

        def exact(rows):
            w = x[rows.clamp_min(0).long()].double()
            g = torch.gather(w, 2, c.clamp_min(0)[:, None, :].expand(-1, rows.shape[1], -1))
            return -torch.where((c >= 0)[:, None, :], g, 0.0).sum(-1)

        e_k, e_r = exact(i_k), exact(i_r)
        assert bool(((e_k - e_r).abs() <= REL_COLUMNS * e_r.abs())[swapped].all())
    if mask is not None:
        assert bool(mask[i_k[fin].long()].all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h,k,case", [
    (300, 6000, 2048, 36, ""), (257, 5000, 4096, 36, ""), (200, 4000, 2917, 20, ""),
    (64, 3000, 4096, 256, ""),
    (300, 5001, 4096, 36, ""),           # N not a multiple of the row tile
    (4200, 2003, 4096, 36, ""),          # B past one query tile, not a multiple of 32
    (4096, 1500, 4096, 36, "full"),      # 16 columns a query: tiles by shared memory
    (96, 3000, 4096, 36, "masked-tile"),  # a wholly masked stretch of rows
    (64, 3000, 4096, 1500, ""),          # k past 1,024
    (128, 2000, 8192, 36, ""), (64, 1000, 16000, 20, ""),  # 2 and 1 rows a stage
    (128, 3000, 4096, 36, "view"),       # rows that start mid-word: ragged ends
])
def test_kernel_columns_over_bm25_tables(cuda, b, n, h, k, case):
    """scan_topk_columns on the card against its plain version and against
    the dense function, at the BM25 tables' shapes and their edges."""
    from vecgo_tpu_torch.ops.scan_topk import scan_topk_columns, scan_topk_columns_reference

    cols, x, mask = _bm25_columns(cuda, b, n, h, seed=h + k + b, full=case == "full")
    if case == "masked-tile":
        mask[64:200] = False
    if case == "view":  # the table one element into its buffer: no 16-byte aligned row
        buf = torch.empty(n * h + 1, dtype=torch.bfloat16, device=cuda)
        buf[1:].view(n, h).copy_(x)
        x = buf[1:].view(n, h)
    before = scan_topk.launches
    got = scan_topk_columns(cols, x, k, mask)
    assert scan_topk.launches == before + 1 and scan_topk.last_product == "columns"
    plain = scan_topk_columns_reference(cols, x, k, mask)
    dense = scan_topk_reference(_multi_hot_of(cols, h), x, None, k, "dot", mask)
    torch.cuda.synchronize()
    _check_columns(cols, x, mask, got, plain)
    _check_columns(cols, x, mask, got, dense)
    assert int((got[1] >= 0).sum()) > 0


@pytest.mark.cuda
def test_kernel_columns_int64_and_without_a_mask(cuda):
    """int64 columns (DeviceBM25's) and no mask give the int32 answer."""
    from vecgo_tpu_torch.ops.scan_topk import scan_topk_columns, scan_topk_columns_reference

    cols, x, _ = _bm25_columns(cuda, 200, 3000, 4096, seed=5)
    got = scan_topk_columns(cols.long(), x, 36)
    torch.cuda.synchronize()
    _check_columns(cols, x, None, got, scan_topk_columns(cols, x, 36))
    _check_columns(cols, x, None, got, scan_topk_columns_reference(cols, x, 36))


def _zipf_texts(r, n, n_words=3000, length=12):
    words = [f"word{i}" for i in range(n_words)]
    return [" ".join(words[min(int(w) - 1, n_words - 1)] for w in r.zipf(1.3, length))
            for _ in range(n)]


def _lexical_corpus(n_docs=20_000, seed=3):
    from vecgo_tpu_torch.lexical.bm25 import BM25Index

    r = np.random.default_rng(seed)
    idx = BM25Index()
    for i, doc in enumerate(_zipf_texts(r, n_docs)):
        idx.add(i + 1, doc + (f" rareterm{i}" if i % 97 == 0 else ""))
    queries = _zipf_texts(r, 500, length=3)
    return idx, queries + ["rareterm97 word1", "rareterm194", "zzz", "",
                           " ".join(f"word{i}" for i in range(30))]


@pytest.mark.cuda
def test_device_bm25_on_card_matches_cpu(cuda, monkeypatch):
    """The same snapshot on the card and on the CPU: the same table bit for
    bit, the sweep through the columns kernel (never a plain version), ids equal
    except among exact-score ties, scores within 1e-5 relative."""
    from vecgo_tpu_torch.lexical.device_bm25 import DeviceBM25
    from vecgo_tpu_torch.ops import scan_topk as st

    idx, queries = _lexical_corpus()
    cpu = DeviceBM25(idx, max_hot_terms=2048, min_df=8, device="cpu")
    ci, cs = cpu.search_batch_arrays(queries, 20)

    def boom(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(st, "scan_topk_reference", boom)
    monkeypatch.setattr(st, "scan_topk_columns_reference", boom)
    dev = DeviceBM25(idx, max_hot_terms=2048, min_df=8, device=cuda)
    assert dev._w.is_cuda and torch.equal(dev._w.cpu(), cpu._w)
    before = scan_topk.launches
    gi, gs = dev.search_batch_arrays(queries, 20)
    assert scan_topk.launches == before + 1 and scan_topk.last_product == "columns"
    np.testing.assert_array_equal(gi < 0, ci < 0)
    np.testing.assert_allclose(gs, cs, rtol=1e-5, atol=0)
    for r in np.nonzero((gi != ci).any(1))[0]:
        for j in np.nonzero(gi[r] != ci[r])[0]:
            tied = cs[r] == cs[r, j]
            assert tied.sum() > 1
            if not tied[-1]:
                assert set(gi[r][tied]) == set(ci[r][tied])


@pytest.mark.cuda
def test_engine_hybrid_batch_on_card_matches_cpu(cuda):
    """hybrid_search_batch on the card (a flat segment, the memtable and a
    device BM25 snapshot) against the CPU engine on the same writes. The
    fusion is host code, so wherever the two halves' lists agree (all but
    bf16 near-ties of the vector pool and exact BM25 ties), the fused ids
    agree and the RRF mass within 1e-12; scan_topk is launched by both
    halves."""
    import vecgo_tpu_torch as vg

    r = np.random.default_rng(8)
    x = r.standard_normal((20_000, 32)).astype(np.float32)
    texts = _zipf_texts(r, len(x))
    texts[123] = "needle " + texts[123]
    q = x[:256] + 0.05
    qtexts = _zipf_texts(r, 255, length=3) + ["needle"]
    out = {}
    for device in ("cuda", "cpu"):
        db = vg.Open(vg.Memory(), vg.Create(dim=32, lexical=True, flush_threshold=10**9,
                                            device=device))
        ids = db.insert_batch(x[:15_000], texts=texts[:15_000])
        db.commit()
        ids += db.insert_batch(x[15_000:], texts=texts[15_000:])
        for i in ids[::101]:
            db.delete(i)
        snap = db.engine.enable_device_lexical(max_hot_terms=1024, min_df=8)
        before = scan_topk.launches
        fused = db.hybrid_search_batch(q, qtexts, k=10)
        assert device == "cpu" or scan_topk.launches >= before + 2
        out[device] = (db.search_arrays(q, k=20)[0], snap.search_batch_arrays(qtexts, 20)[0],
                       *fused)
        db.close()
    (vc, lc, ic, sc), (vd, ld, id_, sd) = out["cpu"], out["cuda"]
    same = (vc == vd).all(1) & (lc == ld).all(1)
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_array_equal(id_[same], ic[same])
    np.testing.assert_allclose(sd[same], sc[same], rtol=0, atol=1e-12)
    assert ids[123] in id_[255] and not np.isin(id_, ids[::101]).any()


# --- the device grid on one card (vecgo_tpu_torch.parallel) ----------------


def _card_grid(dp, shard):
    from vecgo_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(shard=shard, dp=dp, devices=["cuda:0"] * (dp * shard))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_sharded_flat_on_one_card(cuda, metric):
    """ShardedFlat on ["cuda:0"] * 4 at (dp 1, shard 4) and (dp 2, shard 2)
    against the one-device scan of the same rows (kernel A tolerance):
    one scan_topk launch per grid entry, no shard copied (the rows are
    views of the caller's tensor)."""
    from vecgo_tpu_torch.model import Metric
    from vecgo_tpu_torch.ops.topk import blockwise_topk_search
    from vecgo_tpu_torch.parallel.mesh import ShardedFlat

    x = torch.from_numpy(_clustered_rows(100_003, 64, 64, seed=21)).to(cuda)
    q = x[:1001] + 0.01
    mask = torch.arange(len(x), device=cuda) % 9 != 4
    xs = x / x.norm(dim=1, keepdim=True) if metric == "cosine" else x
    xn = (xs * xs).sum(1)
    d_1, i_1 = blockwise_topk_search(q, xs, 10, metric=Metric(metric), x_norms_sq=xn, mask=mask,
                                     x_normalized=True)
    for dp, shard in ((1, 4), (2, 2)):
        sf = ShardedFlat(x, _card_grid(dp, shard), metric=Metric(metric), mask=mask)
        if metric == "l2":
            assert sf._shards[1][sf.mesh.devices[0, 1]][0].untyped_storage().data_ptr() == \
                x.untyped_storage().data_ptr()
        before = scan_topk.launches
        d_g, i_g = sf.search(q, 10)
        torch.cuda.synchronize()
        assert scan_topk.launches - before == dp * shard
        qs = q / q.norm(dim=1, keepdim=True) if metric == "cosine" else q
        _check_against_plain(qs, xs, xn, 10, "l2" if metric == "l2" else "cos", mask,
                             d_g, i_g, d_1, i_1)


@pytest.mark.cuda
def test_sharded_ivf_on_one_card(cuda):
    """ShardedIVF on ["cuda:0"] * 4 over a 60,000-row coded table against
    the same grid on the CPU (kernel B against its plain version): the
    pools' rows equal on >= 0.999 of the entries, one coded_group_scan
    launch per grid entry, the shards' codes views of the table's."""
    from vecgo_tpu_torch.index.build_fast import build_graph_clustered
    from vecgo_tpu_torch.ops import ivf as ivf_ops
    from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan
    from vecgo_tpu_torch.parallel.mesh import ShardedIVF, make_mesh

    x = _clustered_rows(60_000, 128, 96, seed=22)
    xd = torch.from_numpy(x).to(cuda)
    members = build_graph_clustered(xd, r=16, return_membership=True)[4]
    t = ivf_ops.device_table_coded(members, xd)
    q = xd[:2049] + 0.01
    tc = type(t)(*(None if a is None else a.cpu() for a in t))
    want_d, want_r = ShardedIVF(tc, make_mesh(shard=4, devices=["cpu"] * 4)).search(q.cpu(), 8, 16)
    for dp, shard in ((1, 4), (2, 2)):
        siv = ShardedIVF(t, _card_grid(dp, shard))
        dev0 = siv.mesh.devices[0, 0]
        assert siv._shards[1][dev0].codes.untyped_storage().data_ptr() == \
            t.codes.untyped_storage().data_ptr()
        before = coded_group_scan.launches
        d, r = siv.search(q, 8, 16)
        torch.cuda.synchronize()
        assert coded_group_scan.launches - before == dp * shard
        if dp == 1:
            same = (r.cpu() == want_r).float().mean()
            assert float(same) >= 0.999, float(same)
            fin = (r.cpu() == want_r) & (want_d < 1e30)
            scale = float(want_d[fin].max())
            assert float((d.cpu() - want_d).abs()[fin].max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_dryrun_multichip_on_one_card(cuda, capsys):
    """entry.dryrun_multichip(4) on one card: four grid entries on cuda:0,
    both kernels launched."""
    from vecgo_tpu_torch.entry import dryrun_multichip
    from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan

    a, b = scan_topk.launches, coded_group_scan.launches
    dryrun_multichip(4)
    assert scan_topk.launches > a and coded_group_scan.launches > b
    assert "dryrun_multichip OK: mesh={'dp': 2, 'shard': 2}" in capsys.readouterr().out
