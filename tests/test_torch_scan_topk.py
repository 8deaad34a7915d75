"""The port's fused scan + top-k against the JAX package.

`scan_topk` on a CPU tensor runs its plain PyTorch version
(`scan_topk_reference`); it is held against `pallas_l2_topk` (interpret mode,
as tests/test_pallas.py runs it) and against `blockwise_topk_search(exact=True)`.
Tolerances: distances within rtol 1e-5 / atol 1e-4 (JAX's fp32
Precision.HIGH on the CPU against IEEE fp32 sums in another order); ids equal
except where two rows' exact scores tie within that tolerance. The CUDA
kernel itself is compared with the plain version in test_torch_cuda.py,
which skips without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vecgo_tpu.model import Metric
from vecgo_tpu.ops import pallas_scan
from vecgo_tpu.ops import topk as JT
from vecgo_tpu_torch.model import Metric as PMetric
from vecgo_tpu_torch.ops import topk as T
from vecgo_tpu_torch.ops.scan_topk import scan_topk, scan_topk_reference

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4


def _data(b, n, d, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, d)).astype(np.float32),
            r.standard_normal((n, d)).astype(np.float32))


def _exact_scores(q, x, rows, metric, bf16=False):
    """Float64 scores of rows [B, k] (-1 -> inf), in the scan's precision."""
    q, x = q.astype(np.float64), x.astype(np.float64)
    v = x[np.maximum(rows, 0)]
    qn, vn = (q * q).sum(1)[:, None], (v * v).sum(-1)  # norms stay fp32-exact
    if bf16:  # the product takes bf16-rounded operands
        q = torch.from_numpy(q).bfloat16().double().numpy()
        v = torch.from_numpy(v).bfloat16().double().numpy()
    dot = np.einsum("bkd,bd->bk", v, q)
    if metric == "l2":
        s = qn + vn - 2 * dot
    elif metric == "dot":
        s = -dot
    else:
        s = 1 - dot
    return np.where(rows >= 0, s, np.inf)


def assert_same_topk(d_a, i_a, d_b, i_b, q, x, metric, bf16=False):
    d_a, i_a, d_b, i_b = map(np.asarray, (d_a, i_a, d_b, i_b))
    np.testing.assert_allclose(d_a, d_b, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(i_a < 0, i_b < 0)
    diff = i_a != i_b
    if diff.any():  # a swap is allowed only between near-equal scores
        sa = _exact_scores(q, x, np.where(diff, i_a, -1), metric, bf16)
        sb = _exact_scores(q, x, np.where(diff, i_b, -1), metric, bf16)
        fin = np.isfinite(sa)
        np.testing.assert_allclose(sa[fin], sb[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "b,n,d,k,tile_b,tile_n",
    [(13, 777, 32, 5, 8, 256), (32, 3000, 64, 10, 16, 512), (9, 600, 16, 70, 8, 128)],
    ids=["padding", "multi-tile", "k-over-tile"],
)
def test_reference_matches_pallas_l2_topk(b, n, d, k, tile_b, tile_n):
    q, x = _data(b, n, d, seed=n)
    xn = (x * x).sum(1)
    d_j, i_j = pallas_scan.l2_topk(jnp.asarray(q), jnp.asarray(x), k=k,
                                   tile_b=tile_b, tile_n=tile_n)
    d_t, i_t = scan_topk_reference(torch.from_numpy(q), torch.from_numpy(x),
                                   torch.from_numpy(xn), k, "l2")
    assert d_t.dtype == torch.float32 and i_t.dtype == torch.int32
    assert_same_topk(d_t, i_t, d_j, i_j, q, x, "l2")


@pytest.mark.parametrize("metric", ["l2", "dot", "cos"])
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_blockwise_matches_jax_exact(metric, masked, bf16):
    q, x = _data(13, 777, 32, seed=7)
    if metric == "cos":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    mask = np.random.default_rng(8).random(777) < 0.4 if masked else None
    m = Metric.COSINE if metric == "cos" else Metric(metric)
    cd = jnp.bfloat16 if bf16 else None
    d_j, i_j = JT.blockwise_topk_search(
        jnp.asarray(q), jnp.asarray(x), 10, metric=m, block_rows=128,
        mask=None if mask is None else jnp.asarray(mask), compute_dtype=cd,
        x_normalized=True, exact=True,
    )
    d_t, i_t = T.blockwise_topk_search(
        torch.from_numpy(q), torch.from_numpy(x), 10, metric=PMetric(m.value),
        mask=None if mask is None else torch.from_numpy(mask),
        compute_dtype=torch.bfloat16 if bf16 else None, x_normalized=True,
    )
    qn = q / np.linalg.norm(q, axis=1, keepdims=True) if metric == "cos" else q
    assert_same_topk(d_t, i_t, d_j, i_j, qn, x, metric, bf16)
    if masked:
        assert mask[np.asarray(i_t)].all()


def test_ties_go_to_the_lower_row_like_pallas():
    q, x = _data(4, 96, 8, seed=3)
    x = np.concatenate([x, x, x])  # every row appears three times
    xn = (x * x).sum(1)
    _, i_j = pallas_scan.l2_topk(jnp.asarray(q), jnp.asarray(x), k=9, tile_b=8, tile_n=128)
    _, i_t = scan_topk(torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(xn), 9)
    np.testing.assert_array_equal(np.asarray(i_t), np.asarray(i_j))


def test_fewer_eligible_rows_than_k_pad_with_inf():
    q, x = _data(3, 50, 8, seed=4)
    mask = torch.zeros(50, dtype=torch.bool)
    mask[[3, 17, 41]] = True
    d, i = scan_topk(torch.from_numpy(q), torch.from_numpy(x),
                     torch.from_numpy((x * x).sum(1)), 5, "l2", mask)
    assert sorted(i[0, :3].tolist()) == [3, 17, 41]
    assert torch.isinf(d[:, 3:]).all() and (i[:, 3:] == -1).all()


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_overflowing_rows_never_enter_a_list(metric):
    q, x = _data(6, 300, 32, seed=11)
    q = np.abs(q)
    x[[7, 150]] = 3e38  # q.x overflows: dot scores -inf, l2 scores nan
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    xn = (xt * xt).sum(1)
    d, i = scan_topk(qt, xt, xn, 8, metric)
    keep = torch.ones(300, dtype=torch.bool)
    keep[[7, 150]] = False
    d_m, i_m = scan_topk(qt, xt, xn, 8, metric, keep)
    assert torch.isfinite(d).all()
    assert torch.equal(i, i_m) and torch.equal(d, d_m)


def test_cpu_tensors_run_the_plain_version():
    q, x = _data(5, 300, 16, seed=5)
    args = (torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy((x * x).sum(1)), 7)
    before = scan_topk.launches
    got = scan_topk(*args)
    want = scan_topk_reference(*args)
    assert scan_topk.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k", [0, -1])
def test_k_out_of_range_raises(k):
    q, x = _data(2, 10, 4, seed=6)
    with pytest.raises(ValueError):
        scan_topk(torch.from_numpy(q), torch.from_numpy(x),
                  torch.from_numpy((x * x).sum(1)), k)


def test_bad_inputs_raise():
    q, x = _data(2, 10, 4, seed=6)
    qt, xt, xn = torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy((x * x).sum(1))
    with pytest.raises(ValueError):
        scan_topk(qt.double(), xt, xn, 3)
    with pytest.raises(ValueError):
        scan_topk(qt, xt.T, xn, 3)  # dim mismatch
    with pytest.raises(ValueError):
        scan_topk(qt, xt, None, 3, "l2")  # l2 needs norms
    with pytest.raises(ValueError):
        scan_topk(qt, xt, xn, 3, "l2", torch.ones(9, dtype=torch.bool))


@pytest.mark.parametrize("metric", [Metric.L2, Metric.DOT, Metric.COSINE, Metric.HAMMING])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_pairwise_scores_match_jax(metric, bf16):
    from vecgo_tpu.ops import distance as JD
    from vecgo_tpu_torch.ops import distance as TD

    q, x = _data(7, 50, 24, seed=9)
    if metric == Metric.HAMMING:
        q, x = (q > 0).astype(np.float32), (x > 0).astype(np.float32)
    want = JD.pairwise_scores(jnp.asarray(q), jnp.asarray(x), metric, x_normalized=False,
                              compute_dtype=jnp.bfloat16 if bf16 else None)
    got = TD.pairwise_scores(torch.from_numpy(q), torch.from_numpy(x), PMetric(metric.value),
                             x_normalized=False,
                             compute_dtype=torch.bfloat16 if bf16 else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(TD.row_norms_sq(torch.from_numpy(x)).numpy(),
                               np.asarray(JD.row_norms_sq(jnp.asarray(x))), rtol=RTOL)


def test_small_width_selections_match_jax():
    r = np.random.default_rng(10)
    da = np.sort(r.integers(0, 20, (5, 6)).astype(np.float32), 1)  # many ties
    db = np.sort(r.integers(0, 20, (5, 4)).astype(np.float32), 1)
    ia = r.integers(0, 100, (5, 6)).astype(np.int32)
    ib = r.integers(100, 200, (5, 4)).astype(np.int32)
    want = JT.merge_topk_sorted(*map(jnp.asarray, (da, ia, db, ib)), 7)
    got = T.merge_topk_sorted(*map(torch.from_numpy, (da, ia, db, ib)), 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = JT.topk_smallest_with_ids(jnp.asarray(da), jnp.asarray(ia), 4)
    got = T.topk_smallest_with_ids(torch.from_numpy(da), torch.from_numpy(ia), 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _pool_cap(k):
    """The pool entries a (query, split) gets for a list of k, as the
    library's plan returns them (csrc/select_wide.cuh `pool_cap`)."""
    return -(-(k + max(k, 128)) // 32) * 32


@pytest.mark.parametrize("n,k,slots", [(1 << 20, 18, 264), (1 << 20, 82, 264), (8192, 74, 396),
                                       (8192, 82, 396), (65536, 256, 132)])
def test_split_plan_fills_the_card(n, k, slots):
    """4096 queries are 64 query tiles: the rows are split so that every one
    of the card's 132 SMs gets a block, each split keeps its minimum of tiles,
    the finishing kernel's reads stay bounded, and the splits cover the rows
    exactly once."""
    from vecgo_tpu_torch.ops import scan_topk as st

    pool = _pool_cap(k)
    splits, rows = st.split_plan(4096, n, 64, slots, pool)
    assert 64 * splits >= 132
    assert rows % st._TN == 0 and rows >= st._MIN_TILES_PER_SPLIT * st._TN
    assert (splits - 1) * rows < n <= splits * rows
    assert splits * pool <= st._MAX_POOL_WIDTH
    if n >= 1 << 20:  # the last wave at least _WAVE_FILL full
        waves = 64 * splits / slots
        assert waves / np.ceil(waves) >= st._WAVE_FILL


def _jax_route(q, x16, xn, k, metric, alive, block_rows):
    """The JAX package's route for a bf16 table: `blockwise_topk_scored` with
    the device BM25 sweep's einsum score (bf16 operands, f32 sums; dead rows
    +inf, as `vecgo_tpu/lexical/device_bm25._scan_topk`), or |q|^2 + |x|^2
    minus twice it for l2."""
    qn = (q.astype(np.float64) ** 2).sum(1).astype(np.float32)

    def score_fn(qq, extra, blk):
        s = jnp.einsum("bh,nh->bn", qq.astype(jnp.bfloat16), blk["w16"],
                       preferred_element_type=jnp.float32)
        if metric == "dot":
            return jnp.where(blk["alive"][None, :], -s, jnp.inf)
        return jnp.where(blk["alive"][None, :], extra[:, None] + blk["xn"][None, :] - 2.0 * s,
                         jnp.inf)

    enc = {"w16": jnp.asarray(x16), "alive": jnp.asarray(alive), "xn": jnp.asarray(xn)}
    return JT.blockwise_topk_scored(jnp.asarray(q), enc, x16.shape[0], k, score_fn,
                                    extra=jnp.asarray(qn), block_rows=block_rows)


@pytest.mark.parametrize("d", [1536, 4096])
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_reference_matches_jax_route_at_deep_d(d, metric):
    """The deep bf16 regime (d past the resident query tile: the BM25 sweep,
    3,072-d and 1,536-d embeddings) against the JAX package's route for it.
    dot: BM25-like data, sparse non-negative bf16 weights, multi-hot queries
    and an alive mask, as the sweep gets them; l2: Gaussian rows. Both sides
    sum the same exact bf16 products in f32, in another order: scores agree
    within rtol 1e-5 and an atol of d * 2^-24 * max|q| * max|x| (the f32
    rounding of d terms); ids agree except between scores that tie within
    it."""
    r = np.random.default_rng(d + len(metric))
    b, n, k = 9, 700, 12
    if metric == "dot":
        x = np.where(r.random((n, d)) < 0.01, r.random((n, d)) * 4, 0).astype(np.float32)
        q = np.zeros((b, d), np.float32)
        for i in range(b):
            q[i, r.choice(d, 3, replace=False)] = 1.0
        alive = r.random(n) >= 0.2
    else:
        x = r.standard_normal((n, d)).astype(np.float32)
        q = r.standard_normal((b, d)).astype(np.float32)
        alive = np.ones(n, bool)
    x16 = torch.from_numpy(x).bfloat16()
    xn = (x16.float() ** 2).sum(1)
    d_j, i_j = _jax_route(q, x16.float().numpy().astype(jnp.bfloat16), xn.numpy(), k, metric,
                          alive, block_rows=256)
    d_t, i_t = scan_topk_reference(torch.from_numpy(q), x16, xn, k, metric,
                                   None if metric == "l2" else torch.from_numpy(alive))
    d_j, i_j, d_t, i_t = map(np.asarray, (d_j, i_j, d_t, i_t))
    atol = d * 2.0 ** -24 * float(np.abs(q).max() * np.abs(x).max())
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=atol)
    np.testing.assert_array_equal(i_t < 0, i_j < 0)
    diff = i_t != i_j
    if diff.any():  # a swap only between scores that tie within the tolerance
        np.testing.assert_allclose(d_t[diff], d_j[diff], rtol=1e-5, atol=atol)
    assert alive[i_t[i_t >= 0]].all()


@pytest.mark.parametrize("product,tq,tn,min_tiles,n,k", [
    ("deep", 128, 256, 32, 1_049_576, 36),   # the BM25 sweep
    ("deep", 128, 256, 32, 262_144, 10),     # 3,072-d rows
    ("deep", 128, 256, 32, 1_000_000, 100),  # dbpedia-openai-1M at a pool of 100
    ("f32", 128, 128, 8, 1 << 20, 10),       # the one-device scan ShardedFlat splits
    ("f32", 128, 128, 8, 8192, 82),          # a memtable chunk
    ("f32-fma", 128, 128, 16, 8192, 1000),   # a memtable chunk at a pool of 1,000, unaligned
    ("f32-fma", 128, 128, 16, 1 << 20, 10),  # rows TMA cannot read
    ("short", 192, 128, 8, 1 << 20, 18),     # the flat segment's pool scan (three warpgroups)
    ("short", 192, 128, 8, 131_072, 18),     # a decoded block at a small pool
    ("short", 128, 128, 8, 131_072, 100),    # a decoded block at a pool of 100 (two)
    ("short", 128, 128, 8, 65_536, 256),     # k 256 over 65,536 rows
    ("short", 128, 128, 8, 1 << 20, 1000),   # a coarse quantizer's pool over the segment
])
def test_split_plan_fills_the_card_at_the_new_tiles(product, tq, tn, min_tiles, n, k):
    """The deep product's 128 x 256 tiles, the FMA f32 product's 128 x 128
    tiles, the split f32 product's 128 queries x 128 rows and the short
    product's 192 or 128 queries x 128 rows (one block an SM; the short and
    split products' persistent blocks walk the same units): 4096 queries
    are 22-32 query tiles, so the rows are split; each split keeps its
    minimum of tiles (the f32 and short products' lower ones, st._MIN_TILES_*;
    the short and split products at most st._MAX_SPLITS_SHORT splits), the
    finishing kernel's reads stay bounded, the splits cover the rows once,
    and at 1M rows the last wave is at least _WAVE_FILL full."""
    from vecgo_tpu_torch.ops import scan_topk as st

    assert product in st.PRODUCTS
    assert min_tiles == {"f32-fma": st._MIN_TILES_FMA, "f32": st._MIN_TILES_F32,
                         "short": st._MIN_TILES_SHORT}.get(product, st._MIN_TILES_PER_SPLIT)
    max_splits = st._MAX_SPLITS_SHORT if product in ("short", "f32") else st._MAX_POOL_WIDTH
    slots = 132
    pool = _pool_cap(k)
    splits, rows = st.split_plan(4096, n, tq, slots, pool, tn, min_tiles, max_splits)
    n_tiles = -(-n // tn)
    assert rows % tn == 0
    assert splits == 1 or rows >= min_tiles * tn
    assert splits <= max_splits
    assert (splits - 1) * rows < n <= splits * rows
    assert splits * pool <= st._MAX_POOL_WIDTH
    q_tiles = -(-4096 // tq)
    assert q_tiles * splits >= min(slots, q_tiles * min(n_tiles // min_tiles, max_splits))
    if n >= 1 << 20:
        waves = q_tiles * splits / slots
        assert waves / np.ceil(waves) >= st._WAVE_FILL


def test_split_plan_at_the_exact_cells_segment_scan():
    """The flat segment's f32 scan of the exact deployment (4096 queries
    over 9,990,000 x 96 rows at a pool of 116, so 256 pool entries; 132 SMs,
    one block each): 32 query tiles of 128 over 8 splits of 1,248,768 rows,
    256 units, the last wave 97% full, and the candidate pools' scratch at
    most 64 MiB (67.1 MB)."""
    from vecgo_tpu_torch.ops import scan_topk as st

    n, pool = 9_990_000, _pool_cap(116)
    assert pool == 256
    splits, rows = st.split_plan(4096, n, 128, 132, pool, 128, st._MIN_TILES_F32,
                                 st._MAX_SPLITS_SHORT)
    assert (splits, rows) == (8, 1_248_768)
    assert (splits - 1) * rows < n <= splits * rows
    blocks = -(-4096 // 128) * splits
    assert blocks / (2 * 132) >= st._WAVE_FILL
    assert blocks * 128 * pool * 8 <= 64 << 20


@pytest.mark.parametrize("b,units,paired", [(4096, 32, 32), (100, 1, 1), (64, 1, 0), (1, 1, 0),
                                            (4160, 33, 32), (4200, 33, 33)])
def test_split_units_count_the_paired_ones(b, units, paired):
    """The split f32 product's counters: its units (query tiles of 128 times
    splits) and those whose second warpgroup of 64 has a live query (the
    tile holds more than 64 of the B queries), recorded per launch."""
    from vecgo_tpu_torch.engine import tracing
    from vecgo_tpu_torch.ops import scan_topk as st

    with tracing.recording() as rec:
        st.count_split_units(b, 8, 128)
    got = {c.name: c.n for c in rec.counts()}
    assert got == {"scan_topk.split_units": 8 * units, "scan_topk.split_paired_units": 8 * paired}
    st.count_split_units(b, 8, 128)  # nothing recorded, nothing raised, with no recorder


# The split f32 product's arithmetic (the CUDA kernel's f32 product on tables
# TMA reads), emulated here with integer masks of the f32 bits: tf32 keeps
# the sign, the exponent and 10 mantissa bits (the low 13 bits zero).
def _tf32_trunc(a):
    return (a.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_rna(a):  # round to nearest, ties away from zero
    return ((a.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _bf16_rne(a):  # round to nearest even
    b = a.view(np.uint32)
    return ((b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1)))
            & np.uint32(0xFFFF0000)).view(np.float32)


def _split_rows(rng, n, d, peaked):
    """Rows around 256 random centres (sigma 0.35); `peaked` rows carry
    most of their norm in two coordinates, where a product's error is that
    of its few largest terms."""
    c = rng.standard_normal((256, d))
    x = c[rng.integers(0, 256, n)] + 0.35 * rng.standard_normal((n, d))
    if peaked:
        x[:, :2] *= 16 * np.sqrt(d / 32)
    return x.astype(np.float32)


@pytest.mark.parametrize("metric", ["l2", "dot", "cos"])
@pytest.mark.parametrize("d", [32, 128, 768])
def test_split_f32_product_is_fp32_class_and_two_piece_bf16_is_not(d, metric):
    """The kernel's split product: a raw row is read as its tf32 high part
    trunc(x) and its low part is rna(x - trunc(x)); a query splits into
    hi = rna(q) and lo = rna(q - hi); the score sums hi.x_hi + (lo.x_hi +
    hi.x_lo), the small terms first. Against float64, the 99.9th percentile
    of |score - exact| / (|q|^2 + |x|^2) is within 8x the IEEE fp32 product's
    on engine-like and on peaked rows. The TPU's Precision.HIGH (bf16 split
    in two pieces, the same three products) is outside that bound on peaked
    rows at every depth, so the bound tells the two apart."""
    for peaked in (False, True):
        rng = np.random.default_rng(d + peaked)
        x, q = _split_rows(rng, 2048, d, peaked), _split_rows(rng, 64, d, peaked)
        if metric == "cos":
            x /= np.linalg.norm(x, axis=1, keepdims=True)
            q /= np.linalg.norm(q, axis=1, keepdims=True)
        xn, qn = (x * x).sum(1, dtype=np.float32), (q * q).sum(1, dtype=np.float32)
        q64, x64 = q.astype(np.float64), x.astype(np.float64)

        def score(p, qn_, xn_):
            return {"l2": lambda: qn_[:, None] + xn_[None, :] - 2 * p,
                    "dot": lambda: -p, "cos": lambda: 1 - p}[metric]()

        exact = score(q64 @ x64.T, (q64 ** 2).sum(1), xn.astype(np.float64))
        scale = (q64 ** 2).sum(1)[:, None] + (x64 ** 2).sum(1)[None, :]

        def p999(p):
            s = score(p.astype(np.float32), qn, xn).astype(np.float32)
            return np.quantile(np.abs(s - exact) / scale, 0.999)

        ieee = p999(q @ x.T)
        xh = _tf32_trunc(x)
        xl = _tf32_rna(x - xh)
        qh = _tf32_rna(q)
        ql = _tf32_rna(q - qh)
        assert not (xl.view(np.uint32) & 0x1FFF).any() and not (ql.view(np.uint32) & 0x1FFF).any()
        split = qh @ xh.T + (ql @ xh.T + qh @ xl.T).astype(np.float32)
        assert p999(split) <= 8 * ieee
        if peaked:
            bh, ah = _bf16_rne(x), _bf16_rne(q)
            high = ah @ bh.T + (ah @ _bf16_rne(x - bh).T + _bf16_rne(q - ah) @ bh.T)
            assert p999(high) > 8 * ieee
