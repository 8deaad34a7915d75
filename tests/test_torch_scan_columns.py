"""`scan_topk_columns`, the device BM25 sweep as a sparse product, on the CPU.

Each query is a list of at most 16 columns of a bf16 table (-1 pads, a
repeated column counting each time), and a row's score is the f32 sum of
the query's own columns, negated, masked rows excluded, then the k best with
ties to the lower row. Its plain version (what a CPU tensor runs) is held
here to the dense function it replaces, `scan_topk_reference` on the
multi-hot query (scatter-added counts), and to the JAX package's sweep
(`vecgo_tpu/lexical/device_bm25._scan_topk`, an einsum of the multi-hot
query with a blockwise top-k); `DeviceBM25` sweeps through it.

Tolerance: both sides sum the same bf16 weights in f32, in another order
(the dense product adds the multi-hot query's exact zero terms too), so
scores agree within 1e-6 of the score itself (BM25-like sums of a few bf16
weights are mostly exact in f32), and ids agree except among exact ties:
where two lists hold different rows at a rank, the rows score the same.
"""

import numpy as np
import pytest
import torch

from vecgo_tpu_torch.ops import scan_topk as st
from vecgo_tpu_torch.ops.scan_topk import (
    scan_topk,
    scan_topk_columns,
    scan_topk_columns_reference,
    scan_topk_reference,
)

torch.set_num_threads(1)

REL = 1e-6


def _table(n, h, seed, nnz_row=12, mask_frac=0.1):
    """An [n, h] bf16 table of BM25-like rows (about 12 positive weights a
    row on zipf-drawn columns, drawn from 64 levels so that many scores tie
    bit for bit) and a mask with `mask_frac` of the rows out."""
    r = np.random.default_rng(seed)
    cols = np.minimum(r.zipf(1.3, (n, nnz_row)) - 1, h - 1)
    levels = (r.random(64) * 3).astype(np.float32)
    x = np.zeros((n, h), np.float32)
    x[np.arange(n)[:, None], cols] = levels[r.integers(0, 64, (n, nnz_row))]
    mask = r.random(n) >= mask_frac
    return torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(mask)


def _cols(b, t, h, seed, kind):
    """[b, t] int32 query columns: zipf-drawn with a random count of pads
    ("zipf"), with columns repeated in a query ("repeats"), or all pads."""
    r = np.random.default_rng(seed)
    c = np.minimum(r.zipf(1.3, (b, t)) - 1, h - 1).astype(np.int32)
    if kind == "pads":
        c[:] = -1
    elif kind == "zipf":
        keep = r.integers(1, t + 1, b)
        c[np.arange(t)[None, :] >= keep[:, None]] = -1
    else:
        c[:, t - t // 2 :] = c[:, : t // 2]  # the second half repeats the first
        c[0, -1] = -1
    return torch.from_numpy(c)


def _multi_hot(cols, h):
    c = cols.long()
    q = torch.zeros((c.shape[0], h), dtype=torch.float32)
    return q.scatter_add_(1, c.clamp_min(0), (c >= 0).float())


def _exact(cols, x, rows):
    """float64 scores (negated sums of the query's columns) of rows [B, k]."""
    c = cols.long()
    w = x.double()[rows.clamp_min(0).long()]  # [B, k, H]
    picked = torch.gather(w, 2, c.clamp_min(0)[:, None, :].expand(-1, rows.shape[1], -1))
    return -torch.where((c >= 0)[:, None, :], picked, 0.0).sum(-1)


def _assert_same_up_to_ties(cols, x, got, want):
    (d_g, i_g), (d_w, i_w) = got, want
    assert d_g.shape == d_w.shape and i_g.dtype == torch.int32
    assert torch.equal(torch.isfinite(d_g), torch.isfinite(d_w))
    assert torch.equal(i_g < 0, i_w < 0)
    fin = torch.isfinite(d_w)
    assert bool(((d_g - d_w).abs() <= REL * d_w.abs())[fin].all())
    swapped = (i_g != i_w) & fin
    if swapped.any():
        e_g, e_w = _exact(cols, x, i_g), _exact(cols, x, i_w)
        assert bool(((e_g - e_w).abs() <= REL * e_w.abs())[swapped].all())


@pytest.mark.parametrize("k", [1, 36, 256, "past"])
@pytest.mark.parametrize("mask_frac", [0.1, 1.0])
@pytest.mark.parametrize("kind", ["zipf", "repeats", "pads"])
@pytest.mark.parametrize("t", [1, 16])
@pytest.mark.parametrize("h", [64, 4096])
def test_reference_matches_the_dense_function(h, t, kind, mask_frac, k):
    """The plain version against scan_topk's plain version on the multi-hot
    query: H 64 and 4,096, one and 16 columns, all-pad queries (every score
    0: the lowest live ids), repeated columns, 10% and 100% of the rows
    masked, k from 1 to past the live rows (+inf, -1 there)."""
    n, b = 700, 24
    x, mask = _table(n, h, seed=h + t, mask_frac=mask_frac)
    cols = _cols(b, t, h, seed=3 * t + 1, kind=kind)
    kk = n + 5 if k == "past" else k
    got = scan_topk_columns_reference(cols, x, kk, mask)
    want = scan_topk_reference(_multi_hot(cols, h), x, None, kk, "dot", mask)
    _assert_same_up_to_ties(cols, x, got, want)
    live = torch.nonzero(mask).flatten()
    if kind == "pads":  # every live row scores 0: the lowest live ids, in order
        first = live[: min(kk, len(live))].to(torch.int32)
        assert bool((got[1][:, : len(first)] == first).all())
        assert bool((got[0][:, : len(first)] == 0).all())
    assert int((got[1] >= 0).sum(1).max()) == min(kk, len(live))


@pytest.mark.parametrize("h", [64, 4096])
def test_reference_matches_the_jax_sweep(h):
    """The plain version against the JAX package's sweep on the same table,
    mask and multi-hot queries (16 columns with repeats and pads), at the
    device BM25 snapshot's k (pool 20 + margin 16)."""
    import jax.numpy as jnp

    from vecgo_tpu.lexical.device_bm25 import _scan_topk

    n, b, k = 900, 32, 36
    x, mask = _table(n, h, seed=7 * h)
    cols = _cols(b, 16, h, seed=h, kind="repeats")
    d_j, i_j = _scan_topk(jnp.asarray(_multi_hot(cols, h).numpy(), jnp.bfloat16),
                          jnp.asarray(x.view(torch.int16).numpy()).view(jnp.bfloat16),
                          jnp.asarray(mask.numpy()), k)
    d_j = torch.from_numpy(np.array(d_j, np.float32))
    i_j = torch.from_numpy(np.array(i_j, np.int32))
    d_p, i_p = scan_topk_columns_reference(cols, x, k, mask)
    fin = torch.isfinite(d_j)
    assert torch.equal(fin, torch.isfinite(d_p))
    i_j = torch.where(fin, i_j, -1)
    _assert_same_up_to_ties(cols, x, (d_p, i_p), (d_j, i_j))


def test_wrapper_checks_and_cpu_route(monkeypatch):
    """A CPU tensor runs the plain version (no launch counted); shapes,
    types, widths and columns outside the table raise."""
    x, mask = _table(50, 64, seed=1)
    cols = _cols(4, 3, 64, seed=2, kind="zipf")
    calls = []
    real = st.scan_topk_columns_reference

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(st, "scan_topk_columns_reference", spy)
    before = scan_topk.launches
    d, i = scan_topk_columns(cols, x, 5, mask)
    assert calls == [(4, 3)] and scan_topk.launches == before
    assert d.shape == (4, 5) and i.dtype == torch.int32
    for bad in (
        lambda: scan_topk_columns(cols, x, 0),
        lambda: scan_topk_columns(cols.float(), x, 5),
        lambda: scan_topk_columns(torch.zeros((4, 17), dtype=torch.int32), x, 5),
        lambda: scan_topk_columns(cols, x.float(), 5),
        lambda: scan_topk_columns(cols, x, 5, mask[:10]),
        lambda: scan_topk_columns(cols.t(), x, 5),
        lambda: scan_topk_columns(cols.clone().fill_(64), x, 5),
        lambda: scan_topk_columns(cols.clone().fill_(-2), x, 5),
    ):
        with pytest.raises(ValueError):
            bad()


def test_device_bm25_sweeps_through_the_columns_product(monkeypatch):
    """DeviceBM25 on the CPU sweeps with scan_topk_columns (its plain
    version: no kernel launched) on the [B, 16] columns, the bf16 table and
    the alive mask, never with the dense product; the pool it sweeps is
    the dense function's up to exact ties."""
    from vecgo_tpu_torch.lexical.bm25 import BM25Index
    from vecgo_tpu_torch.lexical.device_bm25 import DeviceBM25

    r = np.random.default_rng(4)
    words = [f"w{i}" for i in range(200)]
    idx = BM25Index()
    for i in range(1200):
        idx.add(i + 1, " ".join(words[min(int(z) - 1, 199)] for z in r.zipf(1.3, 12)))
    for i in range(1, 1200, 13):
        idx.delete(i)
    snap = DeviceBM25(idx, max_hot_terms=128, min_df=4, device="cpu")
    queries = [" ".join(words[min(int(z) - 1, 199)] for z in r.zipf(1.3, 3)) for _ in range(40)]
    calls = []
    real = st.scan_topk_columns_reference

    def spy(cols, x, k, mask=None):
        calls.append((tuple(cols.shape), x.dtype, k, mask.dtype))
        return real(cols, x, k, mask)

    def dense(*a, **kw):
        raise AssertionError("the dense product ran")

    monkeypatch.setattr(st, "scan_topk_columns_reference", spy)
    monkeypatch.setattr(st, "scan_topk_reference", dense)
    before = scan_topk.launches
    ids, sc = snap.search_batch_arrays(queries, 10)
    assert calls == [((40, 16), torch.bfloat16, 26, torch.bool)]
    assert scan_topk.launches == before
    monkeypatch.undo()
    cols, _ = snap.encode_queries(queries)
    w, alive = snap._device()
    _, q = snap.multi_hot(cols)
    got = scan_topk_columns(torch.from_numpy(cols), w, 26, alive)
    want = scan_topk_reference(q, w, None, 26, "dot", alive)
    _assert_same_up_to_ties(torch.from_numpy(cols), w, got, want)
    assert ids.shape == (40, 10) and (sc[ids >= 0] > 0).all()
