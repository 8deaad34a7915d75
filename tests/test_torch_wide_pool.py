"""Pools wider than 256: the port against the JAX package (device="cpu").

`scan_topk` took k <= 256 until its wide shape; the JAX package selects with
`lax.top_k` and has no limit. Every engine path that can pool past 256 runs
here at such a pool, beside the JAX engine on the same writes, and both must
return the same ids (equal to exact brute force where the path is exact):
the flat segment at k = 300 (pool k + 8), the same under churn (memtable,
deletes and an upsert widen the pool by the churn margin), filters at 10%
(compact-gather, pool + 24) and 80% (the masked scan), a quantized segment
at k * refine_factor > 256, and the PQ stream at fetch 300 (pool 1,200).
Below them, `scan_topk`'s plain version at k past 256 against the Pallas
kernel in interpret mode, and `BlockScanner` at such a k against the plain
score matrix. Scans stay below 16,384 rows, where the JAX scans are exact
(`lax.top_k`). On the card the same paths go through the kernel's wide shape
(tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vecgo_tpu_torch as vg
from vecgo_tpu import metadata as jmd
from vecgo_tpu.blobstore import MemoryStore as JaxMemoryStore
from vecgo_tpu.engine import Engine as JaxEngine
from vecgo_tpu.engine import EngineOptions as JaxEngineOptions
from vecgo_tpu.ops import pallas_scan
from vecgo_tpu.utils import testutil as tu
from vecgo_tpu_torch import metadata as pmd
from vecgo_tpu_torch import quantization as Q
from vecgo_tpu_torch.index.common import enc_tensor
from vecgo_tpu_torch.model import Metric
from vecgo_tpu_torch.ops import topk as T
from vecgo_tpu_torch.ops.scan_topk import scan_topk, scan_topk_reference

torch.set_num_threads(1)

D = 32
K = 300


def assert_same_up_to_ties(got_a, d_a, got_b, d_b, atol=1e-4):
    """The same ranked answers: distances rank by rank within atol (f32
    reranks summed in another order), and ids equal except where two rows'
    distances tie within it (a swap of neighbours, or a row at the k-th
    distance exchanged for another there)."""
    np.testing.assert_allclose(d_a, d_b, atol=atol)
    for qi in np.flatnonzero((got_a != got_b).any(1)):
        for j in np.flatnonzero(got_a[qi] != got_b[qi]):
            near = np.abs(d_a[qi] - d_a[qi, j]) <= 2 * atol
            assert got_b[qi, j] in got_a[qi, near] or d_a[qi, j] >= d_a[qi, -1] - 2 * atol


def _apply_writes(db, x1, x2, u1, u2):
    """Commit x1, leave x2 in the memtable, delete and upsert a few ids."""
    ids1 = db.insert_batch(x1, [{"u": int(v)} for v in u1])
    db.commit()
    ids2 = db.insert_batch(x2, [{"u": int(v)} for v in u2])
    gone = ids1[::97] + ids2[::53]
    for i in gone:
        assert db.delete(i)
    db.insert(x1[8] + 0.01, metadata={"u": int(u1[7])}, id=ids1[7])
    return np.asarray(ids1 + ids2), gone


@pytest.fixture(scope="module")
def twin():
    r = np.random.default_rng(61)
    x1 = r.standard_normal((6_000, D)).astype(np.float32)
    x2 = r.standard_normal((1_500, D)).astype(np.float32)
    u1, u2 = r.integers(0, 100, len(x1)), r.integers(0, 100, len(x2))
    jax_db = vg.DB(JaxEngine.open(JaxMemoryStore(), JaxEngineOptions(dim=D), create=True))
    port_db = vg.Open(vg.Memory(), vg.Create(dim=D, device="cpu"))
    ids, gone = _apply_writes(jax_db, x1, x2, u1, u2)
    assert (_apply_writes(port_db, x1, x2, u1, u2)[0] == ids).all()
    x = np.concatenate([x1, x2])
    x[7] = x1[8] + 0.01
    return jax_db, port_db, x, ids, np.concatenate([u1, u2]), gone


@pytest.mark.parametrize("sel", [None, 10, 50, 80])
def test_churned_engine_at_k300_matches_jax_and_brute_force(twin, sel):
    jax_db, port_db, x, ids, u, gone = twin
    q = np.random.default_rng(62).standard_normal((12, D)).astype(np.float32)
    kw_p = {} if sel is None else {"filter": pmd.isin("u", list(range(sel)))}
    kw_j = {} if sel is None else {"filter": jmd.isin("u", list(range(sel)))}
    got_p, d_p = port_db.search_arrays(q, k=K, **kw_p)
    got_j, d_j = jax_db.search_arrays(q, k=K, **kw_j)
    assert got_p.shape == (12, K)
    assert_same_up_to_ties(got_p, d_p, got_j, d_j)
    vis = ~np.isin(ids, gone) if sel is None else ~np.isin(ids, gone) & (u < sel)
    _, rows = tu.brute_force_knn(q, x[vis], K, "l2")
    np.testing.assert_array_equal(got_p, ids[vis][rows])


def _fresh(engine, **kw):
    if engine == "jax":
        return vg.DB(JaxEngine.open(JaxMemoryStore(), JaxEngineOptions(dim=D, **kw), create=True))
    return vg.Open(vg.Memory(), vg.Create(dim=D, device="cpu", **kw))


def test_flat_segment_at_k300_matches_jax_and_brute_force():
    x = tu.gaussian_vectors(5000, D, seed=63)
    q = tu.gaussian_vectors(10, D, seed=64)
    got = {}
    for engine in ("jax", "port"):
        db = _fresh(engine)
        ids = db.insert_batch(x)
        db.commit()
        got[engine] = db.search_arrays(q, k=K)
    assert_same_up_to_ties(*got["port"], *got["jax"])
    _, rows = tu.brute_force_knn(q, x, K, "l2")
    np.testing.assert_array_equal(got["port"][0], np.asarray(ids)[rows])


def test_quantized_segment_pool_over_256_matches_jax():
    """quantizer="sq8" at k = 150 and refine_factor 2: a pool of 300 codes,
    reranked exactly."""
    x = tu.gaussian_vectors(5000, D, seed=65)
    q = tu.gaussian_vectors(10, D, seed=66)
    got = {}
    for engine in ("jax", "port"):
        db = _fresh(engine, quantizer="sq8")
        ids = db.insert_batch(x)
        db.commit()
        got[engine] = db.search_arrays(q, k=150, refine_factor=2)
    assert_same_up_to_ties(*got["port"], *got["jax"])
    _, rows = tu.brute_force_knn(q, x, 150, "l2")
    truth = np.asarray(ids)[rows]
    rec = np.mean([len(set(a) & set(b)) / 150 for a, b in zip(got["port"][0], truth)])
    assert rec >= 0.99


def test_pq_stream_at_fetch_300_matches_jax():
    """The PQ stream transport pools max(4 kk, 128) = 1,200 rows at k = 300
    and reranks them exactly: both packages return the exact answer (their
    PQ codebooks differ after training, the pool repairs it)."""
    x, _ = tu.clustered_vectors(5000, D, n_clusters=12, seed=67)
    q = tu.gaussian_vectors(8, D, seed=68)
    got = {}
    for engine in ("jax", "port"):
        db = _fresh(engine, hbm_budget_bytes=1024, stream_transport="pq")
        ids = db.insert_batch(x)
        db.commit()
        got[engine] = db.search_arrays(q, k=K)[0]
    _, rows = tu.brute_force_knn(q, x, K, "l2")
    truth = np.asarray(ids)[rows]
    for engine, g in got.items():
        rec = np.mean([len(set(a) & set(b)) / K for a, b in zip(g, truth)])
        assert rec >= 0.995, (engine, rec)
    same = np.mean([len(set(a) & set(b)) / K for a, b in zip(got["port"], got["jax"])])
    assert same >= 0.995


@pytest.mark.parametrize("k", [257, 1000])
def test_scan_topk_plain_version_matches_pallas_at_wide_k(k):
    r = np.random.default_rng(k)
    q = r.standard_normal((9, 16)).astype(np.float32)
    x = r.standard_normal((3000, 16)).astype(np.float32)
    xn = (x * x).sum(1)
    d_j, i_j = pallas_scan.l2_topk(jnp.asarray(q), jnp.asarray(x), k=k, tile_b=8, tile_n=1024)
    d_t, i_t = scan_topk(torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(xn), k, "l2")
    d_j, i_j = np.asarray(d_j), np.asarray(i_j)
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(i_t.numpy(), i_j)


def test_scan_topk_at_k_equal_n_returns_every_eligible_row():
    r = np.random.default_rng(69)
    q = torch.from_numpy(r.standard_normal((5, 8)).astype(np.float32))
    x = torch.from_numpy(r.standard_normal((700, 8)).astype(np.float32))
    mask = torch.from_numpy(r.random(700) < 0.6)
    d, i = scan_topk(q, x, (x * x).sum(1), 700, "l2", mask)
    n_ok = int(mask.sum())
    assert (i[:, :n_ok] >= 0).all() and (i[:, n_ok:] == -1).all()
    assert torch.isinf(d[:, n_ok:]).all()
    for row in i[:, :n_ok]:
        assert sorted(row.tolist()) == torch.nonzero(mask).squeeze(1).tolist()


@pytest.mark.parametrize("kind", ["sq8", "pq"])
def test_block_scanner_pool_over_256_matches_score_matrix(kind):
    """On CPU tensors BlockScanner now takes the kernel's form (whose plain
    version any k takes) at every k, as on the card: its pool of 300 equals
    the plain score matrix's top 300 within 2e-5 of |q|^2 + |x^|^2."""
    r = np.random.default_rng(70)
    x = r.standard_normal((5000, D)).astype(np.float32)
    q = torch.from_numpy(r.standard_normal((6, D)).astype(np.float32))
    quant = Q.create(kind, device="cpu", dim=D, **({"m": 8} if kind == "pq" else {}))
    quant.train(x)
    enc = {k: enc_tensor(v, "cpu") for k, v in quant.encode(x).items()}
    d, i = T.blockwise_topk_scored(q, enc, len(x), K, T.BlockScanner(quant, Metric.L2),
                                   block_rows=1500)
    sc = quant.score(q, enc, Metric.L2)
    d_ref, _ = torch.topk(sc, K, dim=1, largest=False)
    recon = quant.decode(quant.encode(x))
    tol = 2e-5 * float((q * q).sum(1).max() + (recon * recon).sum(1).max())
    assert float((d - d_ref).abs().max()) <= tol
    assert float((sc.gather(1, i.long()) - d).abs().max()) <= tol


def test_scan_topk_reference_wide_k_equals_sorted_scores():
    """The plain version at k past 256 is a sort of the scores, ties to the
    lower row."""
    r = np.random.default_rng(71)
    q = torch.from_numpy(r.standard_normal((4, 8)).astype(np.float32))
    x = torch.from_numpy(np.round(r.standard_normal((900, 8)), 1).astype(np.float32))
    x[500:] = x[:400]  # exact duplicates: ties
    xn = (x * x).sum(1)
    d, i = scan_topk_reference(q, x, xn, 600, "l2")
    s = (q * q).sum(1)[:, None] + xn[None] - 2 * q @ x.T
    order = np.lexsort((np.arange(900)[None].repeat(4, 0), s.numpy()), axis=1)[:, :600]
    np.testing.assert_array_equal(i.numpy(), order)
