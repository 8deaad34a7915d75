"""The port's quantizers against the JAX package's, on the CPU.

Same rows, made from a seed, go through both packages:

- SQ8, INT4, BQ and RaBitQ train and encode in numpy in both packages, so
  their trained arrays and codes must be byte for byte equal.
- PQ and OPQ train with a k-means whose arithmetic and random draws differ,
  so the JAX-trained arrays are carried over (`quantizer_from_jax`); then the
  codes must be equal except where two centroids tie within 1e-5, and
  `decode` equal to 1e-6.
- `score` must agree within SCORE_RTOL of |q|^2 + |xhat|^2 for every kind and
  metric, and the block scanner (the route the segments take: `scan_topk`
  where the score has its form, a plain score matrix otherwise) must return
  the top-k of that score matrix.
- Quantizers trained in the port are held to the recall floors of
  tests/test_quantization.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vecgo_tpu import quantization as JQ
from vecgo_tpu.model import Metric as JMetric
from vecgo_tpu.quantization import kmeans as jkm
from vecgo_tpu.utils import testutil as tu
from vecgo_tpu_torch import quantization as Q
from vecgo_tpu_torch.convert import quantizer_from_jax
from vecgo_tpu_torch.index.common import enc_tensor
from vecgo_tpu_torch.model import Metric
from vecgo_tpu_torch.ops import topk as T
from vecgo_tpu_torch.quantization import kmeans as km

torch.set_num_threads(1)

N, D, B, K = 4096, 64, 16, 10
KINDS = ["none", "sq8", "int4", "pq", "opq", "bq", "rabitq"]
# Both packages round the same operands to bf16 and sum exact products in
# f32, in another order: the difference is a few f32 ulp of the largest
# term, far below bf16's own 2^-8. 1e-5 of |q|^2 + |xhat|^2 is ~80 ulp.
SCORE_RTOL = 1e-5

# (raw recall@10 floor, reranked recall@10 floor) of tests/test_quantization.py
FLOORS = {"none": (0.999, 0.999), "sq8": (0.90, 0.99), "int4": (0.45, 0.90),
          "pq": (0.25, 0.90), "opq": (0.25, 0.90), "bq": (0.15, 0.75), "rabitq": (0.15, 0.75)}


def _params(kind):
    return {"pq": {"m": 8}, "opq": {"m": 8, "opq_iters": 3}}.get(kind, {})


@pytest.fixture(scope="module")
def corpus():
    x, _ = tu.clustered_vectors(N, D, n_clusters=32, spread=0.08, seed=11)
    q = x[:B] + np.random.default_rng(12).standard_normal((B, D)).astype(np.float32) * 0.02
    return x, q


@pytest.fixture(scope="module")
def trained(corpus):
    """kind -> (JAX quantizer trained on the corpus, its codes, the port's
    quantizer carrying the same arrays)."""
    x, _ = corpus
    out = {}
    for kind in KINDS:
        jq = JQ.create(kind, dim=D, **_params(kind))
        jq.train(x)
        out[kind] = (jq, jq.encode(x), quantizer_from_jax(jq, device="cpu"))
    return out


@pytest.mark.parametrize("kind", ["sq8", "int4", "bq", "rabitq"])
def test_numpy_quantizers_train_and_encode_byte_for_byte(corpus, trained, kind):
    x, _ = corpus
    jq, jenc, _ = trained[kind]
    pq = Q.create(kind, device="cpu", dim=D)
    pq.train(x)
    assert pq.params() == jq.params() and pq.kind == jq.kind
    for name, arr in jq.arrays().items():
        assert np.asarray(arr).tobytes() == pq.arrays()[name].tobytes(), name
    penc = pq.encode(x)
    assert set(penc) == set(jenc)
    for name in jenc:
        assert penc[name].dtype == np.asarray(jenc[name]).dtype
        assert penc[name].tobytes() == np.asarray(jenc[name]).tobytes(), name
    assert pq.code_bytes_per_vector() == jq.code_bytes_per_vector()


@pytest.mark.parametrize("kind", KINDS)
def test_codes_and_decode_with_carried_arrays(corpus, trained, kind):
    x, _ = corpus
    jq, jenc, pq = trained[kind]
    assert pq.params() == jq.params()
    assert pq.code_bytes_per_vector() == jq.code_bytes_per_vector()
    penc = pq.encode(x)
    for name in jenc:
        a, b = np.asarray(jenc[name]), penc[name]
        assert a.dtype == b.dtype and a.shape == b.shape
        if kind in ("pq", "opq") and name == "codes":
            # A differing code is a tie: both centroids equally near (1e-5).
            xr = x @ jq.rotation if kind == "opq" else x
            cb = pq.pq.codebooks if kind == "opq" else pq.codebooks
            for row, m in zip(*np.nonzero(a != b)):
                sub = xr[row, m * 8 : (m + 1) * 8]
                da = ((sub - cb[m][a[row, m]]) ** 2).sum()
                db = ((sub - cb[m][b[row, m]]) ** 2).sum()
                assert abs(da - db) <= 1e-5, (row, m, da, db)
        elif kind in ("pq", "opq"):
            np.testing.assert_allclose(b, a, atol=1e-5)  # norms of tied codes
        else:
            np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(pq.decode(jenc), jq.decode(jenc), atol=1e-6)
    # state round trip: a quantizer rebuilt from state() encodes the same
    again = Q.Quantizer.from_state(pq.state(), device="cpu").encode(x[:256])
    for name in again:
        np.testing.assert_array_equal(again[name], pq.encode(x[:256])[name])


# The identity quantizer's cosine assumes normalized storage and is held on
# segments (tests/test_torch_flat.py); every other pair is held here.
@pytest.mark.parametrize("kind,metric", [(k, m) for k in KINDS for m in ("l2", "dot", "cosine")
                                         if (k, m) != ("none", "cosine")])
def test_score_and_block_scan_match_jax(corpus, trained, kind, metric):
    x, q = corpus
    jq, jenc, pq = trained[kind]
    want = np.asarray(jq.score(jnp.asarray(q), {k: jnp.asarray(v) for k, v in jenc.items()},
                               JMetric(metric)))
    tenc = {k: enc_tensor(np.asarray(v), "cpu") for k, v in jenc.items()}
    got = pq.score(torch.from_numpy(q), tenc, Metric(metric)).numpy()
    recon = jq.decode(jenc)
    scale = (q * q).sum(1).max() + (recon * recon).sum(1).max() if metric != "cosine" else 2.0
    tol = SCORE_RTOL * float(scale)
    np.testing.assert_allclose(got, want, atol=tol)
    # The segments' route: the scanner's top-k of a block equals the score
    # matrix's, with and without a row mask.
    mask = torch.from_numpy(np.random.default_rng(13).random(N) < 0.4)
    for m in (None, mask):
        d, i = T.BlockScanner(pq, Metric(metric))(torch.from_numpy(q), K)(tenc, m)
        sc = torch.from_numpy(want) if m is None else torch.where(
            m[None, :], torch.from_numpy(want), torch.inf)
        d_ref, _ = T.topk_smallest(sc, K)
        np.testing.assert_allclose(d.numpy(), d_ref.numpy(), atol=2 * tol)
        picked = np.take_along_axis(sc.numpy(), i.numpy(), 1)
        np.testing.assert_allclose(picked, d.numpy(), atol=2 * tol)  # the ids are those rows
    routed = pq.scan_form(torch.from_numpy(q), Metric(metric)) is not None
    assert routed == (metric != "cosine" and kind != "rabitq")


@pytest.mark.parametrize("kind", KINDS)
def test_recall_floor_trained_in_the_port(corpus, kind):
    x, q = corpus
    quant = Q.create(kind, device="cpu", dim=D, **_params(kind))
    quant.train(x)
    enc = {k: enc_tensor(v, "cpu") for k, v in quant.encode(x).items()}
    scores = quant.score(torch.from_numpy(q), enc, Metric.L2).numpy()
    assert scores.shape == (B, N)
    _, true_ids = tu.brute_force_knn(q, x, K, "l2")
    raw_floor, rerank_floor = FLOORS[kind]
    raw = tu.recall_at_k(np.argsort(scores, axis=1)[:, :K], true_ids)
    assert raw >= raw_floor, f"{kind} raw recall {raw}"
    pool = np.argsort(scores, axis=1)[:, : 10 * K]
    rr = [pool[b][np.argsort(((q[b][None] - x[pool[b]]) ** 2).sum(1))[:K]] for b in range(B)]
    rerank = tu.recall_at_k(np.asarray(rr), true_ids)
    assert rerank >= rerank_floor, f"{kind} reranked recall {rerank}"
    rel = np.linalg.norm(quant.decode(quant.encode(x[:256])) - x[:256]) / np.linalg.norm(x[:256])
    assert rel <= {"none": 1e-6, "sq8": 0.02, "int4": 0.1, "pq": 0.6, "opq": 0.6,
                   "bq": 0.9, "rabitq": 0.9}[kind]


def test_bq_hamming_metric_equals_jax(corpus, trained):
    x, q = corpus
    jq, jenc, pq = trained["bq"]
    qp = pq.encode_query(q)
    assert qp.tobytes() == np.asarray(jq.encode_query(q)).tobytes()
    want = np.asarray(jq.score(jnp.asarray(qp), {k: jnp.asarray(v) for k, v in jenc.items()},
                               JMetric.HAMMING))
    tenc = {k: enc_tensor(np.asarray(v), "cpu") for k, v in jenc.items()}
    got = pq.score(enc_tensor(qp, "cpu"), tenc, Metric.HAMMING).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).all() and (got <= D).all()


def test_unknown_kind_and_device_kept_out_of_state():
    with pytest.raises(ValueError, match="unknown quantizer"):
        Q.create("sq9", dim=4)
    q = Q.create("pq", device="cpu", dim=8, m=2)
    assert q.params() == {"dim": 8, "m": 2, "ksub": 256}
    assert "device" not in q.state()["params"]
    assert Q.create("none", dim=3).kind == "none" and Q.create("", dim=3).kind == "none"


def test_kmeans_host_functions():
    x, assign = tu.clustered_vectors(2000, 16, n_clusters=8, spread=0.02, seed=3)
    centers, inertia = km.train_kmeans(x, 8, iters=20, seed=5, device="cpu")
    assert centers.shape == (8, 16) and centers.dtype == np.float32 and inertia >= 0
    a, dist = km.assign_partitions(x, centers, device="cpu")
    assert a.dtype == np.int32 and dist.dtype == np.float32
    agreement = 0
    for c in range(8):
        members = a[assign == c]
        if len(members):
            agreement += (members == np.bincount(members, minlength=8).argmax()).mean()
    assert agreement / 8 > 0.9
    idx, _ = km.closest_centroids(x[:4], centers, 3, device="cpu")
    assert idx.shape == (4, 3)
    np.testing.assert_array_equal(idx[:, 0], a[:4])
    # The same centres give the JAX package's assignment, f32 and bf16.
    ja, jd = jkm.assign_partitions(x, centers)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_allclose(dist, jd, atol=1e-4)
    a16, _ = km.assign_partitions(x, centers, transfer_dtype=torch.bfloat16, device="cpu")
    ja16, _ = jkm.assign_partitions(x, centers, transfer_dtype=jnp.bfloat16)
    assert (a16 == ja16).mean() > 0.999 and (a16 == a).mean() > 0.98
    ji, _ = jkm.closest_centroids(x[:4], centers, 3)
    np.testing.assert_array_equal(idx, ji)


def test_kmeans_seeding_quality_and_degenerate_branch():
    x, _ = tu.clustered_vectors(4000, 24, n_clusters=32, spread=0.02, seed=11)
    _, inertia = km.train_kmeans(x, 32, iters=15, seed=7, device="cpu")
    assert inertia < 10 * 4000 * 24 * 0.02**2
    # n < k: the rows themselves plus jittered repeats, the JAX package's bytes
    few = x[:5]
    centers, inertia = km.train_kmeans(few, 9, seed=3, device="cpu")
    jc, ji = jkm.train_kmeans(few, 9, seed=3)
    assert centers.tobytes() == np.asarray(jc).tobytes() and inertia == ji == 0.0
    empty, _ = km.train_kmeans(np.zeros((0, 6), np.float32), 4, device="cpu")
    assert empty.shape == (4, 6) and np.abs(empty).max() < 1e-3  # jitter around zero


def test_kmeans_grouped_matches_jax_from_the_same_init():
    """`train_kmeans_grouped` draws its sample and initial rows from numpy's
    generator as the JAX package does, so the codebooks agree (atol 1e-4:
    the Lloyd sums run in another order)."""
    x = tu.gaussian_vectors(1000, 32, seed=9).reshape(1000, 4, 8).transpose(1, 0, 2)
    cbs = km.train_kmeans_grouped(x, 16, iters=5, seed=6, device="cpu")
    assert cbs.shape == (4, 16, 8) and np.isfinite(cbs).all()
    np.testing.assert_allclose(cbs, jkm.train_kmeans_grouped(x, 16, iters=5, seed=6), atol=1e-4)
    small = km.train_kmeans_grouped(x[:, :10], 16, iters=5, seed=6, device="cpu")
    assert small.shape == (4, 16, 8)  # n < k: the per-group degenerate branch
