"""Quantized and partitioned flat segments of the port against the JAX package's.

A segment written by either package (a quantizer, flat IVF partitions, a
metric) opens in the other and returns the same rows. All scans stay below
16,384 rows, where the JAX package selects exactly (`lax.top_k`), so ids must
be equal; distances agree to DIST_ATOL (both packages sum the same exact
bf16 products in f32, in another order). Probing goes through different
mechanisms (a per-query partition mask in the JAX scorer; inverted probes
over row ranges in the port) that must exclude the same rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vecgo_tpu.index.flat import FlatSegment as JaxFlatSegment
from vecgo_tpu.index.flat import FlatWriter as JaxFlatWriter
from vecgo_tpu.model import Metric as JMetric
from vecgo_tpu_torch.convert import segment_from_jax
from vecgo_tpu_torch.index.flat import FlatSegment, FlatWriter
from vecgo_tpu_torch.model import Metric

torch.set_num_threads(1)

N, D, PARTS = 6000, 32, 6
DIST_ATOL = 1e-4  # |q|^2 + |x|^2 is ~80 here: about 10 f32 ulp of it


def _rows(seed=1):
    r = np.random.default_rng(seed)
    cent = r.standard_normal((40, D)).astype(np.float32)
    x = (cent[r.integers(0, 40, N)] + 0.3 * r.standard_normal((N, D))).astype(np.float32)
    q = (cent[r.integers(0, 40, 8)] + 0.3 * r.standard_normal((8, D))).astype(np.float32)
    ids = np.arange(500, 500 + N, dtype=np.int64)
    docs = [{"u": int(v)} for v in r.integers(0, 100, N)]
    return x, q, ids, docs


def _qparams(kind):
    return {"pq": {"m": 8}, "opq": {"m": 8, "opq_iters": 2}}.get(kind, {})


def _write(writer, kind, metric="l2", parts=PARTS):
    x, _, ids, docs = _rows()
    if writer == "jax":
        w = JaxFlatWriter(D, JMetric(metric), quantizer=kind, qparams=_qparams(kind),
                          ivf_partitions=parts)
    else:
        w = FlatWriter(D, Metric(metric), quantizer=kind, qparams=_qparams(kind),
                       ivf_partitions=parts, device="cpu")
    w.add_batch(x, ids, docs)
    return w.finish()


def _queries(metric):
    q = _rows()[1]
    return q / np.linalg.norm(q, axis=1, keepdims=True) if metric == "cosine" else q


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["none", "sq8", "int4", "pq", "opq", "bq", "rabitq"])
def test_segment_opens_in_the_other_package_and_returns_the_same_rows(writer, kind):
    data = _write(writer, kind)
    js, ts = JaxFlatSegment.open(data), FlatSegment.open(data)
    assert ts.quant.kind == js.quant.kind == kind
    assert ts.quant.params() == js.quant.params()
    assert ts.meta["ivf"]["partitions"] == PARTS and (np.diff(ts.ivf_part) >= 0).all()
    for name, arr in js.enc_host.items():
        np.testing.assert_array_equal(np.asarray(ts.enc_host[name]), np.asarray(arr))
    assert ts.device_bytes() == js.device_bytes() - (js.ivf_part.nbytes)  # no partition ids held
    q = _queries("l2")
    mask = np.random.default_rng(3).random(N) < 0.5
    for m in (None, mask):
        for nprobes in (0, 2, PARTS):
            d_j, r_j = js.search(jnp.asarray(q), 10, mask=m, nprobes=nprobes)
            d_t, r_t = ts.search(torch.from_numpy(q), 10, mask=m, nprobes=nprobes)
            np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
            np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=DIST_ATOL)
            d_s, r_s = ts.search_streaming(torch.from_numpy(q), 10, mask=m, nprobes=nprobes,
                                           block_rows=1024)
            if kind != "none":  # an unquantized stream scores f32 rows without a pool
                np.testing.assert_array_equal(r_s.numpy(), r_t.numpy())
                np.testing.assert_allclose(d_s.numpy(), d_t.numpy(), atol=DIST_ATOL)
            else:
                d_js, r_js = js.search_streaming(jnp.asarray(q), 10, mask=m, nprobes=nprobes,
                                                 block_rows=1024)
                np.testing.assert_array_equal(r_s.numpy(), np.asarray(r_js))
                np.testing.assert_allclose(d_s.numpy(), np.asarray(d_js), atol=DIST_ATOL)
            if m is not None:
                assert m[r_t.numpy()].all()
    # the exact rerank of a pool (from the host's rows when quantized)
    _, pool = ts.search(torch.from_numpy(q), 40)
    np.testing.assert_allclose(
        ts.rerank(torch.from_numpy(q), pool).numpy(),
        np.asarray(js.rerank(jnp.asarray(q), jnp.asarray(pool.numpy().astype(np.int32)))),
        atol=DIST_ATOL)


@pytest.mark.parametrize("metric", ["dot", "cosine"])
@pytest.mark.parametrize("kind", ["sq8", "pq", "bq", "rabitq"])
def test_other_metrics_match_jax(kind, metric):
    data = _write("jax", kind, metric, parts=0)
    js, ts = JaxFlatSegment.open(data), FlatSegment.open(data)
    q = _queries(metric)
    d_j, r_j = js.search(jnp.asarray(q), 10)
    d_t, r_t = ts.search(torch.from_numpy(q), 10)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=DIST_ATOL)


def test_probing_excludes_exactly_the_unprobed_partitions():
    ts = FlatSegment.open(_write("port", "sq8"))
    q = torch.from_numpy(_queries("l2"))
    cent = torch.from_numpy(np.asarray(ts.ivf_centroids))
    probes = torch.cdist(q, cent).argsort(1)[:, :2].numpy()
    _, rows = ts.search(q, 50, nprobes=2)
    part = np.asarray(ts.ivf_part)[rows.numpy()]
    assert all(set(part[b]) <= set(probes[b]) for b in range(len(q)))
    # the same answer as masking every other partition out of a full scan
    for b in range(len(q)):
        mask = np.isin(np.asarray(ts.ivf_part), probes[b])
        _, want = ts.search(q[b : b + 1], 50, mask=mask)
        np.testing.assert_array_equal(rows[b].numpy(), want[0].numpy())
    # fewer eligible rows than k: the tail is (+inf, -1)
    few = np.zeros(N, bool)
    few[np.flatnonzero(np.asarray(ts.ivf_part) == probes[0, 0])[:3]] = True
    d, r = ts.search(q[:1], 10, mask=few, nprobes=2)
    assert (r[0, :3] >= 0).all() and (r[0, 3:] == -1).all() and torch.isinf(d[0, 3:]).all()


def test_device_state_of_a_quantized_segment_holds_codes_only():
    ts = FlatSegment.open(_write("port", "sq8"))
    dev = ts.device_state("cpu")
    assert set(dev) == {"codes", "rnorm2"}
    assert dev["codes"].dtype == torch.uint8 and dev["codes"].shape == (N, D)
    held = sum(t.numel() * t.element_size() for t in dev.values())
    assert held == ts.device_bytes() == N * D + N * 4
    un = FlatSegment.open(_write("port", "none"))
    held = sum(t.numel() * t.element_size() for t in un.device_state("cpu").values())
    assert held == un.device_bytes() == N * D * 4 + N * 4 + N * D * 2
    bq = FlatSegment.open(_write("port", "bq"))
    assert bq.device_state("cpu")["codes"].dtype == torch.int32  # the uint32 words' bytes
    assert bq.device_bytes() == N * 4 + N * 4


def test_segment_from_jax_carries_codes_and_trained_arrays():
    js = JaxFlatSegment.open(_write("jax", "pq"), seg_id=4)
    ts = segment_from_jax(js, "cpu")
    assert ts.quant.kind == "pq" and ts.seg_id == 4
    np.testing.assert_array_equal(ts.quant.codebooks, np.asarray(js.quant.codebooks))
    np.testing.assert_array_equal(ts.enc_host["codes"], np.asarray(js.enc_host["codes"]))
    q = _queries("l2")
    _, r_j = js.search(jnp.asarray(q), 10, nprobes=3)
    _, r_t = ts.search(torch.from_numpy(q), 10, nprobes=3)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))


def test_wide_pool_takes_the_plain_scorer_and_agrees():
    """On CPU tensors a pool wider than `scan_topk`'s 256 goes through the
    plain score matrix; its first 256 equal the kernel route's. (On card
    tensors such a pool raises: tests/test_torch_cuda.py.)"""
    ts = FlatSegment.open(_write("port", "sq8", parts=0))
    q = torch.from_numpy(_queries("l2"))
    d_w, r_w = ts.search(q, 300)
    d_k, r_k = ts.search(q, 256)
    np.testing.assert_array_equal(r_w[:, :256].numpy(), r_k.numpy())
    np.testing.assert_allclose(d_w[:, :256].numpy(), d_k.numpy(), atol=DIST_ATOL)
