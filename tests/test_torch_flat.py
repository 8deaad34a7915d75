"""The port's flat segment against the JAX package's.

Both writers must produce the same container bytes, each package must open
the other's segment, and both search profiles (bf16 pool k+8 and f32 pool
k+16, each with the exact fp32 rerank) must give the JAX segment's ids and
distances (atol 1e-4; the JAX scan is exact below 16,384 rows, where it uses
`lax.top_k`). Runs on the CPU, where `scan_topk` takes its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vecgo_tpu.index.flat import FlatSegment as JaxFlatSegment
from vecgo_tpu.index.flat import FlatWriter as JaxFlatWriter
from vecgo_tpu import metadata as jmd
from vecgo_tpu.model import Metric
from vecgo_tpu_torch import metadata as pmd
from vecgo_tpu_torch.convert import segment_from_jax
from vecgo_tpu_torch.index.flat import FlatSegment, FlatWriter
from vecgo_tpu_torch.model import Metric as PMetric

torch.set_num_threads(1)

N, D = 3000, 32


def _rows(seed=11):
    r = np.random.default_rng(seed)
    x = r.standard_normal((N, D)).astype(np.float32)
    ids = np.arange(100, 100 + N, dtype=np.int64)
    docs = [{"u": int(v), "tag": f"t{v % 3}"} for v in r.integers(0, 100, N)]
    pays = [bytes([i % 251]) * (i % 4) for i in range(N)]
    lsns = np.arange(1, N + 1, dtype=np.int64)
    return x, ids, docs, pays, lsns


def _write(writer_cls, metric):
    """Container bytes from either package's writer (each takes its own
    package's Metric)."""
    x, ids, docs, pays, lsns = _rows()
    w = writer_cls(D, metric if writer_cls is JaxFlatWriter else PMetric(metric.value))
    w.add_batch(x, ids, docs, pays, lsns)
    return w.finish()


@pytest.mark.parametrize("metric", [Metric.L2, Metric.COSINE])
def test_writers_are_byte_identical_and_cross_open(metric):
    jax_bytes = _write(JaxFlatWriter, metric)
    port_bytes = _write(FlatWriter, metric)
    assert jax_bytes == port_bytes
    a = FlatSegment.open(jax_bytes, seg_id=3)
    b = JaxFlatSegment.open(port_bytes, seg_id=3)
    np.testing.assert_array_equal(a.vectors, b.vectors)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.lsns, b.lsns)
    for row in (0, 17, N - 1):
        assert a.doc(row) == b.doc(row) and a.payload(row) == b.payload(row)
    np.testing.assert_array_equal(a.filter_mask(pmd.eq("tag", "t1")),
                                  b.filter_mask(jmd.eq("tag", "t1")))


def _queries(seg_metric, seed=12):
    q = np.random.default_rng(seed).standard_normal((9, D)).astype(np.float32)
    if seg_metric == Metric.COSINE:  # normalized upstream, as the planner does
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q


@pytest.mark.parametrize("metric", [Metric.L2, Metric.COSINE])
@pytest.mark.parametrize("scan_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_search_profiles_match_jax(metric, scan_dtype, masked):
    data = _write(JaxFlatWriter, metric)
    js = JaxFlatSegment.open(data)
    ts = FlatSegment.open(data)
    q = _queries(metric)
    mask = np.random.default_rng(13).random(N) < 0.3 if masked else None
    d_j, r_j = js.search(jnp.asarray(q), 10, mask=mask, scan_dtype=scan_dtype)
    d_t, r_t = ts.search(torch.from_numpy(q), 10, mask=mask, scan_dtype=scan_dtype)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-4)
    if masked:
        assert mask[r_t.numpy()].all()


def test_segment_from_jax_searches_the_same():
    js = JaxFlatSegment.open(_write(JaxFlatWriter, Metric.L2), seg_id=5)
    ts = segment_from_jax(js, "cpu")
    assert ts.seg_id == 5 and ts.n == js.n and ts.doc(7) == js.doc(7)
    q = _queries(Metric.L2)
    d_j, r_j = js.search(jnp.asarray(q), 10)
    d_t, r_t = ts.search(torch.from_numpy(q), 10)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-4)
    rows = torch.tensor([[0, 5, -1]])
    np.testing.assert_allclose(
        ts.rerank(torch.from_numpy(q[:1]), rows).numpy(),
        np.asarray(js.rerank(jnp.asarray(q[:1]), jnp.asarray(rows.numpy()))), atol=1e-4,
    )


def test_not_ported_paths_raise():
    """What raised before flat IVF, the quantizers and streaming were ported
    now works; a segment's cluster cache is a graph segment's and still to
    come (tests/test_torch_graph_segment.py holds that)."""
    x, ids, docs, pays, lsns = _rows()
    w = FlatWriter(D, quantizer="sq8", ivf_partitions=4, device="cpu")
    w.add_batch(x, ids, docs, pays, lsns)
    seg = FlatSegment.open(w.finish())
    assert seg.quant.kind == "sq8" and seg.meta["ivf"]["partitions"] == 4
    q = torch.from_numpy(_queries(Metric.L2))
    d, rows = seg.search(q, 5)
    d_s, rows_s = seg.search_streaming(q, 5, block_rows=512)
    np.testing.assert_array_equal(rows_s.numpy(), rows.numpy())
    np.testing.assert_allclose(d_s.numpy(), d.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="unknown quantizer"):
        FlatWriter(D, quantizer="sq9").finish()
