"""The beyond-device tier of the port: streaming scans under a device budget.

The cases of tests/test_beyond_hbm.py run against the port's engine
(device="cpu") and, on the same rows, against the JAX engine: a streamed
search must return the resident search's ids, and the JAX engine's. Also the
pieces below the engine: `streaming_topk_scored` against
`blockwise_topk_scored`, `rerank_host_rows` against the JAX function
(atol 1e-4: IEEE f32 against the TPU-style HIGHEST product, |q|^2 + |x|^2 up
to ~100), the stream transports, and a database directory with a quantizer
and flat IVF partitions moving between the packages.
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
from vecgo_tpu.index import common as jcommon
from vecgo_tpu.utils import testutil as tu
from vecgo_tpu_torch import metadata as pmd
from vecgo_tpu_torch import quantization as Q
from vecgo_tpu_torch.engine import Engine, EngineOptions
from vecgo_tpu_torch.engine import search as S
from vecgo_tpu_torch.engine.resource import DeviceBudget
from vecgo_tpu_torch.errors import ErrBackpressure
from vecgo_tpu_torch.index import common
from vecgo_tpu_torch.index.vamana import VamanaSegment
from vecgo_tpu_torch.model import Metric, SearchOptions
from vecgo_tpu_torch.ops import topk as T

torch.set_num_threads(1)

D = 24


def _mk(**kw):
    kw.setdefault("dim", D)
    kw.setdefault("flush_threshold", 10_000_000)
    kw.setdefault("graph_threshold", 10**9)
    return Engine.open(vg.Memory().store, EngineOptions(device="cpu", **kw), create=True)


def _mk_jax(**kw):
    kw.setdefault("dim", D)
    kw.setdefault("flush_threshold", 10_000_000)
    kw.setdefault("graph_threshold", 10**9)
    return JaxEngine.open(JaxMemoryStore(), JaxEngineOptions(**kw), create=True)


def _ids(res):
    return [[c.id for c in r] for r in res]


def _kinds(e, **kw):
    """The planner's source kinds for one search of the current snapshot."""
    snap = e.snapshot()
    try:
        plan = S._plan_snapshot(snap, SearchOptions(k=10, **kw), e.options, e._device_budget)
    finally:
        snap.release()
    return [s.kind for s in plan.sources]


@pytest.mark.parametrize("transport", ["sq8", "pq"])
def test_streaming_equals_resident_flat(transport):
    x = (tu.gaussian_vectors(3000, D, seed=70) if transport == "sq8"
         else tu.clustered_vectors(3000, D, n_clusters=12, seed=170)[0])
    q = tu.gaussian_vectors(8, D, seed=71)
    e1 = _mk()
    e1.insert_batch(x)
    e1.commit()
    want = _ids(e1.search_batch(q, k=10))
    # Budget smaller than any segment: every search must stream.
    e2 = _mk(hbm_budget_bytes=1024, stream_transport=transport)
    e2.insert_batch(x)
    e2.commit()
    assert _kinds(e2) == ["flat_stream"]
    got = _ids(e2.search_batch(q, k=10))
    if transport == "sq8":
        assert got == want
    else:  # exact-tie rows may swap under another pool width
        assert all(set(g) == set(w) for g, w in zip(got, want))
    st = e2.stats()["hbm"]
    assert st["resident"] == 0 and st["used_bytes"] == 0 and st["budget_bytes"] == 1024
    assert e1.stats()["hbm"] is None
    # the JAX engine streams the same rows to the same answer
    ej = _mk_jax(hbm_budget_bytes=1024, stream_transport=transport)
    ej.insert_batch(x)
    ej.commit()
    jgot = _ids(ej.search_batch(q, k=10))
    assert all(set(g) == set(j) for g, j in zip(got, jgot))
    if transport == "sq8":
        assert got == jgot
    assert ej.stats()["hbm"] == st


@pytest.mark.parametrize("transport", ["sq8", "pq"])
def test_streaming_vamana_brute_fallback(transport):
    x, _ = tu.clustered_vectors(3000, D, n_clusters=16, seed=74 if transport == "sq8" else 172)
    e = _mk(graph_threshold=2000, compaction_threshold=2, hbm_budget_bytes=1024,
            stream_transport=transport)
    ids = e.insert_batch(x[:1500])
    e.commit()
    e.insert_batch(x[1500:])
    e.commit()  # auto compaction -> a vamana segment over the budget
    (h,) = e._segments
    assert type(h.segment) is VamanaSegment
    # The planner streams it and asks the segment for no cluster cache.
    assert _kinds(e) == ["graph_stream"]
    assert h.segment.device_bytes() > 1024
    q = x[7:15]
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    got = _ids(e.search_batch(q, k=10))
    want = [[ids[0] + j for j in row] for row in ti]
    if transport == "sq8":
        assert got == want  # the streamed scan with its exact rerank is exact
    else:
        assert all(set(g) == set(w) for g, w in zip(got, want))
    st = e.stats()["hbm"]
    assert st["resident"] == 0 and st["used_bytes"] == 0


def test_streaming_quantized_flat_with_filter():
    x = tu.gaussian_vectors(2000, D, seed=72)
    mds = [{"cat": f"c{i % 3}"} for i in range(2000)]
    q = tu.gaussian_vectors(4, D, seed=73)
    e1 = _mk(quantizer="sq8")
    e1.insert_batch(x, mds)
    e1.commit()
    want = _ids(e1.search_batch(q, k=5, filter=pmd.eq("cat", "c1")))
    e2 = _mk(quantizer="sq8", hbm_budget_bytes=1024)
    e2.insert_batch(x, mds)
    e2.commit()
    assert _kinds(e2, filter=pmd.eq("cat", "c1")) == ["flat_stream"]
    assert _ids(e2.search_batch(q, k=5, filter=pmd.eq("cat", "c1"))) == want
    ej = _mk_jax(quantizer="sq8", hbm_budget_bytes=1024)
    ej.insert_batch(x, mds)
    ej.commit()
    assert _ids(ej.search_batch(q, k=5, filter=jmd.eq("cat", "c1"))) == want
    # every returned row passes the filter
    cats = {i + 1: m["cat"] for i, m in enumerate(mds)}
    assert all(cats[i] == "c1" for row in want for i in row)


def test_lru_eviction_between_segments():
    x = tu.gaussian_vectors(4000, D, seed=75)
    e = _mk(compaction_threshold=10**9)
    e.insert_batch(x[:2000])
    e.commit()
    e.insert_batch(x[2000:])
    e.commit()
    seg_bytes = e._segments[0].segment.device_bytes()
    assert seg_bytes == 2000 * (D * 4 + 4 + D * 2)
    # Budget fits exactly one segment: searches alternate residency.
    e._device_budget = DeviceBudget(int(seg_bytes * 1.5))
    q = tu.gaussian_vectors(4, D, seed=76)
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    got = _ids(e.search_batch(q, k=10))
    first_id = min(int(s.segment.ids.min()) for s in e._segments)
    assert got == [[first_id + j for j in row] for row in ti]
    st = e._device_budget.stats()
    assert st["resident"] <= 1 and st["evictions"] >= 1


def test_memory_backpressure():
    e = _mk(memory_limit_bytes=10_000)
    x = tu.gaussian_vectors(200, D, seed=77)
    with pytest.raises(ErrBackpressure):
        e.insert_batch(x)
    e2 = _mk(memory_limit_bytes=10_000_000)
    e2.insert_batch(x)
    e2.commit()
    assert e2.stats()["memtable_bytes"] == 0


@pytest.mark.parametrize("coded", [False, True], ids=["tableless", "coded"])
def test_graph_segment_under_a_budget_that_admits_it_stays_resident(coded):
    """The fault this slice repaired: any device budget with a graph segment
    raised AttributeError (the planner called device_bytes / cache_bytes /
    release_cache, which the port's VamanaSegment lacked). `device_bytes`
    says what the device state really takes, with and without a coded table."""
    x, _ = tu.clustered_vectors(3000, D, n_clusters=16, seed=74)
    e = _mk(graph_threshold=2000, compaction_threshold=2, hbm_budget_bytes=1 << 30,
            serve_ivf_min_n=1000 if coded else 4096)
    ids = e.insert_batch(x[:1500])
    e.commit()
    e.insert_batch(x[1500:])
    e.commit()
    (h,) = e._segments
    assert type(h.segment) is VamanaSegment and _kinds(e) == ["graph"]
    assert (h.segment.ivf_members is not None) == coded
    got, _ = e.search_arrays(x[7:15], k=10)
    assert (got[:, 0] == np.arange(7, 15) + ids[0]).all()
    st = e.stats()["hbm"]
    assert st["resident"] == 1 and st["used_bytes"] == h.segment.device_bytes()
    held = 0
    for name, v in h.segment.device_state("cpu").items():
        if name != "entry":  # one int64, not counted
            held += sum(t.numel() * t.element_size()
                        for t in (v if isinstance(v, tuple) else (v,)) if t is not None)
    assert held == h.segment.device_bytes()


@pytest.mark.parametrize("kind", ["sq8", "pq", "rabitq"])
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_streaming_scan_equals_blockwise_scan(kind, masked):
    r = np.random.default_rng(80)
    x = r.standard_normal((5000, D)).astype(np.float32)
    q = torch.from_numpy(r.standard_normal((6, D)).astype(np.float32))
    quant = Q.create(kind, device="cpu", dim=D, **({"m": 6} if kind == "pq" else {}))
    quant.train(x)
    enc = quant.encode(x)
    dev = {k: common.enc_tensor(v, "cpu") for k, v in enc.items()}
    mask = torch.from_numpy(r.random(5000) < 0.3) if masked else None
    scanner = T.BlockScanner(quant, Metric.L2)
    d_b, r_b = T.blockwise_topk_scored(q, dev, 5000, 20, scanner, mask=mask, block_rows=700)
    one_d, one_r = T.blockwise_topk_scored(q, dev, 5000, 20, scanner, mask=mask)
    np.testing.assert_array_equal(r_b.numpy(), one_r.numpy())  # block size changes nothing
    d_s, r_s = T.streaming_topk_scored(q, enc, 5000, 20, scanner, mask=mask, block_rows=700)
    np.testing.assert_array_equal(r_s.numpy(), r_b.numpy())
    np.testing.assert_allclose(d_s.numpy(), d_b.numpy(), atol=1e-5)
    d_r, r_r = T.streaming_topk_scored(q, enc, 5000, 20, scanner, mask=mask, block_rows=700,
                                       rows=(1000, 2500))
    assert ((r_r >= 1000) & (r_r < 2500) | (r_r == -1)).all()
    d_w, r_w = T.blockwise_topk_scored(q, dev, 5000, 20, scanner, mask=mask, rows=(1000, 2500))
    np.testing.assert_array_equal(r_r.numpy(), r_w.numpy())


@pytest.mark.parametrize("metric", ["l2", "dot", "cosine"])
def test_rerank_host_rows_matches_jax(metric):
    r = np.random.default_rng(81)
    x = r.standard_normal((800, D)).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    rn = (x * x).sum(1)
    q = r.standard_normal((5, D)).astype(np.float32)
    rows = r.integers(0, 800, (5, 12))
    rows[0, 3] = rows[4, 11] = -1
    want = np.asarray(jcommon.rerank_host_rows(jnp.asarray(q), jnp.asarray(rows.astype(np.int32)),
                                               x, rn, metric))
    got = common.rerank_host_rows(torch.from_numpy(q), torch.from_numpy(rows), x, rn,
                                  Metric(metric)).numpy()
    assert np.isinf(got[0, 3]) and np.isinf(got[4, 11])
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-4)


def test_stream_states_keep_the_transport_settings():
    x, _ = tu.clustered_vectors(3000, D, n_clusters=12, seed=170)
    enc, scanner = common.sq8_stream_state(x, Metric.L2, device="cpu")
    assert enc["codes"].dtype == np.uint8 and enc["codes"].shape == (3000, D)
    jenc, _ = jcommon.sq8_stream_state(x, "l2")
    assert enc["codes"].tobytes() == np.asarray(jenc["codes"]).tobytes()  # numpy on both sides
    assert scanner.quant.kind == "sq8"
    enc, scanner = common.pq_stream_state(x, Metric.L2, device="cpu")
    assert scanner.quant.m == D // 2 and enc["codes"].shape == (3000, D // 2)  # m = d/2
    assert common.pq_stream_state(x[:, :6], Metric.L2, device="cpu")[1].quant.m == 4
    raw = common.raw_scanner(Metric.L2)
    q = torch.from_numpy(x[:3] + 0.001)
    blk = {"vectors": torch.from_numpy(x), "rnorm2": torch.from_numpy((x * x).sum(1))}
    _, rows = raw(q, 1)(blk, None)
    assert rows[:, 0].tolist() == [0, 1, 2]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_quantized_partitioned_db_directory_opens_in_the_other_package(tmp_path, writer):
    """quantizer="sq8" with flat IVF partitions at flush: either package
    opens the other's directory and returns the same ids, resident, probed
    and streamed."""
    r = np.random.default_rng(82)
    cent = r.standard_normal((30, D)).astype(np.float32)
    x = (cent[r.integers(0, 30, 5000)] + 0.3 * r.standard_normal((5000, D))).astype(np.float32)
    q = (cent[r.integers(0, 30, 6)] + 0.3 * r.standard_normal((6, D))).astype(np.float32)
    path = str(tmp_path / "db")
    kw = dict(dim=D, quantizer="sq8", flush_ivf_partitions=True, ivf_rows_per_partition=1000,
              flush_threshold=10**9)
    if writer == "jax":
        db = vg.DB(JaxEngine.open(path, JaxEngineOptions(**kw), create=True))
    else:
        db = vg.Open(vg.Local(path), vg.Create(device="cpu", **kw))
    ids = db.insert_batch(x, [{"i": i % 10} for i in range(len(x))])
    db.commit()
    db.delete(ids[3])
    db.commit()
    seg = db.engine._segments[0].segment
    assert seg.quant.kind == "sq8" and seg.meta["ivf"]["partitions"] == 5
    md_w, md_o = (jmd, pmd) if writer == "jax" else (pmd, jmd)
    cases = [dict(), dict(nprobes=2), dict(nprobes=5), dict(refine_factor=4)]
    want = [db.search_arrays(q, k=7, **c)[0] for c in cases]
    want_f = db.search_arrays(q, k=7, filter=md_w.eq("i", 4))[0]
    np.testing.assert_array_equal(want[0], want[2])  # probing every partition is the full scan
    db.close()
    for budget in (0, 1024):
        if writer == "jax":
            other = vg.Open(vg.Local(path), EngineOptions(device="cpu", hbm_budget_bytes=budget))
        else:
            other = vg.DB(JaxEngine.open(path, JaxEngineOptions(hbm_budget_bytes=budget)))
        assert other.engine.options.quantizer == "sq8"
        for c, w in zip(cases, want):
            np.testing.assert_array_equal(other.search_arrays(q, k=7, **c)[0], w)
        np.testing.assert_array_equal(
            other.search_arrays(q, k=7, filter=md_o.eq("i", 4))[0], want_f)
        assert ids[3] not in other.search_arrays(x[3:4], k=7)[0]
        assert other.get(ids[5]).metadata == {"i": 5}
        other.close()
