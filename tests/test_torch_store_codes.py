"""The port's persisted codes (`store_codes`: the `ivfq.*` sections a
compaction writes) against the JAX package's, on the CPU:

- `store_codes="sq8"`'s sections are `_encode_host` over the segment's
  membership, byte for byte the JAX writer's on the same membership; PQ and
  OPQ sections have the JAX layout (their codebooks differ after training);
- a lazily opened segment reads only the probed cluster blocks and the
  reranked rows from its store, and PQ transports reach SQ8's recall at a
  third of its bytes;
- a database written with `store_codes` by either package opens and serves
  through the cluster cache in the other, at the JAX tests' recall floors
  (0.9 for SQ8, 0.85 for PQ) and with the other package's answers at the
  same scan parameters (tests/torch_ivf_cache_common.py's `_at_port_params`).
"""

import numpy as np
import pytest
import torch

from torch_ivf_cache_common import (D, _at_port_params, _blob, _CountingStore, _engine_recall,
                                    _fixture, _jax_engine_at_port_params, _jax_kinds, _kinds,
                                    _served_recall, _write_db)
from vecgo_tpu.engine import Engine as JaxEngine
from vecgo_tpu.engine import EngineOptions as JaxEngineOptions
from vecgo_tpu.index.vamana import VamanaSegment as JaxVamanaSegment
from vecgo_tpu.ops import ivf_cache as jic
from vecgo_tpu.utils import testutil as tu
from vecgo_tpu_torch.blobstore import MemoryStore
from vecgo_tpu_torch.engine import Engine, EngineOptions
from vecgo_tpu_torch.index.vamana import VamanaSegment
from vecgo_tpu_torch.ops import ivf_cache as pic

torch.set_num_threads(1)


def test_store_codes_sections_are_the_jax_writers_bytes():
    """`ivfq.*` of store_codes=True (sq8): each writer's sections are
    `_encode_host` over its own membership, so on the same membership they
    are the JAX writer's bytes; either package opens the other's blob with
    the same `codes_stored`, keeps its persisted table, and serves it with
    the other package's recall at the same scan parameters, at least the JAX
    rule's."""
    from vecgo_tpu.storage import container as jcon

    x, _ = tu.clustered_vectors(5000, D, n_clusters=12, seed=95)
    jblob, pblob = _blob(x, 96, True), _blob(x, 96, True, "port")
    jmeta, jsec = jcon.unpack_container(jblob)
    pmeta, psec = jcon.unpack_container(pblob)
    assert jmeta["ivf"]["codes_stored"] == pmeta["ivf"]["codes_stored"] == "sq8"
    names = sorted(s for s in jsec if s.startswith("ivfq."))
    assert names == sorted(s for s in psec if s.startswith("ivfq.")) == [
        "ivfq.bn", "ivfq.cent", "ivfq.cnorm2", "ivfq.codes", "ivfq.scale"]
    for sec in (jsec, psec):
        want = jic._encode_host(np.asarray(sec["ivf.members"]), x)
        for name in names:
            assert np.asarray(sec[name]).tobytes() == np.asarray(want[name[5:]]).tobytes(), name
    q = x[:8]
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    for blob in (jblob, pblob):
        pseg, jseg = VamanaSegment.open(blob), JaxVamanaSegment.open(blob)
        assert pseg._ivfq is not None and jseg._ivfq is not None
        cc = pseg.cluster_cache(device="cpu")
        assert isinstance(cc.host, pic.MemHostTable) and cc.host._codes is pseg._ivfq["codes"]
        rec = _served_recall(pseg, q, ti)
        assert rec == _served_recall(_at_port_params(jseg), q, ti)
        assert rec >= _served_recall(JaxVamanaSegment.open(blob), q, ti) and rec >= 0.9


@pytest.mark.parametrize("kind", ["pq", "opq"])
def test_store_codes_pq_encode_matches_the_jax_layout(kind):
    """PQ/OPQ host encodes on the same membership: the same keys, dtypes and
    shapes as the JAX encode, the same centroids, norms and rows (the
    codebooks differ after training, and with them bn and scale)."""
    x, _, members = _fixture(4000, 16, 80, 81, 16, 82)
    want = jic._encode_host_pq(members, x, kind=kind, m=8, seed=7)
    got = pic._encode_host_pq(members, x, kind=kind, m=8, seed=7)
    assert sorted(got) == sorted(want)
    for name, b in want.items():
        a = got[name]
        assert (a is None) == (b is None) == (name == "rot" and kind == "pq"), name
        if b is not None:
            assert a.dtype == np.asarray(b).dtype and a.shape == np.asarray(b).shape, name
    for name in ("cent", "cnorm2", "rows"):
        assert got[name].tobytes() == np.asarray(want[name]).tobytes(), name


def test_store_codes_pq_writer_sections_match_the_jax_writer():
    """store_codes="pq" through both writers: the same section names,
    dtypes and shapes, and the same `codes_stored`."""
    from vecgo_tpu.storage import container as jcon

    x, _ = tu.clustered_vectors(4200, D, n_clusters=12, seed=95)
    jmeta, jsec = jcon.unpack_container(_blob(x, 96, "pq"))
    pmeta, psec = jcon.unpack_container(_blob(x, 96, "pq", "port"))
    assert jmeta["ivf"]["codes_stored"] == pmeta["ivf"]["codes_stored"] == "pq"
    names = sorted(s for s in jsec if s.startswith("ivfq."))
    assert names == sorted(s for s in psec if s.startswith("ivfq.")) == [
        "ivfq.bn", "ivfq.cb", "ivfq.cent", "ivfq.cnorm2", "ivfq.pq", "ivfq.scale"]
    for name in names:
        a, b = np.asarray(psec[name]), np.asarray(jsec[name])
        assert a.dtype == b.dtype and a.shape == b.shape, name


def test_store_codes_cloud_serving_is_block_granular():
    """tests/test_ivf_cache.py:187 through the port, on the JAX writer's
    blob: the lazy open skips the vectors and the code table, a batch reads
    only the probed cluster blocks and the reranked rows, a warm batch reads
    nothing, and recall is the JAX segment's over the same blob at the same
    scan parameters, at least the JAX rule's."""
    x, _ = tu.clustered_vectors(6000, D, n_clusters=16, seed=91)
    blob = _blob(x, 90, True)
    st = _CountingStore()
    st.put("seg.vgt", blob)
    seg = VamanaSegment.open_lazy(st, "seg.vgt")
    open_bytes = st.range_bytes
    assert seg._vectors_arr is None
    assert open_bytes < len(blob) - x.nbytes
    q = x[5:21]
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    rec = _served_recall(seg, q, ti)
    assert st.range_bytes - open_bytes < x.nbytes
    assert st.full_gets == 0
    assert isinstance(seg._ccache.host, pic.LazyHostTable)
    assert seg._vectors_arr is None
    assert rec >= 0.9 and rec == _served_recall(_at_port_params(JaxVamanaSegment.open(blob)), q, ti)
    assert rec >= _served_recall(JaxVamanaSegment.open(blob), q, ti)
    before = st.range_bytes
    seg.search_cached(torch.from_numpy(q), 10)
    assert st.range_bytes == before


def test_store_codes_lazy_rerank_matches_memory():
    """tests/test_ivf_cache.py:226, on the port's own blob."""
    x, _ = tu.clustered_vectors(5000, D, n_clusters=12, seed=92)
    blob = _blob(x, 93, True, "port")
    st = MemoryStore()
    st.put("seg.vgt", blob)
    lazy_seg = VamanaSegment.open_lazy(st, "seg.vgt")
    full_seg = VamanaSegment.open(blob)
    rng = np.random.default_rng(94)
    q = torch.from_numpy(x[rng.choice(len(x), 8, replace=False)])
    rows = torch.from_numpy(rng.integers(0, len(x), (8, 12)))
    rows[0, :3] = -1
    d_lazy = lazy_seg.rerank_host(q, rows).numpy()
    d_full = full_seg.rerank_host(q, rows).numpy()
    assert lazy_seg._vectors_arr is None
    np.testing.assert_array_equal(np.isinf(d_lazy), np.isinf(d_full))
    np.testing.assert_allclose(d_lazy, d_full, rtol=1e-6, atol=1e-6)


def test_store_codes_local_open_skips_reencode():
    """tests/test_ivf_cache.py:249 through the port, on the JAX writer's
    blob: the cache is built over the persisted sections, not re-encoded."""
    x, _ = tu.clustered_vectors(5000, D, n_clusters=12, seed=95)
    blob = _blob(x, 96, True)
    seg = VamanaSegment.open(blob)
    assert seg._ivfq is not None
    cc = seg.cluster_cache(device="cpu")
    assert isinstance(cc.host, pic.MemHostTable)
    assert cc.host._codes is seg._ivfq["codes"]
    q = x[:8]
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    assert _served_recall(seg, q, ti) >= 0.9


def test_store_codes_pq_transport_economics():
    """tests/test_ivf_cache.py:274 on the port's own blobs: PQ/OPQ
    transports reach SQ8's recall (within 0.05) at a third of its store
    bytes. The port's `h2d_bytes` counts every byte it copies, the blocks'
    rows too (4 bytes a slot, which the JAX stat leaves out), so at d = 32
    and m = 8 a PQ slot moves 8 + 8 bytes against SQ8's 32 + 8: 2.5 times
    fewer, less the per-cluster centroid and scale."""
    x, _ = tu.clustered_vectors(6000, D, n_clusters=16, seed=91)
    q = torch.from_numpy(x[5:21])
    _, ti = tu.brute_force_knn(x[5:21], x, 10, "l2")

    def serve(kind, kk):
        st = MemoryStore()
        st.put("s", _blob(x, 7, kind, "port"))
        seg = VamanaSegment.open_lazy(st, "s")
        _, rows = seg.search_cached(q, kk)
        de = seg.rerank_host(q, rows).numpy()
        got = np.take_along_axis(rows.numpy(), np.argsort(de, 1), 1)[:, :10]
        assert seg._vectors_arr is None
        cc = seg._ccache
        return tu.recall_at_k(got, ti), cc.stats["h2d_bytes"], cc.host.store_bytes

    rec8, h2d8, sb8 = serve("sq8", 40)
    for kind in ("pq", "opq"):
        rec, h2d, sb = serve(kind, 160)
        assert rec >= rec8 - 0.05, (kind, rec, rec8)
        assert h2d * 2.4 < h2d8, (kind, h2d, h2d8)
        assert sb * 2.5 < sb8, (kind, sb, sb8)


@pytest.mark.parametrize("kind", ["sq8", "pq"])
def test_engine_store_codes_cloud_reopen(tmp_path, kind):
    """tests/test_ivf_cache.py:311 through the port: the JAX engine's
    compaction persists codes; the port's engine reopens the store under a
    budget, defers the vectors and serves the over-budget graph segment
    through store-fed cluster blocks at the JAX test's floor."""
    x, _ = tu.clustered_vectors(6000, D, n_clusters=16, seed=97)
    path = str(tmp_path / "db")
    ids, (cache, full) = _write_db(path, "jax", x, store_codes=kind)
    st = _CountingStore(path)  # the JAX directory's blobs, as in a remote store
    e2 = Engine.open(st, EngineOptions(dim=D, device="cpu", hbm_budget_bytes=(cache + full) // 2))
    seg2 = e2._segments[0].segment
    assert seg2._vectors_arr is None and _kinds(e2) == ["graph_cached"]
    st.range_bytes = st.full_gets = 0
    q = x[5:21]
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    rec, _ = _engine_recall(e2.search_batch(q, k=10), ids, ti)
    assert seg2._ccache is not None and seg2._ccache.stats["batches"] > 0
    assert isinstance(seg2._ccache.host, pic.LazyHostTable)
    assert seg2._vectors_arr is None
    blob_len = len(st.get(e2._segments[0].info.name))
    assert st.range_bytes < blob_len - x.nbytes
    assert rec >= (0.9 if kind == "sq8" else 0.85)
    e2.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["sq8", "pq"])
def test_store_codes_db_directory_serves_in_the_other_package(tmp_path, writer, kind):
    """A database written with store_codes by either package opens in both
    under a budget that plans graph_cached; both serve it from the
    persisted table with the same answers at the same scan parameters."""
    x, _ = tu.clustered_vectors(6000, D, n_clusters=16, seed=97)
    path = str(tmp_path / "db")
    ids, (cache, full) = _write_db(path, writer, x, store_codes=kind)
    budget = (cache + full) // 2
    pe = Engine.open(path, EngineOptions(device="cpu", hbm_budget_bytes=budget))
    je = _jax_engine_at_port_params(JaxEngine.open(path, JaxEngineOptions(
        hbm_budget_bytes=budget)))
    assert _kinds(pe) == _jax_kinds(je) == ["graph_cached"]
    q = x[5:21]
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    rec, got = _engine_recall(pe.search_batch(q, k=10), ids, ti)
    jrec, jgot = _engine_recall(je.search_batch(q, k=10), ids, ti)
    for e in (pe, je):
        seg = e._segments[0].segment
        assert seg._ccache is not None and seg._ccache.stats["batches"] == 1
    assert abs(rec - jrec) <= 0.01 and np.mean(got == jgot) >= 0.97, (rec, jrec)
    assert rec >= (0.9 if kind == "sq8" else 0.85)
    pe.close()
    je.close()
