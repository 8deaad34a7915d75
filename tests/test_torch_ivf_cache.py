"""The port's cluster cache (ops/ivf_cache.py, `graph_cached`) and persisted
codes (`store_codes`) against the JAX package's.

The fixtures of tests/test_ivf_cache.py run through the port on the CPU, on
the same seeded numpy inputs, beside the JAX functions:

- the host encodes are numpy on both sides, so `_encode_host`'s arrays (the
  `ivfq.*` sections of `store_codes="sq8"`) are byte for byte the JAX
  package's; PQ codebooks differ after training (another k-means), so the PQ
  cases carry the JAX host table across (`convert.host_table_from_jax`);
- with every probed cluster cached, the cached scan equals `ivf_scan` over
  the full table: distances within 1e-4 of |q-c|^2 + |x^-c|^2 (the same
  f32 sums over bf16 products), ids equal up to ties;
- the LRU order (cluster -> slot), hits, misses and `dropped_probes` equal
  the JAX cache's batch for batch (the probes are the same bf16 products);
- `search_cached` scans 16 candidates a probed cluster (64 for PQ), where
  the JAX package's rule gives 8 (32): a query whose neighbours crowd one
  cluster loses those past the 8th there. So answers are compared with the
  JAX cache's scan and dedup at the port's parameters
  (`vecgo_tpu_torch.index.vamana.cached_scan_params`, `_at_port_params`),
  to the digit, and the port's recall is held to the JAX tests' floors, 0.9
  for SQ8 and 0.85 for PQ, on either writer's segments, and to at least the
  JAX rule's recall over the same blob;
- a database written with `store_codes` by either package opens and serves
  through the cluster cache in the other.
"""

import os

import numpy as np
import pytest
import torch

import vecgo_tpu_torch as vg
from vecgo_tpu.blobstore import MemoryStore as JaxMemoryStore
from vecgo_tpu.engine import Engine as JaxEngine
from vecgo_tpu.engine import EngineOptions as JaxEngineOptions
from vecgo_tpu.index.vamana import VamanaSegment as JaxVamanaSegment
from vecgo_tpu.index.vamana import VamanaWriter as JaxVamanaWriter
from vecgo_tpu.ops import ivf as jivf
from vecgo_tpu.ops import ivf_cache as jic
from vecgo_tpu.utils import testutil as tu
from vecgo_tpu_torch import convert
from vecgo_tpu_torch.blobstore import MemoryStore
from vecgo_tpu_torch.engine import Engine, EngineOptions
from vecgo_tpu_torch.engine import search as S
from vecgo_tpu_torch.index.vamana import VamanaSegment, VamanaWriter, cached_scan_params
from vecgo_tpu_torch.model import SearchOptions
from vecgo_tpu_torch.ops import ivf as pivf
from vecgo_tpu_torch.ops import ivf_cache as pic
from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan

torch.set_num_threads(1)

D = 32
CODED_REL_TOL = 1e-4


def _recall(got_rows, want_rows):
    hits = sum(len(set(map(int, g[g >= 0])) & set(map(int, w)))
               for g, w in zip(got_rows, want_rows))
    return hits / (len(want_rows) * len(want_rows[0]))


def _fixture(n, clusters, seed, q_seed, n_q, members_seed):
    x, _ = tu.clustered_vectors(n, D, n_clusters=clusters, seed=seed)
    rng = np.random.default_rng(q_seed)
    q = (x[rng.choice(len(x), n_q, replace=False)]
         + 0.02 * rng.standard_normal((n_q, D))).astype(np.float32)
    _, members = jivf.build_ivf_table(x, capacity=256, seed=members_seed)
    return x, q, np.asarray(members)


def _full_table(h) -> pivf.IVFCodedTable:
    """The whole host table as the port's resident coded table."""
    t = {name: torch.from_numpy(np.ascontiguousarray(h[name]))
         for name in ("codes", "scale", "bn", "xn", "rows", "cent", "cnorm2")}
    return pivf.IVFCodedTable(codes=t["codes"], scale=t["scale"], bnorm2=t["bn"],
                              xnorm2=t["xn"], rows=t["rows"],
                              slot_of_row=torch.zeros(1, dtype=torch.int32),
                              centroids=t["cent"], cnorm2=t["cnorm2"])


def _lru(cc):
    return list(cc._lru.items())


def test_encode_host_is_byte_for_byte_the_jax_encode():
    x, _, members = _fixture(4000, 16, 80, 81, 16, 82)
    want = jic._encode_host(members, x)
    got = pic._encode_host(members, x)
    assert sorted(got) == sorted(want)
    for name in want:
        a, b = np.asarray(got[name]), np.asarray(want[name])
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def test_cached_scan_matches_full_table():
    """tests/test_ivf_cache.py:27. With the cache holding every probed
    cluster, probe_and_scan is ivf_scan over the whole table; the second
    identical batch is all hits and uploads nothing; the JAX cache returns
    the same candidates."""
    x, q, members = _fixture(4000, 16, 80, 81, 16, 82)
    k = members.shape[0]
    h = pic._encode_host(members, x)
    cc = pic.ClusterCachedTable(members, x, cache_clusters=k + 8, device="cpu")
    d_c, r_c = cc.probe_and_scan(q, n_probe=4, kk=8, qcap=16)
    d_f, r_f = pivf.ivf_scan(torch.from_numpy(q), _full_table(h), n_probe=4, kk=8, qcap=16)
    assert cc.stats["dropped_probes"] == 0
    fin = torch.isfinite(d_f)
    assert torch.equal(torch.isfinite(d_c), fin)
    qn = (torch.from_numpy(q) ** 2).sum(1)
    tol = CODED_REL_TOL * float(qn.max() + torch.from_numpy(h["bn"])[torch.isfinite(
        torch.from_numpy(h["bn"]))].max() + torch.from_numpy(h["cnorm2"]).max())
    assert float((d_c - d_f).abs()[fin].max()) <= tol
    # Ids equal except where two slots' distances tie (the distances at
    # every rank agree within the tolerance above).
    diff = (r_c != r_f) & fin
    assert int(diff.sum()) <= 0.01 * int(fin.sum())

    h2d = cc.stats["h2d_bytes"]
    cc.probe_and_scan(q, n_probe=4, kk=8, qcap=16)
    assert cc.stats["h2d_bytes"] == h2d
    assert cc.stats["misses"] > 0 and cc.stats["hits"] > 0
    assert cc.stats["dropped_probes"] == 0

    jc = jic.ClusterCachedTable(members, x, cache_clusters=k + 8)
    jd, jr = jc.probe_and_scan(q, n_probe=4, kk=8, qcap=16)
    jr = np.asarray(jr)
    for b in range(len(q)):
        ref = set(map(int, jr[b][jr[b] >= 0]))
        got = set(map(int, r_c[b][r_c[b] >= 0].tolist()))
        assert len(ref & got) / max(1, len(ref)) >= 0.95
    np.testing.assert_allclose(np.sort(d_c.numpy(), 1)[:, :8], np.sort(np.asarray(jd), 1)[:, :8],
                               rtol=2e-3, atol=2e-3)


def test_cached_scan_small_cache_lru_matches_jax_batch_for_batch():
    """tests/test_ivf_cache.py:68, over four batches: a cache of 16 clusters
    keeps its device arrays fixed, and its LRU order, hits, misses and
    dropped probes equal the JAX cache's after every batch."""
    x, q, members = _fixture(6000, 24, 83, 84, 12, 85)
    k = members.shape[0]
    assert k > 16
    cc = pic.ClusterCachedTable(members, x, cache_clusters=16, group=8, device="cpu")
    jc = jic.ClusterCachedTable(members, x, cache_clusters=16, group=8)
    rng = np.random.default_rng(86)
    batches = [q, x[rng.choice(len(x), 12, replace=False)], q[::-1].copy(), q[:5]]
    for qb in batches:
        for n_probe in (4, 8):
            d1, r1 = cc.probe_and_scan(qb, n_probe=n_probe, kk=8)
            jc.probe_and_scan(qb, n_probe=n_probe, kk=8)
            assert _lru(cc) == _lru(jc)
            for key in ("hits", "misses", "dropped_probes", "batches"):
                assert cc.stats[key] == jc.stats[key], key
    assert cc.stats["misses"] > 0 and cc.stats["dropped_probes"] > 0
    assert cc.codes_c.shape[0] == cc.c <= 16 + 8
    _, r1 = cc.probe_and_scan(q, n_probe=4, kk=8)
    _, ti = tu.brute_force_knn(q, x, 5, "l2")
    assert _recall(r1.numpy(), ti) >= 0.5


def test_cached_scan_row_mask():
    """tests/test_ivf_cache.py:90."""
    x, _ = tu.clustered_vectors(3000, D, n_clusters=12, seed=86)
    rng = np.random.default_rng(87)
    q = x[rng.choice(len(x), 8, replace=False)].astype(np.float32)
    _, members = jivf.build_ivf_table(x, capacity=256, seed=88)
    members = np.asarray(members)
    cc = pic.ClusterCachedTable(members, x, cache_clusters=members.shape[0] + 8, device="cpu")
    mask = np.zeros(len(x), bool)
    mask[::2] = True
    _, rows = cc.probe_and_scan(q, n_probe=6, kk=8, row_mask=mask)
    rows = rows.numpy()
    assert (rows >= 0).any() and (rows[rows >= 0] % 2 == 0).all()
    jc = jic.ClusterCachedTable(members, x, cache_clusters=members.shape[0] + 8)
    _, jrows = jc.probe_and_scan(q, n_probe=6, kk=8, row_mask=mask)
    jrows = np.asarray(jrows)
    assert all(set(a[a >= 0]) == set(b[b >= 0]) for a, b in zip(rows, jrows))


@pytest.mark.parametrize("kind", ["pq", "opq"])
def test_pq_admission_decodes_the_jax_host_table(kind):
    """A JAX PQ/OPQ host table carried into the port: the admission-time
    decode writes the JAX cache's int8 blocks (PQ exactly; OPQ's
    un-rotation is an f32 product, rounded in another order, so a code may
    move by one at a rounding boundary) and the caches agree slot for slot."""
    x, q, members = _fixture(4000, 16, 80, 81, 16, 82)
    h = jic._encode_host_pq(members, x, kind=kind, m=8, seed=7)
    k = members.shape[0]
    cc = pic.ClusterCachedTable(host=convert.host_table_from_jax(h), cache_clusters=k + 8,
                                device="cpu")
    jc = jic.ClusterCachedTable(host=jic.MemHostTable(h), cache_clusters=k + 8)
    d_c, r_c = cc.probe_and_scan(q, n_probe=4, kk=8)
    d_j, r_j = jc.probe_and_scan(q, n_probe=4, kk=8)
    assert _lru(cc) == _lru(jc)
    codes_p, codes_j = cc.codes_c.numpy().astype(np.int16), np.asarray(jc.codes_c, np.int16)
    diff = np.abs(codes_p - codes_j)
    if kind == "pq":
        assert diff.max() == 0
    else:
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    np.testing.assert_array_equal(cc.rows_c.numpy(), np.asarray(jc.rows_c))
    np.testing.assert_array_equal(cc.bn_c.numpy(), np.asarray(jc.bn_c))
    r_j = np.asarray(r_j)
    same = sum(len(set(a[a >= 0].tolist()) & set(b[b >= 0])) for a, b in zip(r_c, r_j))
    assert same >= 0.97 * sum(len(set(b[b >= 0])) for b in r_j)


def _blob(x, seed, kind, package="jax"):
    """A segment of rows x written with `store_codes=kind` by one package."""
    if package == "jax":
        w = JaxVamanaWriter(x.shape[1], store_codes=kind, ivf_capacity=256, seed=seed)
    else:
        w = VamanaWriter(x.shape[1], store_codes=kind, ivf_capacity=256, seed=seed,
                         device="cpu")
    w.add_batch(x, np.arange(len(x)))
    return w.finish()


def _at_port_params(jseg):
    """The JAX segment, its search_cached run at the port's scan parameters
    (the JAX rule's probes and pool, the port's kk) through the JAX cache
    and dedup, so that both packages answer at the same parameters."""
    import jax.numpy as jnp
    from vecgo_tpu.ops import beam as jbeam

    def search_cached(q, k, mask=None, ef=0):
        cc = jseg.cluster_cache()
        ef = max(ef or max(jseg.DEFAULT_EF_SEARCH, k), k)
        n_probe, kk, pool = cached_scan_params(k, ef, cc.k, cc.s, cc.host.kind == "pq")
        sd, srows = cc.probe_and_scan(q, n_probe, kk, row_mask=mask)
        cd, crows = jbeam._dedup_topk(sd, srows, pool)
        cd, crows = cd[:, :k], crows[:, :k]
        return cd, jnp.where(jnp.isfinite(cd), crows, -1)

    jseg.search_cached = search_cached
    return jseg


def _jax_engine_at_port_params(je):
    for h in je._segments:
        if isinstance(h.segment, JaxVamanaSegment):
            _at_port_params(h.segment)
    return je


def _served_recall(seg, q, ti, kk=10):
    """Recall@10 of search_cached + the exact host rerank, for a segment of
    either package."""
    port = isinstance(seg, VamanaSegment)
    qq = torch.from_numpy(q) if port else q
    _, rows = seg.search_cached(qq, kk)
    rows = rows.numpy() if port else np.asarray(rows)
    d = seg.rerank_host(qq, torch.from_numpy(rows) if port else rows)
    d = d.numpy() if port else np.asarray(d)
    got = np.take_along_axis(rows, np.argsort(d, 1), 1)[:, :10]
    return tu.recall_at_k(got, ti)


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


class _CountingStore(MemoryStore):
    """The port's MemoryStore (no zero-copy view, so opens are ranged
    reads, as from a remote store), metering ranged reads (the cloud tier's
    bytes) and whole-object reads from outside a ranged read."""

    def __init__(self, root=None):
        super().__init__()
        self.range_bytes = 0
        self.full_gets = 0
        self._in_range = False
        for base, _, names in os.walk(root) if root else ():
            for n in names:
                with open(os.path.join(base, n), "rb") as f:
                    super().put(os.path.relpath(os.path.join(base, n), root), f.read())

    def get_range(self, name, offset, length):
        self.range_bytes += length
        self._in_range = True
        try:
            return super().get_range(name, offset, length)
        finally:
            self._in_range = False

    def get(self, name):
        if not self._in_range:
            self.full_gets += 1
        return super().get(name)


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


def _kinds(e, k=10):
    snap = e.snapshot()
    try:
        plan = S._plan_snapshot(snap, SearchOptions(k=k), e.options, e._device_budget)
    finally:
        snap.release()
    return [s.kind for s in plan.sources]


def _jax_kinds(e, k=10):
    from vecgo_tpu.engine import search as JS
    from vecgo_tpu.model import SearchOptions as JaxSearchOptions

    snap = e.snapshot()
    try:
        plan = JS._plan_snapshot(snap, JaxSearchOptions(k=k), e.options, e._device_budget)
    finally:
        snap.release()
    return [s.kind for s in plan.sources]


GRAPH_OPTS = dict(dim=D, flush_threshold=10_000_000, graph_threshold=2000,
                  compaction_threshold=2)


def _write_db(path, writer, x, **kw):
    """Two commits of x's halves; the second compacts them into one Vamana
    segment. Returns (ids, cache_bytes(), device_bytes())."""
    opts = dict(GRAPH_OPTS, **kw)
    if writer == "jax":
        db = vg.DB(JaxEngine.open(path, JaxEngineOptions(**opts), create=True))
    else:
        db = vg.Open(vg.Local(path), vg.Create(device="cpu", **opts))
    ids = list(db.insert_batch(x[:3000]))
    db.commit()
    ids += list(db.insert_batch(x[3000:]))
    db.commit()
    seg = db.engine._segments[0].segment
    assert seg.ivf_members is not None and seg.meta["ivf"].get("codes_stored") == kw.get(
        "store_codes")
    sizes = seg.cache_bytes(), seg.device_bytes()
    db.close()
    return ids, sizes


def _engine_recall(res, ids, ti):
    got = np.asarray([[c.id for c in r] + [-1] * (10 - len(r)) for r in res])
    return tu.recall_at_k(got, np.asarray([[ids[j] for j in row] for row in ti])), got


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_engine_beyond_budget_plans_graph_cached_as_jax_does(tmp_path, writer):
    """tests/test_ivf_cache.py:103: a budget between cache_bytes() and
    device_bytes() plans graph_cached in both packages, and below
    cache_bytes() graph_stream in both; over the same directory the port's
    answers are the JAX engine's at the same scan parameters (the JAX test's
    floor on either writer's database), through kernel B's plain version
    over the cache."""
    x, _ = tu.clustered_vectors(6000, D, n_clusters=16, seed=89)
    path = str(tmp_path / "db")
    ids, (cache, full) = _write_db(path, writer, x)
    assert cache < full
    q = x[5:21]
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    for budget, kind in (((cache + full) // 2, "graph_cached"), (cache // 2, "graph_stream")):
        pe = Engine.open(path, EngineOptions(device="cpu", hbm_budget_bytes=budget))
        je = _jax_engine_at_port_params(JaxEngine.open(path, JaxEngineOptions(
            hbm_budget_bytes=budget)))
        assert _kinds(pe) == _jax_kinds(je) == [kind]
        before = coded_group_scan.launches
        rec, got = _engine_recall(pe.search_batch(q, k=10), ids, ti)
        assert coded_group_scan.launches == before  # CPU tensors: the plain version
        seg = pe._segments[0].segment
        assert (seg._ccache is not None) == (kind == "graph_cached")
        if seg._ccache is not None:
            assert seg._ccache.stats["batches"] == 1
            assert seg._ccache.device_bytes() <= seg.cache_bytes() == cache
        jrec, jgot = _engine_recall(je.search_batch(q, k=10), ids, ti)
        assert abs(rec - jrec) <= 0.01 and np.mean(got == jgot) >= 0.97, (rec, jrec)
        assert rec >= 0.9
        pe.close()
        je.close()


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


@pytest.mark.parametrize("refine_factor", [1, 2, 10])
def test_graph_cached_rerank_pool_follows_refine_factor_as_jax_does(tmp_path, refine_factor):
    """graph_cached hands the exact host rerank k * refine_factor coded
    candidates (a clean database has no churn margin) in both packages, and
    at each refine_factor the port's answers are the JAX engine's over the
    same persisted SQ8 table at the same scan parameters."""
    x, _ = tu.clustered_vectors(6000, D, n_clusters=16, seed=83)
    path = str(tmp_path / "db")
    ids, (cache, full) = _write_db(path, "port", x, store_codes="sq8")
    budget = (cache + full) // 2
    pe = Engine.open(path, EngineOptions(device="cpu", hbm_budget_bytes=budget))
    je = _jax_engine_at_port_params(JaxEngine.open(path, JaxEngineOptions(
        hbm_budget_bytes=budget)))
    assert _kinds(pe) == _jax_kinds(je) == ["graph_cached"]
    pools = []
    for e in (pe, je):
        seg = e._segments[0].segment
        search_cached = seg.search_cached
        seg.search_cached = lambda q, k, _f=search_cached, **kw: (pools.append(k), _f(q, k, **kw))[1]
    q = x[:16] + np.random.default_rng(84).standard_normal((16, D)).astype(np.float32) * 0.05
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    rec, got = _engine_recall(pe.search_batch(q, k=10, refine_factor=refine_factor), ids, ti)
    jrec, jgot = _engine_recall(je.search_batch(q, k=10, refine_factor=refine_factor), ids, ti)
    assert pools == [10 * refine_factor] * 2
    assert abs(rec - jrec) <= 0.01 and np.mean(got == jgot) >= 0.97, (rec, jrec)
    pe.close()
    je.close()


STAGE_SEEDS = range(91, 99)


@pytest.fixture(scope="module")
def crowded_blobs():
    """tests/test_ivf_cache.py:187's fixture over seeds 91-98: per seed the
    rows, the queries x[5:21], their exact top-10, and each writer's blob
    (`VamanaWriter(store_codes=True, ivf_capacity=256, seed=90)`)."""
    out = {}
    for seed in STAGE_SEEDS:
        x, _ = tu.clustered_vectors(6000, D, n_clusters=16, seed=seed)
        q = x[5:21]
        _, ti = tu.brute_force_knn(q, x, 10, "l2")
        out[seed] = (x, q, ti, {package: _blob(x, 90, True, package)
                                for package in ("jax", "port")})
    return out


@pytest.mark.parametrize("seed", STAGE_SEEDS)
def test_cached_kk_keeps_neighbours_that_crowd_one_cluster(seed, crowded_blobs):
    """The fixture of tests/test_ivf_cache.py:187 over eight seeds, on each
    writer's blob: where the JAX rule's 8 candidates a probed cluster lose
    neighbours that crowd one cluster, the port's 16 keep them: the JAX
    test's floor of 0.9 on every seed and either writer, and never below
    the JAX rule's recall over the same blob."""
    x, q, ti, blobs = crowded_blobs[seed]
    for package in ("jax", "port"):
        blob = blobs[package]
        rec = _served_recall(VamanaSegment.open(blob), q, ti)
        assert rec >= 0.9 and rec >= _served_recall(JaxVamanaSegment.open(blob), q, ti), package


def _jax_rule_recall(blob, q, ti, members=None):
    """Recall@10 of the JAX segment's own search_cached (the JAX kk rule) +
    the exact rerank over a blob, optionally with another membership in
    place of the blob's (its cache then encodes from the rows)."""
    jseg = JaxVamanaSegment.open(blob)
    if members is not None:
        jseg._ivfq = None
        jseg.ivf_members = members
    return _served_recall(jseg, q, ti)


def _membership_from_jax_centres(x, seed):
    """The clustered build's partition stage fed the JAX build's inputs: the
    JAX writer's sample of rows (the same numpy draws in both builds; the
    projection is the identity at d = 32) and the centres the JAX k-means
    trains on it (jax.random seeding), then the port's assignment and
    membership, completed as the port's build completes it."""
    import math

    import jax.numpy as jnp
    from vecgo_tpu.quantization import kmeans as jkm
    from vecgo_tpu_torch.index import build_fast as pbf

    n, d = x.shape
    cmax = 1024
    k_clusters = max(2, math.ceil(n * 2 * 1.4 / cmax))
    rng = np.random.default_rng(seed)
    rng.standard_normal((d, min(32, d)))  # the build's projection draw
    idx = rng.choice(n, n, replace=False)
    z = jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)
    cent, _ = jkm.train_kmeans_dev(jnp.take(z, jnp.asarray(idx, jnp.int32), axis=0), k_clusters,
                                   iters=5, seed=seed, sample=n)
    n_full = pbf._bucket_rows(n, 8192)
    zt = torch.zeros((n_full, d))
    zt[:n] = torch.from_numpy(np.asarray(z))
    ok = torch.arange(n_full) < n
    a, dist = pbf._assign_topk(zt, torch.where(ok, (zt * zt).sum(1), float("inf")),
                               torch.from_numpy(np.asarray(cent)), 2, 8192)
    k_pad = -(-k_clusters // 64) * 64
    members, _, _, covered = pbf._membership_scatter(torch.where(ok[:, None], a, k_pad), dist,
                                                     k_pad + 1, cmax)
    return pbf._complete_membership(members[:k_pad], covered[:n]).numpy()


def test_clustered_membership_covers_as_the_jax_writer_does(crowded_blobs):
    """Repair of the port writer's membership (ROADMAP.md section 3): under
    the JAX kk rule (8 candidates a probed cluster), the port writer's
    segments over seeds 91-98 read a mean recall@10 at or above the JAX
    writer's less 0.01. The stage that decides it: the port's assignment and
    membership fed the JAX build's sample and trained centres reach the JAX
    writer's mean too (with the sort form it read 0.876 against 0.896), so
    the membership form was the cause, not the k-means seeding."""
    rec = {"jax": [], "port": [], "stage": []}
    for seed, (x, q, ti, blobs) in crowded_blobs.items():
        rec["jax"].append(_jax_rule_recall(blobs["jax"], q, ti))
        rec["port"].append(_jax_rule_recall(blobs["port"], q, ti))
        rec["stage"].append(_jax_rule_recall(blobs["port"], q, ti,
                                             _membership_from_jax_centres(x, 90)))
    mean = {k: float(np.mean(v)) for k, v in rec.items()}
    assert mean["port"] >= mean["jax"] - 0.01 and mean["stage"] >= mean["jax"] - 0.01, rec


def test_cached_search_over_a_small_cache_drops_no_probe():
    """A batch whose probed clusters outnumber the cache's C = 8 slots is
    scanned in chunks of clusters that fit: no probe dropped, and the ids
    (and distances within 1e-5 relative: the same f32 sums, other batch
    shapes) of the same search with every cluster cacheable (C >= K); the
    JAX cache at C = 8 drops probes on the same batch."""
    x, _ = tu.clustered_vectors(6000, D, n_clusters=16, seed=77)
    blob = _blob(x, 90, False, "port")
    q = x[::375]
    small, big = VamanaSegment.open(blob), VamanaSegment.open(blob)
    small.CACHE_CLUSTERS = 8
    qt = torch.from_numpy(q)
    probes = small.cached_probes(qt, 10)
    assert len(small.cluster_cache("cpu").chunks(probes)) > 1
    d_s, r_s = small.search_cached(qt, 10, probes=probes)
    d_b, r_b = big.search_cached(qt, 10)
    assert small._ccache.c == 8 and big._ccache.c >= big._ccache.k
    st = small._ccache.stats
    assert st["dropped_probes"] == 0 and st["batches"] > 1 and big._ccache.stats["batches"] == 1
    assert (r_s == r_b).float().mean() >= 0.999
    np.testing.assert_allclose(d_s.numpy(), d_b.numpy(), rtol=1e-5, atol=1e-5)
    jseg = _at_port_params(JaxVamanaSegment.open(blob))
    jseg.CACHE_CLUSTERS = 8
    jseg.search_cached(q, 10)
    assert jseg._ccache.stats["dropped_probes"] > 0


def test_probes_before_the_cache_are_the_cache_probes():
    """`cached_probes` probes on the centroids alone, so the planner can
    choose a route before the cache is built: the centroids are the host
    encode's to the byte, the probes are those of the built cache, and
    `cache_fits` says what `chunks` says (C = 8 and C = 256)."""
    from vecgo_tpu_torch.ops.ivf_cache import host_centroids

    x, _ = tu.clustered_vectors(6000, D, n_clusters=16, seed=77)
    blob = _blob(x, 90, False, "port")
    qt = torch.from_numpy(x[::375])
    for c in (8, 256):
        seg = VamanaSegment.open(blob)
        seg.CACHE_CLUSTERS = c
        before = seg.cached_probes(qt, 10)
        assert seg._ccache is None
        cc = seg.cluster_cache("cpu")
        xs = np.asarray(seg.vectors, np.float32)
        cent, cn = host_centroids(seg.ivf_members, xs)
        h = pic._encode_host(seg.ivf_members, xs)  # computing its own means
        assert cent.tobytes() == h["cent"].tobytes() == cc.host.cent.tobytes()
        assert cn.tobytes() == h["cnorm2"].tobytes() == cc.host.cnorm2.tobytes()
        np.testing.assert_array_equal(before, cc.probe(qt, before.shape[1]))
        np.testing.assert_array_equal(before, seg.cached_probes(qt, 10))
        assert seg.cache_fits(before) == (len(cc.chunks(before)) == 1) == (c == 256)


@pytest.mark.parametrize("opened", ["local", "lazy"])
def test_engine_broad_batch_over_a_small_cache_drops_no_probe(tmp_path, monkeypatch, opened):
    """The engine's graph_cached path with an 8-cluster cache and a batch
    whose probes span every cluster: no probe dropped. A segment with its
    rows in host memory streams the batch (graph_stream's scan) and never
    builds the cache (the batch is probed on the centroids alone): its
    recall is the full cache's at least; a lazily opened one (store_codes,
    rows in the store) scans the cache in chunks and returns the full
    cache's ids, without loading the vectors."""
    x, _ = tu.clustered_vectors(6000, D, n_clusters=16, seed=79)
    path = str(tmp_path / "db")
    lazy = opened == "lazy"
    ids, _ = _write_db(path, "port", x, **({"store_codes": "sq8"} if lazy else {}))
    q = x[::375]
    _, ti = tu.brute_force_knn(q, x, 10, "l2")

    def serve(c):
        monkeypatch.setattr(VamanaSegment, "CACHE_CLUSTERS", c)
        store = _CountingStore(path) if lazy else None
        probe = Engine.open(store or path, EngineOptions(dim=D, device="cpu"))
        seg = probe._segments[0].segment
        budget = (seg.cache_bytes() + seg.device_bytes()) // 2
        probe.close()
        e = Engine.open(store or path, EngineOptions(dim=D, device="cpu", hbm_budget_bytes=budget))
        assert _kinds(e) == ["graph_cached"]
        rec, got = _engine_recall(e.search_batch(q, k=10), ids, ti)
        seg = e._segments[0].segment
        stats = None if seg._ccache is None else dict(seg._ccache.stats)
        out = (rec, got, stats, "sq8" in seg._stream, seg._vectors_arr is None)
        e.close()
        return out

    rec_s, got_s, st_s, streamed, deferred = serve(8)
    rec_b, got_b, st_b, _, _ = serve(256)
    assert st_b["dropped_probes"] == 0
    if lazy:
        assert deferred and not streamed and st_s["batches"] > 1 and st_s["dropped_probes"] == 0
        np.testing.assert_array_equal(got_s, got_b)
    else:
        assert streamed and st_s is None
        assert rec_s >= rec_b and rec_s >= 0.9
