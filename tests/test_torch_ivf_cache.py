"""The port's cluster cache (ops/ivf_cache.py, `graph_cached`) against the
JAX package's.

The fixtures of tests/test_ivf_cache.py run through the port on the CPU, on
the same seeded numpy inputs, beside the JAX functions:

- the host encodes are numpy on both sides, so `_encode_host`'s arrays are
  byte for byte the JAX package's; PQ codebooks differ after training
  (another k-means), so the PQ cases carry the JAX host table across
  (`convert.host_table_from_jax`);
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
  JAX rule's recall over the same blob.

The persisted codes (`store_codes`) are tests/test_torch_store_codes.py's.
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
from vecgo_tpu.ops import ivf as jivf
from vecgo_tpu.ops import ivf_cache as jic
from vecgo_tpu.utils import testutil as tu
from vecgo_tpu_torch import convert
from vecgo_tpu_torch.engine import Engine, EngineOptions
from vecgo_tpu_torch.index.vamana import VamanaSegment
from vecgo_tpu_torch.ops import ivf as pivf
from vecgo_tpu_torch.ops import ivf_cache as pic
from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan

torch.set_num_threads(1)

CODED_REL_TOL = 1e-4


def _recall(got_rows, want_rows):
    hits = sum(len(set(map(int, g[g >= 0])) & set(map(int, w)))
               for g, w in zip(got_rows, want_rows))
    return hits / (len(want_rows) * len(want_rows[0]))


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
