"""The port's device-grid plane (vecgo_tpu_torch.parallel) against the JAX
package's (vecgo_tpu.parallel), on grids of eight CPU entries (dp 2 x
shard 4), each case on the fixture of its tests/test_parallel.py
counterpart.

The JAX side runs once per module in a fresh interpreter with a timeout
(this file run as a script with --jax-side DIR), as tests/test_parallel.py
isolates its mesh collectives: it writes its results to an .npz file and
its database to a Local directory, and the port's tests compare with them.

- ShardedFlat, L2 and cosine, a mask, N not a multiple of the shards and B
  not a multiple of dp: ids equal up to ties, distances within 1e-4.
- sharded_kmeans_step: centres and inertia within 1e-4 relative.
- ShardedSnapshotSearcher and Engine.sharded_searcher over the JAX
  engine's database, opened by the port: the JAX searcher's ids.
- ShardedEngineSearcher over the same engine history in both packages (a
  coded graph segment, a flat segment, memtable rows, deletes in each and
  an update): ids equal to the JAX searcher's and to the exact visible
  answer, distances within 1e-4.
- ShardedIVF over the JAX table (convert.ivf_table_from_jax): the pool's
  rows equal to the JAX pool's up to coded-distance ties, at
  tests/test_torch_ivf.py's tolerances for ivf_scan; also over a table of
  40 clusters, which leaves the grid's last shard empty.
- sharded_cluster_knn equal to the single-device _cluster_knn;
  build_graph_clustered(mesh=) equal to the single-device build;
  entry.dryrun_multichip(8, device="cpu").
"""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":  # the JAX side: a fresh interpreter with 8 CPU devices
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
    sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from vecgo_tpu.utils import testutil as tu  # noqa: E402

torch.set_num_threads(1)

# (name, rows, dim, seed, queries, query seed, metric): test_sharded_flat_exact's
# and test_sharded_flat_cosine's fixtures, one row short (N not a multiple of
# 4) and one query short (B not a multiple of dp).
FLAT_CASES = [("l2", 4999, 32, 71, 15, 72, "l2"), ("cosine", 2047, 16, 73, 7, 74, "cosine")]
FLAT_K = {"l2": 10, "cosine": 5}
IVF_SMALL = (40, 24, 16)  # clusters, members each, dim: the grid's last shard is empty
_JAX_TIMEOUT_S = 900


def _flat_mask(n):
    return np.arange(n) % 7 != 3


def _engine_plane_fixture(store, mod, device_kw):
    """test_sharded_engine_full_plane's history in either package (`mod`
    its engine module, `store` a MemoryStore of that package)."""
    eng = mod.Engine.open(
        store,
        mod.EngineOptions(dim=16, flush_threshold=10**9, graph_threshold=64,
                          compaction_threshold=10**9, serve_ivf_min_n=64, **device_kw),
        create=True,
    )
    x = tu.gaussian_vectors(480, 16, seed=91)
    ids = eng.insert_batch(x[:256])
    eng.commit()
    ids += eng.insert_batch(x[256:320])
    eng.commit()
    eng.compact([h.seg_id for h in eng._segments])  # a coded graph segment
    ids_f = eng.insert_batch(x[320:400])
    eng.commit()  # a flat segment
    ids_m = eng.insert_batch(x[400:440])  # memtable rows
    eng.delete(ids[7])
    eng.delete(ids_f[3])
    eng.delete(ids_m[2])
    eng.insert(x[440], id=ids[9])  # an update: a dirty id, its coded row stale
    return eng, x, (ids, ids_f, ids_m)


# ---------------------------------------------------------------------------
# The JAX side (its own interpreter)
# ---------------------------------------------------------------------------


def _jax_side(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import vecgo_tpu as jvg
    from vecgo_tpu import blobstore as jblob
    from vecgo_tpu import engine as jeng
    from vecgo_tpu.index.build_fast import build_graph_clustered
    from vecgo_tpu.model import Metric
    from vecgo_tpu.ops import ivf
    from vecgo_tpu.parallel import mesh as pm
    from vecgo_tpu.parallel.engine_shard import ShardedEngineSearcher, ShardedSnapshotSearcher

    jax.config.update("jax_platforms", "cpu")
    assert len(jax.devices()) == 8
    mesh = pm.make_mesh(shard=4, dp=2)
    res = {}
    for name, n, d, seed, b, qseed, metric in FLAT_CASES:
        x = tu.gaussian_vectors(n + 1, d, seed=seed)[:n]
        q = tu.gaussian_vectors(b + 1, d, seed=qseed)[:b]
        sf = pm.ShardedFlat(x, mesh, metric=Metric(metric), block_rows=512, mask=_flat_mask(n))
        qp = np.concatenate([q, np.zeros((b % 2, d), np.float32)])  # the JAX flat wants B % dp == 0
        dd, ii = sf.search(qp, FLAT_K[name])
        res[f"flat_{name}_d"], res[f"flat_{name}_i"] = np.asarray(dd)[:b], np.asarray(ii)[:b]

    x, _ = tu.clustered_vectors(4096, 16, n_clusters=8, spread=0.05, seed=75)
    step = pm.sharded_kmeans_step(mesh)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(("dp", "shard"), None)))
    c = jnp.asarray(x[:8])
    for _ in range(5):
        c, inertia = step(xs, c)
    res["kmeans_c"], res["kmeans_inertia"] = np.asarray(c), np.asarray(inertia)

    # The snapshot searcher over a Local database the port opens (the
    # delete is committed, so the port sees it).
    db = jvg.Open(jvg.Local(os.path.join(out_dir, "db")),
                  jvg.Create(dim=16, flush_threshold=10**9, graph_threshold=10**9,
                             compaction_threshold=10**9))
    xs_db = tu.gaussian_vectors(600, 16, seed=90)
    ids = db.insert_batch(xs_db[:300])
    db.commit()
    ids += db.insert_batch(xs_db[300:])
    db.commit()
    db.delete(ids[5])
    db.commit()
    snap = db.engine.snapshot()
    try:
        got, dist = ShardedSnapshotSearcher(snap, mesh, db.engine.options.metric).search(
            xs_db[4:12], k=5)
    finally:
        snap.release()
    res["snap_ids"], res["snap_d"] = got, dist
    res["snap_ids_db"] = db.sharded_searcher(mesh).search(xs_db[4:12], k=5)[0]
    res["snap_all_ids"] = np.asarray(ids, np.int64)
    db.close()

    eng, xe, id_lists = _engine_plane_fixture(jblob.MemoryStore(), jeng, {})
    snap = eng.snapshot()
    try:
        ses = ShardedEngineSearcher(snap, mesh, eng.options.metric, eng.pk)
        got, gd = ses.search(xe[:8], k=5, n_probe_local=8, kk=32, refine_steps=2, ef=48)
    finally:
        snap.release()
    res["plane_ids"], res["plane_d"] = got, gd
    for name, lst in zip(("plane_ids_seg", "plane_ids_flat", "plane_ids_mem"), id_lists):
        res[name] = np.asarray(lst, np.int64)
    eng.close()

    # test_sharded_ivf_matches_single_device's table, and a small table
    # whose 40 clusters leave the last of four shards empty.
    x, _ = tu.clustered_vectors(20_000, 32, n_clusters=64, seed=7)
    rng = np.random.default_rng(11)
    q = (x[rng.choice(len(x), 32, replace=False)]
         + 0.02 * rng.standard_normal((32, 32))).astype(np.float32)
    members = build_graph_clustered(x, r=16, cluster_size=256, return_membership=True)[4]
    tables = {"ivf": (ivf.device_table_coded(members, jnp.asarray(x)), q, 8, 16)}
    k_s, m_s, d_s = IVF_SMALL
    xsm = tu.gaussian_vectors(k_s * m_s, d_s, seed=60)
    qsm = xsm[::k_s * m_s // 13][:13] + 0.01
    tables["ivf_small"] = (ivf.device_table_coded(
        np.arange(k_s * m_s, dtype=np.int32).reshape(k_s, m_s), jnp.asarray(xsm)), qsm, 4, 8)
    for name, (table, qq, n_probe_local, kk) in tables.items():
        for field in table._fields:
            arr = getattr(table, field)
            if arr is not None:
                res[f"{name}_t_{field}"] = np.asarray(arr)
        res[f"{name}_q"] = qq
        qp = np.concatenate([qq, np.zeros((len(qq) % 2, qq.shape[1]), np.float32)])
        dd, rows = pm.ShardedIVF(table, mesh).search(qp, n_probe_local=n_probe_local, kk=kk)
        res[f"{name}_d"], res[f"{name}_rows"] = dd[:len(qq)], rows[:len(qq)]
    np.savez(os.path.join(out_dir, "jax.npz"), **res)


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-side", sys.argv
    _jax_side(sys.argv[2])
    sys.exit(0)


# ---------------------------------------------------------------------------
# The port's side
# ---------------------------------------------------------------------------

import vecgo_tpu_torch as vg  # noqa: E402
from vecgo_tpu_torch import convert  # noqa: E402
from vecgo_tpu_torch.blobstore import MemoryStore  # noqa: E402
from vecgo_tpu_torch.index import build_fast as bf  # noqa: E402
from vecgo_tpu_torch.model import Metric  # noqa: E402
from vecgo_tpu_torch.ops import ivf as ivf_ops  # noqa: E402
from vecgo_tpu_torch.ops import topk as T  # noqa: E402
from vecgo_tpu_torch.parallel import engine_shard as es  # noqa: E402
from vecgo_tpu_torch.parallel import mesh as pm  # noqa: E402


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_parallel")
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--jax-side", str(out)],
                       cwd=_REPO, capture_output=True, text=True, timeout=_JAX_TIMEOUT_S)
    assert r.returncode == 0, (r.stdout[-4000:], r.stderr[-4000:])
    return out, dict(np.load(out / "jax.npz"))


@pytest.fixture(scope="module")
def mesh8():
    return pm.make_mesh(shard=4, dp=2, devices=["cpu"] * 8)


def _same_up_to_ties(got_i, got_d, want_i, want_d, tol=1e-4):
    """Ids equal wherever the distances do not tie; distances within tol
    (relative to the largest finite one)."""
    got_d, want_d = np.asarray(got_d, np.float64), np.asarray(want_d, np.float64)
    np.testing.assert_array_equal(np.isfinite(got_d), np.isfinite(want_d))
    fin = np.isfinite(want_d)
    scale = max(1.0, float(np.abs(want_d[fin]).max())) if fin.any() else 1.0
    assert np.abs(got_d[fin] - want_d[fin]).max(initial=0.0) <= tol * scale
    for g, gd, w in zip(got_i, got_d, want_i):
        for j in np.flatnonzero(g != w):
            ties = np.abs(gd - gd[j]) <= tol * scale
            assert set(g[ties]) == set(w[ties]), (g, w)


@pytest.mark.parametrize("case", FLAT_CASES, ids=[c[0] for c in FLAT_CASES])
def test_sharded_flat_matches_jax(jax_side, mesh8, case):
    """Exact sharded search with a mask, a ragged last shard and a ragged dp
    split: the JAX ids up to ties, distances within 1e-4; no masked row."""
    _, want = jax_side
    name, n, d, seed, b, qseed, metric = case
    x = tu.gaussian_vectors(n + 1, d, seed=seed)[:n]
    q = tu.gaussian_vectors(b + 1, d, seed=qseed)[:b]
    dd, ii = pm.ShardedFlat(x, mesh8, metric=Metric(metric), block_rows=512,
                            mask=_flat_mask(n)).search(q, FLAT_K[name])
    ii = ii.numpy()
    _same_up_to_ties(ii, dd.numpy(), want[f"flat_{name}_i"], want[f"flat_{name}_d"])
    assert (ii >= 0).all() and (ii < n).all() and _flat_mask(n)[ii].all()


@pytest.mark.parametrize("case", FLAT_CASES, ids=[c[0] for c in FLAT_CASES])
def test_sharded_flat_equals_one_device(case):
    """The grid's answer is the one-device scan's: the same kernel over the
    same rows, merged exactly (the tensor input, sliced per shard)."""
    name, n, d, seed, b, qseed, metric = case
    x = torch.from_numpy(tu.gaussian_vectors(n + 1, d, seed=seed)[:n])
    q = torch.from_numpy(tu.gaussian_vectors(b + 1, d, seed=qseed)[:b])
    mask = torch.from_numpy(_flat_mask(n))
    got_d, got_i = pm.ShardedFlat(x, pm.make_mesh(shard=3, dp=2, devices=["cpu"] * 6),
                                  metric=Metric(metric), mask=mask).search(q, FLAT_K[name])
    xn = x / x.norm(dim=1, keepdim=True) if metric == "cosine" else x
    want_d, want_i = T.blockwise_topk_search(q, xn, FLAT_K[name], metric=Metric(metric),
                                            mask=mask, x_normalized=True)
    _same_up_to_ties(got_i.numpy(), got_d.numpy(), want_i.numpy(), want_d.numpy(), tol=1e-5)


def test_sharded_kmeans_matches_jax(jax_side, mesh8):
    """Five steps from the same centres: centres and inertia within 1e-4
    relative of the JAX step's."""
    _, want = jax_side
    x, _ = tu.clustered_vectors(4096, 16, n_clusters=8, spread=0.05, seed=75)
    step = pm.sharded_kmeans_step(mesh8)
    xs = pm.split_rows(x, mesh8)
    c = torch.from_numpy(x[:8])
    for _ in range(5):
        c, inertia = step(xs, c)
    np.testing.assert_allclose(c.numpy(), want["kmeans_c"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(inertia), float(want["kmeans_inertia"]), rtol=1e-4)


def test_sharded_kmeans_keeps_empty_clusters_and_matches_one_entry():
    """A centre no row is nearest to stays where it was; the grid's step
    equals a one-entry grid's."""
    x, _ = tu.clustered_vectors(1000, 8, n_clusters=4, spread=0.05, seed=5)
    c0 = torch.from_numpy(np.concatenate([x[:4], np.full((1, 8), 50.0, np.float32)]))
    grid = pm.make_mesh(shard=4, dp=2, devices=["cpu"] * 8)
    one = pm.make_mesh(devices=["cpu"])
    c8, in8 = pm.sharded_kmeans_step(grid)(pm.split_rows(x, grid), c0)
    c1, in1 = pm.sharded_kmeans_step(one)(pm.split_rows(x, one), c0)
    np.testing.assert_array_equal(c8[4].numpy(), c0[4].numpy())
    np.testing.assert_allclose(c8.numpy(), c1.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(in8), float(in1), rtol=1e-5)


def test_sharded_snapshot_searcher_over_the_jax_database(jax_side, mesh8):
    """The JAX engine's database opened by the port: the snapshot searcher
    and DB.sharded_searcher return the JAX searcher's ids (the committed
    delete respected) and its distances within 1e-4."""
    out, want = jax_side
    db = vg.Open(vg.Local(str(out / "db")), device="cpu")
    xs_db = tu.gaussian_vectors(600, 16, seed=90)
    snap = db.engine.snapshot()
    try:
        got, dist = es.ShardedSnapshotSearcher(snap, mesh8, db.engine.options.metric).search(
            xs_db[4:12], k=5)
    finally:
        snap.release()
    np.testing.assert_array_equal(got, want["snap_ids"])
    np.testing.assert_allclose(dist, want["snap_d"], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(db.sharded_searcher(mesh8).search(xs_db[4:12], k=5)[0],
                                  want["snap_ids_db"])
    assert want["snap_all_ids"][5] not in set(got.reshape(-1).tolist())
    db.close()


@pytest.mark.parametrize("refine_steps", [2, 0])
def test_sharded_engine_plane_matches_jax_and_brute_force(jax_side, mesh8, refine_steps):
    """test_sharded_engine_full_plane's history in the port: the ids equal
    the exact answer over the visible rows and the JAX searcher's (which
    ran with refine_steps 2), distances within 1e-4; no deleted or stale
    id."""
    from vecgo_tpu_torch import engine as peng

    _, want = jax_side
    eng, x, (ids, ids_f, ids_m) = _engine_plane_fixture(MemoryStore(), peng, {"device": "cpu"})
    for name, lst in zip(("plane_ids_seg", "plane_ids_flat", "plane_ids_mem"), (ids, ids_f, ids_m)):
        np.testing.assert_array_equal(np.asarray(lst, np.int64), want[name])
    assert any(getattr(h.segment, "ivf_members", None) is not None for h in eng._segments)
    snap = eng.snapshot()
    try:
        ses = es.ShardedEngineSearcher(snap, mesh8, eng.options.metric, eng.pk)
        got, gd = ses.search(x[:8], k=5, n_probe_local=8, kk=32, refine_steps=refine_steps,
                             ef=48)
    finally:
        snap.release()
    brute, bd = es._brute_visible(eng, x[:8], 5)
    np.testing.assert_array_equal(got, brute)
    np.testing.assert_array_equal(got, want["plane_ids"])
    np.testing.assert_allclose(gd, bd, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gd, want["plane_d"], rtol=1e-4, atol=1e-4)
    flat = set(got.reshape(-1).tolist())
    assert ids[7] not in flat and ids_f[3] not in flat and ids_m[2] not in flat
    # The updated id answers with its new vector's distance, never the stale row's.
    xq = x[9]
    got9, d9 = ses.search(xq[None], k=3, n_probe_local=8, kk=32, refine_steps=refine_steps,
                          ef=48)
    assert ids[9] not in set(got9[0].tolist()) or abs(
        d9[0][list(got9[0]).index(ids[9])] - float(((x[440] - xq) ** 2).sum())) <= 1e-4
    eng.close()


def _jax_table(want, name):
    fields = {f: want[f"{name}_t_{f}"] for f in ivf_ops.IVFCodedTable._fields
              if f"{name}_t_{f}" in want}
    return convert.ivf_table_from_jax(
        type("JaxTable", (), {**{f: None for f in ivf_ops.IVFCodedTable._fields}, **fields})(),
        "cpu")


@pytest.mark.parametrize("name,n_probe_local,kk", [("ivf", 8, 16), ("ivf_small", 4, 8)])
def test_sharded_ivf_matches_jax(jax_side, mesh8, name, n_probe_local, kk):
    """The JAX table carried across: the sharded pool's rows equal the JAX
    ShardedIVF's on >= 0.999 of the entries (coded-distance ties), its
    distances within 1e-4 of the largest where the rows agree. "ivf_small"
    holds 40 clusters: the shards hold 16, 16, 8 and none, and 13 queries
    split over dp 2."""
    _, want = jax_side
    table = _jax_table(want, name)
    d, rows = pm.ShardedIVF(table, mesh8).search(want[f"{name}_q"], n_probe_local=n_probe_local,
                                                 kk=kk)
    d, rows = d.numpy(), rows.numpy()
    w_d, w_r = want[f"{name}_d"], want[f"{name}_rows"]
    assert rows.shape == w_r.shape
    same = rows == w_r
    assert same.mean() >= 0.999, same.mean()
    fin = same & (w_d < 1e30)
    scale = float(w_d[fin].max())
    assert np.abs(d[fin] - w_d[fin]).max() <= 1e-4 * scale
    if name == "ivf_small":  # every query finds itself near the top of its pool
        assert (rows[:, 0] >= 0).all()


def test_sharded_ivf_covers_the_one_device_scan():
    """Per-shard quota of 8 probes over test_sharded_ivf_matches_single_device's
    table: the sharded top-10 holds >= 0.95 of the one-device scan's
    (the JAX test's rule); distances ascending."""
    x, _ = tu.clustered_vectors(6000, 32, n_clusters=32, seed=7)
    rng = np.random.default_rng(11)
    q = torch.from_numpy((x[rng.choice(len(x), 32, replace=False)]
                          + 0.02 * rng.standard_normal((32, 32))).astype(np.float32))
    members = bf.build_graph_clustered(x, r=16, cluster_size=256, return_membership=True,
                                       device="cpu")[4]
    table = ivf_ops.device_table_coded(members, torch.from_numpy(x))
    sd, sr = ivf_ops.ivf_scan(q, table, n_probe=8, kk=16)
    from vecgo_tpu_torch.ops.beam import _dedup_topk

    ref = _dedup_topk(sd, sr, 10)[1].numpy()
    mesh = pm.make_mesh(shard=4, dp=2, devices=["cpu"] * 8)
    d, rows = pm.ShardedIVF(table, mesh).search(q, n_probe_local=8, kk=16)
    got = rows.numpy()[:, :10]
    agree = np.mean([len(set(got[b]) & set(ref[b])) / 10 for b in range(len(q))])
    assert agree >= 0.95, agree
    assert (np.diff(d.numpy()[:, :10], axis=1) >= -1e-3).all()


def test_sharded_cluster_knn_equals_one_device(mesh8):
    """test_sharded_cluster_knn_matches_local's fixture: equal tables."""
    n, d = 512, 16
    x = tu.gaussian_vectors(n, d, seed=91)
    rn = torch.from_numpy(np.einsum("nd,nd->n", x, x, dtype=np.float64).astype(np.float32))
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    members = np.arange(n, dtype=np.int32).reshape(8, 64)
    slots = np.zeros((8, 64), np.int32)
    got = es.sharded_cluster_knn(x16, rn, members, slots, 8, 1, n, 1, mesh8)
    want = bf._cluster_knn(x16, rn, torch.from_numpy(members), torch.from_numpy(slots), 8, 1, n, 1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("one_pass", [True, False])
def test_sharded_prune_uses_global_rows(mesh8, one_pass):
    """Each slice prunes with global row ids: equal to the one-device prune
    (one pass), and to the one-device reverse re-prune (two passes); no
    self-loops."""
    n, d, r = 700, 16, 8
    x = tu.gaussian_vectors(n, d, seed=92)
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    rn = (x16.float() ** 2).sum(1)
    cand = torch.from_numpy(np.random.default_rng(1).integers(-1, n, (n, 24)))
    got = es.sharded_prune(cand, x16, rn, x16.float(), rn, r, 1.2, 256, 8, mesh8,
                           one_pass=one_pass)
    want = bf._prune_all(cand, x16, rn, x16.float(), rn, r, 1.2, 256)
    if not one_pass:
        rev = bf._reverse_dev(want, 8)
        want = bf._prune_all(torch.cat([want, rev], 1), x16, rn, x16.float(), rn, r, 1.2, 256)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert not (got.numpy() == np.arange(n)[:, None]).any()


def test_build_graph_clustered_on_a_grid_equals_one_device(mesh8):
    """test_sharded_build_full_pipeline's fixture: the grid build's graph,
    medoid and membership equal the one-device build's (the cluster-KNN
    tables and the prune are row-for-row the same computations)."""
    x, _ = tu.clustered_vectors(8192, 24, n_clusters=32, seed=13)
    g_sh, medoid, _, _, m_sh = bf.build_graph_clustered(x, r=16, cluster_size=256, mesh=mesh8,
                                                        return_membership=True)
    g_ref, medoid_ref, _, _, m_ref = bf.build_graph_clustered(x, r=16, cluster_size=256,
                                                              device="cpu",
                                                              return_membership=True)
    assert g_sh.shape == (len(x), 16) and medoid == medoid_ref
    np.testing.assert_array_equal(g_sh, g_ref)
    np.testing.assert_array_equal(m_sh, m_ref)
    assert not (g_sh == np.arange(len(x))[:, None]).any() and g_sh.max() < len(x)


def test_dryrun_multichip_on_cpu(capsys):
    from vecgo_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(8, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_engine_sharded OK" in out and "dryrun_multichip OK: mesh={'dp': 2, 'shard': 4}" in out


def test_make_mesh_layout():
    """make_mesh as the JAX package's: row-major over (dp, shard), repeated
    entries allowed, dp * shard must be the device count; with no card and
    no devices it raises."""
    mesh = pm.make_mesh(shard=4, dp=2, devices=["cpu"] * 8)
    assert mesh.shape == {"dp": 2, "shard": 4} and mesh.axis_names == ("dp", "shard")
    assert mesh.devices.shape == (2, 4) and mesh.devices[1, 3] == torch.device("cpu")
    assert pm.make_mesh(dp=2, devices=["cpu"] * 6).shape == {"dp": 2, "shard": 3}
    with pytest.raises(AssertionError):
        pm.make_mesh(shard=3, dp=2, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            pm.make_mesh()
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            pm.make_mesh(devices=["cuda"] * 2)
