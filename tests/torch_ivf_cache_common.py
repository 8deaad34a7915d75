"""Inputs and helpers shared by tests/test_torch_ivf_cache.py (the cluster
cache, `graph_cached`) and tests/test_torch_store_codes.py (persisted codes,
`store_codes`): seeded rows and IVF memberships, segments written by either
package, the JAX segment and engine run at the port's scan parameters, the
served recall of either package's segment, a store that meters ranged reads,
and databases that compact into one Vamana segment."""

import os

import numpy as np
import torch

import vecgo_tpu_torch as vg
from vecgo_tpu.engine import Engine as JaxEngine
from vecgo_tpu.engine import EngineOptions as JaxEngineOptions
from vecgo_tpu.index.vamana import VamanaSegment as JaxVamanaSegment
from vecgo_tpu.index.vamana import VamanaWriter as JaxVamanaWriter
from vecgo_tpu.ops import ivf as jivf
from vecgo_tpu.utils import testutil as tu
from vecgo_tpu_torch.blobstore import MemoryStore
from vecgo_tpu_torch.engine import search as S
from vecgo_tpu_torch.index.vamana import VamanaSegment, VamanaWriter, cached_scan_params
from vecgo_tpu_torch.model import SearchOptions

D = 32


def _fixture(n, clusters, seed, q_seed, n_q, members_seed):
    x, _ = tu.clustered_vectors(n, D, n_clusters=clusters, seed=seed)
    rng = np.random.default_rng(q_seed)
    q = (x[rng.choice(len(x), n_q, replace=False)]
         + 0.02 * rng.standard_normal((n_q, D))).astype(np.float32)
    _, members = jivf.build_ivf_table(x, capacity=256, seed=members_seed)
    return x, q, np.asarray(members)


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
