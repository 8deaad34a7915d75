"""Graph segments in the port's engine: compaction into a Vamana segment,
serving it through the planner's graph and brute_masked sources with MVCC,
databases moving between the packages, and the compaction edges.

A graph the port builds is not the JAX-built graph (random draws differ),
so the port's own compactions are held to recall floors against brute
force; a database compacted by one package and searched by the other
returns at least 0.99 of the same ids.
"""

import numpy as np
import pytest
import torch

import vecgo_tpu_torch as vg
from vecgo_tpu.blobstore import MemoryStore
from vecgo_tpu.engine import Engine as JaxEngine
from vecgo_tpu.engine import EngineOptions as JaxEngineOptions
from vecgo_tpu import metadata as jmd
from vecgo_tpu.errors import ErrNotFound as JaxErrNotFound
from vecgo_tpu.utils import testutil as tu
from vecgo_tpu_torch import metadata as pmd
from vecgo_tpu_torch.engine import EngineOptions
from vecgo_tpu_torch.index.flat import FlatSegment
from vecgo_tpu_torch.index.vamana import VamanaSegment

torch.set_num_threads(1)

N, D = 6000, 16
GRAPH = dict(graph_threshold=4096, flush_threshold=10**9)


def overlap(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    hits = sum(len(set(x[x >= 0]) & set(y[y >= 0])) for x, y in zip(a, b))
    return hits / max(1, sum(len(set(y[y >= 0])) for y in b))


def corpus(n=N, seed=41):
    x, _ = tu.clustered_vectors(n, D, n_clusters=24, seed=seed)
    rng = np.random.default_rng(seed + 1)
    q = (x[rng.choice(n, 32, replace=False)] + 0.02 * rng.standard_normal((32, D))).astype(np.float32)
    return x, q, rng.integers(0, 100, n)


def _visible_truth(x, ids, gone, q, keep=None):
    vis = ~np.isin(ids, gone)
    if keep is not None:
        vis &= keep
    _, ti = tu.brute_force_knn(q, x[vis], 10, "l2")
    return ids[vis][ti]


def test_port_compaction_serves_graph_segment():
    """commit -> compact into a Vamana segment -> deletes and memtable rows
    -> search unfiltered, at 10% (brute force over the codes) and at 50%
    (the graph with a mask): recall against brute force, deletes absent."""
    x, q, u = corpus()
    db = vg.Open(vg.Memory(), vg.Create(dim=D, device="cpu", **GRAPH))
    ids = np.asarray(db.insert_batch(x[:5000], [{"u": int(v)} for v in u[:5000]]))
    db.commit()
    ids = np.concatenate([ids, db.insert_batch(x[5000:5500], [{"u": int(v)} for v in u[5000:5500]])])
    db.commit()
    assert db.compact([h.seg_id for h in db.engine._segments]) is not None
    (h,) = db.engine._segments
    assert type(h.segment) is VamanaSegment and h.info.kind == "vamana"
    gone = ids[::50]
    for i in gone:
        assert db.delete(int(i))
    ids = np.concatenate([ids, db.insert_batch(x[5500:], [{"u": int(v)} for v in u[5500:]])])
    for sel, strategy in ((None, "graph=1"), (10, "brute=1"), (50, "graph=1")):
        kw = {} if sel is None else {"filter": pmd.isin("u", list(range(sel)))}
        got, _ = db.search_arrays(q, k=10, **kw)
        assert not np.isin(got, gone).any()
        truth = _visible_truth(x, ids, gone, q, None if sel is None else u < sel)
        assert tu.recall_at_k(got, truth) >= 0.95, sel
        stats = db.search_batch(q[:1], k=10, with_stats=True, **kw)[0].stats
        assert strategy in stats.strategy
    for kw in (dict(ef=48, nprobes=4, graph_refine=0, graph_rescore=False),
               dict(ef=48, nprobes=4, graph_qcap_factor=1.25)):
        got, _ = db.search_arrays(q, k=10, **kw)
        assert tu.recall_at_k(got, _visible_truth(x, ids, gone, q)) >= 0.95
    streamed = list(db.search_arrays_stream(iter([q[:16], q[16:]]), k=10))
    np.testing.assert_array_equal(np.concatenate([s[0] for s in streamed]),
                                  db.search_arrays(q, k=10)[0])
    db.commit()
    assert db.get(int(ids[1])).metadata == {"u": int(u[1])}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_graph_db_directory_opens_in_the_other_package(tmp_path, writer):
    x, q, u = corpus()
    path = str(tmp_path / "db")
    if writer == "jax":
        db = vg.DB(JaxEngine.open(path, JaxEngineOptions(dim=D, **GRAPH), create=True))
    else:
        db = vg.Open(vg.Local(path), vg.Create(dim=D, device="cpu", **GRAPH))
    ids = np.asarray(db.insert_batch(x, [{"u": int(v)} for v in u]))
    db.commit()
    db.compact([h.seg_id for h in db.engine._segments])
    assert db.engine._segments[0].info.kind == "vamana"
    db.delete(int(ids[0]))
    db.commit()
    # Each package takes its own filter objects.
    md_w, md_o = (jmd, pmd) if writer == "jax" else (pmd, jmd)
    sels = (None, 10, 50)
    want = [db.search_arrays(q, k=10, **({} if s is None else
                                         {"filter": md_w.isin("u", list(range(s)))}))[0]
            for s in sels]
    db.close()
    other = (vg.Open(vg.Local(path), device="cpu") if writer == "jax"
             else vg.DB(JaxEngine.open(path)))
    for s, w in zip(sels, want):
        kw = {} if s is None else {"filter": md_o.isin("u", list(range(s)))}
        got, _ = other.search_arrays(q, k=10, **kw)
        assert overlap(got, w) >= 0.99
        assert ids[0] not in got
    assert other.get(int(ids[5])).metadata == {"u": int(u[5])}
    with pytest.raises(vg.ErrNotFound if writer == "jax" else JaxErrNotFound):
        other.get(int(ids[0]))
    other.close()


def test_flat_compaction_matches_jax_row_for_row():
    """Under 16,384 live rows compaction writes an unpartitioned flat segment:
    the port's equals the JAX package's row for row."""
    x, _, u = corpus(4000, seed=45)
    dbs = [vg.DB(JaxEngine.open(MemoryStore(), JaxEngineOptions(dim=D, flush_threshold=10**9),
                                create=True)),
           vg.Open(vg.Memory(), vg.Create(dim=D, device="cpu", flush_threshold=10**9))]
    segs = []
    for db in dbs:
        ids = db.insert_batch(x[:2500], [{"u": int(v)} for v in u[:2500]])
        db.commit()
        db.insert_batch(x[2500:], [{"u": int(v)} for v in u[2500:]], payloads=[b"p"] * 1500)
        db.commit()
        for i in ids[::7]:
            db.delete(i)
        db.compact([h.seg_id for h in db.engine._segments])
        (h,) = db.engine._segments
        segs.append(h.segment)
    js, ts = segs
    assert type(ts) is FlatSegment and ts.n == js.n == 4000 - len(range(0, 2500, 7))
    for name in ("ids", "vectors", "rnorm2", "lsns"):
        np.testing.assert_array_equal(np.asarray(getattr(ts, name)), np.asarray(getattr(js, name)))
    assert [ts.doc(r) for r in range(0, ts.n, 97)] == [js.doc(r) for r in range(0, js.n, 97)]
    assert [ts.payload(r) for r in range(ts.n - 5, ts.n)] == [b"p"] * 5


def test_partitioned_flat_compaction_and_auto_compact_default():
    """16,384 to 32,767 live rows compact into a partitioned (flat IVF)
    segment, so auto_compact is on by default, as in the JAX engine: the
    fourth commit compacts by itself, and probing every partition gives the
    unprobed answer."""
    r = np.random.default_rng(46)
    x = r.standard_normal((4 * 4300, 4)).astype(np.float32)
    assert EngineOptions(device="cpu").auto_compact is True
    assert JaxEngineOptions().auto_compact is True
    db = vg.Open(vg.Memory(), vg.Create(dim=4, device="cpu", flush_threshold=10**9))
    ids = []
    for i in range(4):
        ids += db.insert_batch(x[i * 4300 : (i + 1) * 4300])
        db.commit()
    (h,) = db.engine._segments  # the size-tiered policy merged the four
    assert type(h.segment) is FlatSegment and h.segment.n == len(x)
    assert h.segment.meta["ivf"]["partitions"] == len(x) // 8192 == 2
    assert (np.diff(h.segment.ivf_part) >= 0).all()
    q = x[:9] + 0.001
    got, _ = db.search_arrays(q, k=5)
    _, ti = tu.brute_force_knn(q, x, 5, "l2")
    np.testing.assert_array_equal(got, np.asarray(ids)[ti])
    np.testing.assert_array_equal(db.search_arrays(q, k=5, nprobes=2)[0], got)
    one, _ = db.search_arrays(q, k=5, nprobes=1)
    assert (one[:, 0] == got[:, 0]).all()  # a row's own partition is its nearest


def _state_bytes(seg, device="cpu") -> int:
    state = seg.device_state(device)
    return sum(t.numel() * t.element_size()
               for t in (state["graph"], *state["ivfq"]) if t is not None)


def test_engine_serve_compact_recall():
    """tests/test_engine.py::test_engine_serve_compact_recall through the port
    engine: the graph segment serves from the one-slot-per-row coded table
    (the doubled automatic probes) with at least 9 of the exact top 10, and
    the JAX engine on the same rows keeps one slot per row too."""
    x, _ = tu.clustered_vectors(9000, D, n_clusters=32, seed=71)
    db = vg.Open(vg.Memory(), vg.Create(dim=D, device="cpu", graph_threshold=4096,
                                        flush_threshold=10**9, serve_compact=True))
    ids = db.insert_batch(x)
    db.commit()
    db.compact([h.seg_id for h in db.engine._segments])
    seg = db.engine._segments[-1].segment
    assert isinstance(seg, VamanaSegment) and seg.serve_compact
    rows = seg.device_state("cpu")["ivfq"].rows.numpy()
    assert (rows >= 0).sum() == 9000 and rows.shape[1] < seg.ivf_members.shape[1]
    _, ti = tu.brute_force_knn(x[123][None], x, 10, "l2")
    got = {c.id for c in db.search(x[123], k=10)}
    assert len(got & {ids[j] for j in ti[0]}) >= 9
    je = JaxEngine.open(MemoryStore(), JaxEngineOptions(
        dim=D, graph_threshold=4096, flush_threshold=10**9, serve_compact=True), create=True)
    jids = je.insert_batch(x)
    je.commit()
    je.compact([h.seg_id for h in je._segments])
    jt = je._segments[-1].segment.device_state()["ivfq"]
    assert (np.asarray(jt.rows) >= 0).sum() == 9000
    jgot = {c.id for c in je.search(x[123], k=10)}
    assert len(jgot & {jids[j] for j in ti[0]}) >= 9
    db.close()
    je.close()


@pytest.mark.parametrize("compact", [False, True])
def test_device_bytes_holds_the_built_tensors(compact):
    """device_bytes() is the bytes of the tensors device_state() builds (the
    medoid entry aside): under serve_compact, the compact table's own S'
    once it has been built, and the overlap table's S, an upper bound,
    before (the JAX package always counts S)."""
    x, _ = tu.clustered_vectors(6000, D, n_clusters=24, seed=43)
    w = vg.Open(vg.Memory(), vg.Create(dim=D, device="cpu", **GRAPH))
    w.insert_batch(x)
    w.commit()
    w.compact([h.seg_id for h in w.engine._segments])
    seg = w.engine._segments[-1].segment
    seg.release_device()
    seg.serve_compact = compact
    before = seg.device_bytes()
    held = _state_bytes(seg)
    assert seg.device_bytes() == held
    if compact:
        assert held < before  # S' < S
    else:
        assert held == before
    w.close()
