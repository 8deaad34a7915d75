"""The port's flat engine path end to end (device="cpu") against the JAX engine.

Same writes go to both engines: a committed flat segment, rows left in the
memtable, deletes and an upsert (multi-version ids, so the MVCC visibility
check runs). Both must return the same ids, unfiltered and at 1/10/50/80%
selectivity, equal to exact brute force over the visible rows. The JAX scans
are exact at these sizes (rows below 16,384 use `lax.top_k`). A database
directory written by either package must open and search the same in the
other.
"""

import numpy as np
import pytest
import torch

import vecgo_tpu_torch as vg
from vecgo_tpu import metadata as jmd
from vecgo_tpu.engine import Engine as JaxEngine
from vecgo_tpu.engine import EngineOptions as JaxEngineOptions
from vecgo_tpu.blobstore import MemoryStore
from vecgo_tpu.errors import ErrNotFound as JaxErrNotFound
from vecgo_tpu.utils import testutil as tu
from vecgo_tpu_torch import metadata as pmd

torch.set_num_threads(1)

D = 32


def _apply_writes(db, x1, x2, u1, u2):
    """Commit x1, leave x2 in the memtable, delete and upsert a few ids."""
    ids1 = db.insert_batch(x1, [{"u": int(v)} for v in u1])
    db.commit()
    ids2 = db.insert_batch(x2, [{"u": int(v)} for v in u2])
    gone = ids1[::400] + ids2[::300]
    for i in gone:
        assert db.delete(i)
    # Upsert: a new version of ids1[7] lands in the memtable.
    db.insert(x1[8] + 0.01, metadata={"u": int(u1[7])}, id=ids1[7])
    return np.asarray(ids1 + ids2), gone


@pytest.fixture(scope="module")
def twin():
    r = np.random.default_rng(31)
    x1 = r.standard_normal((12_000, D)).astype(np.float32)
    x2 = r.standard_normal((3_000, D)).astype(np.float32)
    u1, u2 = r.integers(0, 100, len(x1)), r.integers(0, 100, len(x2))
    jax_db = vg.DB(JaxEngine.open(MemoryStore(), JaxEngineOptions(dim=D), create=True))
    port_db = vg.Open(vg.Memory(), vg.Create(dim=D, device="cpu"))
    ids, gone = _apply_writes(jax_db, x1, x2, u1, u2)
    ids_p, gone_p = _apply_writes(port_db, x1, x2, u1, u2)
    assert (ids == ids_p).all() and gone == gone_p
    x = np.concatenate([x1, x2])
    x[7] = x1[8] + 0.01  # the upserted version of ids[7]
    return jax_db, port_db, x, ids, np.concatenate([u1, u2]), gone


@pytest.mark.parametrize("sel", [None, 1, 10, 50, 80])
def test_engine_matches_jax_and_brute_force(twin, sel):
    jax_db, port_db, x, ids, u, gone = twin
    q = np.random.default_rng(32).standard_normal((16, D)).astype(np.float32)
    # Each package takes its own filter objects.
    kw_p = {} if sel is None else {"filter": pmd.isin("u", list(range(sel)))}
    kw_j = {} if sel is None else {"filter": jmd.isin("u", list(range(sel)))}
    got_p, d_p = port_db.search_arrays(q, k=10, **kw_p)
    got_j, d_j = jax_db.search_arrays(q, k=10, **kw_j)
    np.testing.assert_array_equal(got_p, got_j)
    np.testing.assert_allclose(d_p, d_j, atol=1e-4)
    vis = ~np.isin(ids, gone) if sel is None else ~np.isin(ids, gone) & (u < sel)
    _, rows = tu.brute_force_knn(q, x[vis], 10, "l2")
    np.testing.assert_array_equal(got_p, ids[vis][rows])


def test_search_batch_stream_and_get_match_jax(twin):
    jax_db, port_db, x, ids, u, gone = twin
    q = x[[3, 12_345]] + 0.001
    res_p = port_db.search_batch(q, k=5, with_vectors=True)
    res_j = jax_db.search_batch(q, k=5, with_vectors=True)
    for a, b in zip(res_p, res_j):
        assert [c.id for c in a] == [c.id for c in b]
        assert [c.metadata for c in a] == [c.metadata for c in b]
        np.testing.assert_array_equal(a[0].vector, b[0].vector)
    batches = [x[:8], x[8:20]]
    streamed = list(port_db.search_arrays_stream(iter(batches), k=4, depth=2))
    for qb, (sid, _) in zip(batches, streamed):
        np.testing.assert_array_equal(sid, jax_db.search_arrays(qb, k=4)[0])
    assert port_db.get(int(ids[7])).metadata == jax_db.get(int(ids[7])).metadata
    with pytest.raises(vg.ErrNotFound):
        port_db.get(gone[0])
    assert port_db.stats()["live_rows"] == jax_db.stats()["live_rows"]


def test_filtered_recall_exact_on_wide_masked_corpus():
    """The port of tests/test_engine.py's regression on position-correlated
    data with contiguous categories: filtered results equal brute force."""
    n, d = 30_000, 16
    rng = np.random.default_rng(7)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[:, 0] += np.arange(n) / n * 10
    cats = (np.arange(n) * 100 // n).astype(np.int64)
    db = vg.Open(vg.Memory(), vg.Create(dim=d, flush_threshold=10**9, device="cpu"))
    ids = db.insert_batch(x, [{"cat": int(c)} for c in cats])
    db.commit()
    q = x[rng.integers(0, n, 16)] + 0.05 * rng.standard_normal((16, d)).astype(np.float32)
    for want_cats in (1, 10, 50):
        res = db.search_batch(q, k=10, filter=pmd.isin("cat", list(range(want_cats))))
        elig = np.flatnonzero(cats < want_cats)
        _, ti = tu.brute_force_knn(q, x[elig], 10, "l2")
        assert [[c.id for c in r] for r in res] == [[ids[elig[j]] for j in row] for row in ti]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_db_directory_opens_in_the_other_package(tmp_path, writer):
    r = np.random.default_rng(33)
    x = r.standard_normal((2_000, D)).astype(np.float32)
    q = r.standard_normal((5, D)).astype(np.float32)
    path = str(tmp_path / "db")
    if writer == "jax":
        db = vg.DB(JaxEngine.open(path, JaxEngineOptions(dim=D), create=True))
    else:
        db = vg.Open(vg.Local(path), vg.Create(dim=D, device="cpu"))
    ids = db.insert_batch(x, [{"i": i} for i in range(len(x))])
    db.commit()
    db.delete(ids[0])
    db.commit()
    want, _ = db.search_arrays(q, k=7)
    db.close()
    if writer == "jax":
        other = vg.Open(vg.Local(path), device="cpu")
    else:
        other = vg.DB(JaxEngine.open(path))
    got, _ = other.search_arrays(q, k=7)
    np.testing.assert_array_equal(got, want)
    assert other.get(ids[5]).metadata == {"i": 5}
    with pytest.raises(vg.ErrNotFound if writer == "jax" else JaxErrNotFound):
        other.get(ids[0])
    other.close()


def test_not_ported_paths_raise_with_their_roadmap_item():
    """What is left of the port queue raises with its ROADMAP item (the
    sharded searcher, item 5); graph_build_mode="beam" (item 3d) compacts
    and serves now, and so do lexical and hybrid search (item 4)."""
    db = vg.Open(vg.Memory(), vg.Create(dim=4, device="cpu", graph_threshold=4,
                                        graph_build_mode="beam"))
    ids = db.insert_batch(np.eye(4, dtype=np.float32))
    db.commit()
    ids += db.insert_batch(2 * np.eye(4, dtype=np.float32))
    db.commit()
    db.compact([h.seg_id for h in db.engine._segments])
    seg = db.engine._segments[0].segment
    assert type(seg).__name__ == "VamanaSegment" and seg.n == 8 and seg.meta["alpha"] == 1.2
    assert [c.id for c in db.search(np.eye(4, dtype=np.float32)[2], k=1)] == [ids[2]]
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 5"):
        db.sharded_searcher(None)
    # Hybrid search needs the lexical index, as in the JAX engine.
    with pytest.raises(ValueError, match="lexical index not enabled"):
        db.hybrid_search(np.ones(4, np.float32), "text")
    lex = vg.Open(vg.Memory(), vg.Create(dim=4, lexical=True, device="cpu"))
    lids = lex.insert_batch(np.eye(4, dtype=np.float32), texts=["red fox", "blue fox", "red hen",
                                                                "green owl"])
    assert [c.id for c in lex.hybrid_search(np.eye(4, dtype=np.float32)[2], "red hen", k=1)] == [
        lids[2]]
    # Quantized profiles were item 2 of the queue: they commit and search now.
    q = vg.Open(vg.Memory(), vg.Create(dim=4, quantizer="sq8", device="cpu"))
    ids = q.insert_batch(np.eye(4, dtype=np.float32))
    q.commit()
    assert q.engine._segments[0].segment.quant.kind == "sq8"
    assert [c.id for c in q.search(np.eye(4, dtype=np.float32)[2], k=1)] == [ids[2]]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_compact_tool_round_trip_across_packages(tmp_path, writer):
    """tests/test_integration.py::test_subprocess_compact_worker across the
    packages: one package writes two segments, the other package's
    `tools.compact` merges them in a separate process (--all, the same
    build flags; the port's with --device cpu), and the writing package
    reopens the directory and reads the compacted graph segment."""
    import json
    import os
    import subprocess
    import sys

    d = str(tmp_path / "db")
    opts = dict(dim=16, flush_threshold=10**9, graph_threshold=500, graph_r=12,
                graph_l_build=24)
    x = tu.gaussian_vectors(700, 16, seed=211)
    if writer == "jax":
        db = vg.DB(JaxEngine.open(d, JaxEngineOptions(**opts), create=True))
    else:
        db = vg.Open(vg.Local(d), vg.Create(device="cpu", **opts))
    ids = db.insert_batch(x[:400], [{"i": i} for i in range(400)])
    db.commit()
    ids += db.insert_batch(x[400:], [{"i": 400 + i} for i in range(300)])
    db.commit()
    assert len(db.engine._segments) == 2
    db.close()
    tool = ["vecgo_tpu.tools.compact"] if writer == "port" else [
        "vecgo_tpu_torch.tools.compact", "--device", "cpu"]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", *tool, d, "--all", "--graph-threshold", "500",
                        "--graph-r", "12", "--graph-l-build", "24"],
                       capture_output=True, text=True, timeout=600, cwd=repo)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["rows"] == 700 and out["segment"] == "VamanaSegment" and out["inputs"]
    if writer == "jax":
        db = vg.DB(JaxEngine.open(d, JaxEngineOptions()))
    else:
        db = vg.Open(vg.Local(d), device="cpu")
    assert len(db.engine._segments) == 1
    assert type(db.engine._segments[0].segment).__name__ == "VamanaSegment"
    res = db.search(x[55], k=1, ef=64)
    assert res[0].id == ids[55] and res[0].metadata == {"i": 55}
    db.close()


def test_option_the_port_does_not_honour_raises_when_set():
    """`stream_transport` was the one option whose other value raised; both
    the JAX engine's values are honoured now (tests/test_torch_streaming.py
    drives them), and `lexical` (port queue item 4) is honoured too
    (tests/test_torch_lexical.py): no `EngineOptions` field is left that
    raises when set."""
    assert vg.Create(dim=4, device="cpu").stream_transport == "sq8"
    assert vg.Create(dim=4, device="cpu", stream_transport="pq").stream_transport == "pq"
    db = vg.Open(vg.Memory(), vg.Create(dim=4, device="cpu", lexical=True))
    ids = db.insert_batch(np.eye(4, dtype=np.float32), texts=["a b", "c d", "e f", "g h"])
    assert db.engine._lexical is not None and len(db.engine._lexical) == 4
    got, _ = db.hybrid_search_batch(np.eye(4, dtype=np.float32)[:2], ["c d", "g"], k=2)
    assert got[0, 0] == ids[1] and ids[3] in got[1]
