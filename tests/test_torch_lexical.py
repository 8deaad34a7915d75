"""BM25 and hybrid search in the port (device="cpu") against the JAX package.

`lexical/bm25.py` is a copy: the same corpus gives bit-identical scores.
`lexical/device_bm25.py` builds the same hot vocabulary and the same bf16
table (bit for bit, as uint16; the port pads the width with zero columns to
a multiple of 64) and answers with the same pool, so its ids equal the JAX
class's except among exact-score ties, and its scores agree within 1e-5
relative: both sum <= 16 bf16 weights in f32, in another order. Fixtures
stay below 16,384 slots, where the JAX sweep's selection is exact
(`lax.top_k`, not `approx_min_k`). The hybrid fusion is the JAX engine's
code, so the same vector and lexical lists give the same ids and RRF mass
(within 1e-12; the sums are the same f64 additions).
"""

import numpy as np
import pytest
import torch

import vecgo_tpu_torch as vg
from vecgo_tpu.blobstore import MemoryStore as JaxMemoryStore
from vecgo_tpu.engine import Engine as JaxEngine
from vecgo_tpu.engine import EngineOptions as JaxEngineOptions
from vecgo_tpu.lexical.bm25 import BM25Index as JaxBM25Index
from vecgo_tpu.lexical.bm25 import tokenize as jax_tokenize
from vecgo_tpu.lexical.device_bm25 import DeviceBM25 as JaxDeviceBM25
from vecgo_tpu.utils import testutil as tu
from vecgo_tpu_torch import convert
from vecgo_tpu_torch.blobstore import MemoryStore
from vecgo_tpu_torch.engine import Engine, EngineOptions
from vecgo_tpu_torch.engine import engine as engine_mod
from vecgo_tpu_torch.lexical.bm25 import BM25Index, tokenize
from vecgo_tpu_torch.lexical.device_bm25 import DeviceBM25
from vecgo_tpu_torch.ops import scan_topk as scan_mod

torch.set_num_threads(1)

WORDS = [f"word{i}" for i in range(300)]
D = 16
REL = 1e-5


def _build(cls=BM25Index, n_docs=1500, seed=3):
    """tests/test_lexical_device.py's fixture: zipf-ish words, low word ids
    hot, a df=1 term on every 97th doc."""
    rng = np.random.default_rng(seed)
    idx = cls()
    for i in range(n_docs):
        wl = rng.zipf(1.3, 12)
        doc = " ".join(WORDS[min(int(w) - 1, 299)] for w in wl)
        if i % 97 == 0:
            doc += f" rareterm{i}"
        idx.add(i + 1, doc)
    return idx


def _queries(n=120, seed=5):
    rng = np.random.default_rng(seed)
    qs = [" ".join(WORDS[min(int(w) - 1, 299)] for w in rng.zipf(1.3, 3)) for _ in range(n)]
    # Rare terms, unknown and empty queries, more than 16 hot terms.
    return qs + ["rareterm97 word1", "word3", "rareterm194", "zzz qqq", "",
                 "word1 zzz", " ".join(WORDS[:40]), "rareterm0 rareterm388 word2"]


def _pair(delete=()):
    j, p = _build(JaxBM25Index), _build()
    for i in delete:
        assert j.delete(i) and p.delete(i)
    return j, p


def _assert_same_up_to_ties(ji, js, pi, ps):
    """Scores within REL at every rank; ids equal except inside a group of
    ranks whose JAX scores tie exactly (the last group may be cut by k)."""
    assert ji.shape == pi.shape
    np.testing.assert_array_equal(ji < 0, pi < 0)
    np.testing.assert_allclose(ps, js, rtol=REL, atol=0)
    for r in range(len(ji)):
        for j in np.nonzero(ji[r] != pi[r])[0]:
            tied = js[r] == js[r, j]
            assert tied.sum() > 1, (r, j, ji[r], pi[r], js[r])
            if not tied[-1]:
                assert set(ji[r][tied]) == set(pi[r][tied]), (r, ji[r], pi[r])


# ---- the exact host index: a copy ----


@pytest.mark.parametrize("delete", [(), (1, 98, 500, 1499)])
def test_bm25_copy_scores_bit_identical(delete):
    j, p = _pair(delete)
    qs = _queries()
    assert [tokenize(q) for q in qs] == [jax_tokenize(q) for q in qs]
    assert p.search_batch(qs, k=10) == j.search_batch(qs, k=10)
    assert [p.search(q, k=7) for q in qs] == [j.search(q, k=7) for q in qs]
    assert len(p) == len(j)


# ---- the device snapshot against the JAX class ----


@pytest.mark.parametrize("hot,min_df,delete", [(256, 4, ()), (64, 2, ()), (256, 4, (1, 2, 3, 98)),
                                               (4096, 8, ())])
def test_device_bm25_matches_jax(hot, min_df, delete):
    j, p = _pair(delete)
    jd = JaxDeviceBM25(j, max_hot_terms=hot, min_df=min_df)
    pd = DeviceBM25(p, max_hot_terms=hot, min_df=min_df, device="cpu")
    assert pd.hot == jd.hot and pd.n_slots == jd.n_slots and pd.n_docs == jd.n_docs
    jw = jd.w_host.view(np.uint16)
    pw = pd._w.view(torch.int16).numpy().view(np.uint16)
    assert pw.shape == (jd.n_slots, -(-len(jd.hot) // 64) * 64)
    np.testing.assert_array_equal(pw[:, : jw.shape[1]], jw)
    assert not pw[:, jw.shape[1]:].any()
    assert pd.device_bytes() == pw.size * 2
    qs = _queries()
    jc, jr = jd.encode_queries(qs)
    pc, pr = pd.encode_queries(qs)
    np.testing.assert_array_equal(pc, jc)
    assert pr == jr
    for k in (1, 10, 20):
        ji, js = jd.search_batch_arrays(qs, k)
        pi, ps = pd.search_batch_arrays(qs, k)
        _assert_same_up_to_ties(ji, js, pi, ps)
    assert pd.search_batch(qs[:9], 5) == [
        [(i, s) for i, s in zip(*row) if i >= 0]
        for row in zip(*(a.tolist() for a in pd.search_batch_arrays(qs[:9], 5)))]


def test_device_bm25_with_no_doc_or_no_hot_term_answers_from_the_index():
    """The JAX semantics, not a device fallback: an index with no docs, or
    with no term at min_df, answers from index.search_batch."""
    empty = DeviceBM25(BM25Index(), device="cpu")
    ids, sc = empty.search_batch_arrays(["word1", ""], 4)
    assert (ids == -1).all() and (sc == 0).all() and empty.device_bytes() == 0
    p = _build()
    cold = DeviceBM25(p, min_df=10**6, device="cpu")
    assert not cold.hot and cold._w is None
    qs = _queries(20)
    want = p.search_batch(qs, 5)
    ids, sc = cold.search_batch_arrays(qs, 5)
    for r, hits in enumerate(want):
        assert ids[r, : len(hits)].tolist() == [i for i, _ in hits]
        np.testing.assert_array_equal(sc[r, : len(hits)], np.float32([s for _, s in hits]))


def test_device_bm25_is_a_snapshot_across_release_and_writes():
    """release_device() drops the table; the next search rebuilds it from
    the postings below the snapshot's slot count, so writes the index took
    since change nothing the snapshot answers."""
    p = _build()
    pd = DeviceBM25(p, max_hot_terms=256, min_df=4, device="cpu")
    qs = _queries(40)
    before = pd.search_batch_arrays(qs, 10)
    table = pd._w.clone()
    pd.release_device()
    assert pd._w is None
    for i in range(50):
        p.add(10_000 + i, "word1 word2 word3 rareterm97 newterm")
    p.delete(2)
    after = pd.search_batch_arrays(qs, 10)
    assert torch.equal(pd._w, table)
    np.testing.assert_array_equal(after[0], before[0])
    np.testing.assert_array_equal(after[1], before[1])


def test_device_bm25_on_cuda_needs_a_card():
    """No fallback: without a card, device="cuda" raises; with one, the
    table lies on it."""
    if torch.cuda.is_available():
        assert DeviceBM25(_build(n_docs=50), min_df=2, device="cuda")._w.is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceBM25(_build(n_docs=50), device="cuda")


# ---- tests/test_lexical_device.py's criteria against the port's exact index ----


def test_device_matches_exact_on_hot_queries():
    idx = _build()
    dev = DeviceBM25(idx, max_hot_terms=256, min_df=4, device="cpu")
    queries = ["word1 word7 word30", "word2", "word5 word5 word11", "word40 word90"]
    got = dev.search_batch(queries, k=10)
    want = idx.search_batch(queries, k=10)
    for g, w in zip(got, want):
        gi = [id_ for id_, _ in g]
        wi = [id_ for id_, _ in w]
        assert gi[0] == wi[0]
        assert len(set(gi) & set(wi)) >= max(1, int(0.7 * len(wi))), (gi, wi)
        wmap = dict(w)
        for id_, s in g:
            if id_ in wmap:
                assert abs(s - wmap[id_]) < 2e-2 * max(1.0, abs(wmap[id_]))


def test_rare_term_host_merge():
    idx = _build()
    dev = DeviceBM25(idx, max_hot_terms=256, min_df=4, device="cpu")
    q = ["rareterm97 word1", "word3"]
    got = dev.search_batch(q, k=5)
    want = idx.search_batch(q, k=5)
    assert [i for i, _ in got[0]] == [i for i, _ in want[0]]
    for (gi, gs), (wi, ws) in zip(got[0], want[0]):
        assert abs(gs - ws) < 2e-2 * max(1.0, abs(ws))
    assert 98 in [id_ for id_, _ in got[0]]
    got2 = dev.search_batch(["rareterm194"], k=3)[0]
    want2 = idx.search_batch(["rareterm194"], k=3)[0]
    assert [i for i, _ in got2] == [i for i, _ in want2]


def test_unknown_terms_and_empty_query():
    idx = _build()
    dev = DeviceBM25(idx, max_hot_terms=256, min_df=4, device="cpu")
    got = dev.search_batch(["zzz qqq", "", "word1 zzz"], k=5)
    assert got[0] == [] and got[1] == []
    want = idx.search_batch(["word1 zzz"], k=5)
    assert [id_ for id_, _ in got[2]][0] == [id_ for id_, _ in want[0]][0]


def test_deletes_respected():
    idx = _build()
    victim = idx.search_batch(["word1"], k=3)[0][0][0]
    idx.delete(victim)
    dev = DeviceBM25(idx, max_hot_terms=256, min_df=4, device="cpu")
    got = dev.search_batch(["word1"], k=10)[0]
    assert victim not in [id_ for id_, _ in got]


# ---- the engine: tests/test_engine.py's hybrid tests on the port ----


def new_engine(store=None, **kw):
    kw.setdefault("dim", D)
    kw.setdefault("flush_threshold", 10_000_000)
    kw.setdefault("graph_threshold", 1_000_000_000)
    return Engine.open(store or MemoryStore(), EngineOptions(device="cpu", **kw), create=True)


def new_jax_engine(store=None, **kw):
    kw.setdefault("dim", D)
    kw.setdefault("flush_threshold", 10_000_000)
    kw.setdefault("graph_threshold", 1_000_000_000)
    return JaxEngine.open(store or JaxMemoryStore(), JaxEngineOptions(**kw), create=True)


def test_hybrid_search_rrf():
    store = MemoryStore()
    eng = new_engine(store=store, lexical=True)
    x = tu.gaussian_vectors(50, D, seed=52)
    texts = [f"document about topic {i % 5} and stuff" for i in range(50)]
    texts[3] = "the quick brown fox jumps over the lazy dog"
    ids = eng.insert_batch(x, texts=texts)
    res = eng.hybrid_search(x[3], "quick brown fox", k=5)
    assert res[0].id == ids[3]
    eng.commit()
    res = eng.hybrid_search(x[3], "quick brown fox", k=5)
    assert res[0].id == ids[3]
    eng.close()
    eng2 = Engine.open(store, EngineOptions(dim=D, lexical=True, device="cpu"))
    res = eng2.hybrid_search(x[3], "quick brown fox", k=5)
    assert res[0].id == ids[3]
    eng2.close()


def _hybrid_fixture(eng):
    x = tu.gaussian_vectors(80, D, seed=54)
    texts = [f"document about topic {i % 7} and filler words {i}" for i in range(80)]
    texts[3] = "the quick brown fox jumps over the lazy dog"
    texts[11] = "a quick dog naps"
    ids = eng.insert_batch(x, texts=texts)
    eng.delete(ids[5])
    queries = np.stack([x[3], x[11], x[40]])
    qtexts = ["quick brown fox", "quick dog", "topic 5 filler"]
    return ids, queries, qtexts


def test_hybrid_search_batch_matches_single():
    eng = new_engine(lexical=True)
    ids, queries, qtexts = _hybrid_fixture(eng)
    bids, bsc = eng.hybrid_search_batch(queries, qtexts, k=5)
    assert bids.shape == (3, 5) and bsc.shape == (3, 5)
    for bi in range(3):
        single = eng.hybrid_search(queries[bi], qtexts[bi], k=5)
        want = [c.id for c in single]
        got = [int(i) for i in bids[bi] if i >= 0]
        assert got == want, (bi, got, want)
        for j, c in enumerate(single):
            assert abs(-c.distance - float(bsc[bi, j])) < 1e-6
    assert int(bids[0, 0]) == ids[3]


@pytest.mark.parametrize("lexical_path", ["exact", "device"])
@pytest.mark.parametrize("commit", [False, True])
def test_hybrid_matches_jax_engine(lexical_path, commit):
    """The same writes through both engines: hybrid_search and
    hybrid_search_batch (through the exact index or a device snapshot) give
    the same ids and RRF mass within 1e-12."""
    engines = [new_jax_engine(lexical=True), new_engine(lexical=True)]
    x = tu.gaussian_vectors(400, D, seed=61)
    rng = np.random.default_rng(62)
    texts = [" ".join(WORDS[min(int(w) - 1, 299)] for w in rng.zipf(1.3, 10)) for _ in range(400)]
    texts[17] = "quick brown fox " + texts[17]
    q = tu.gaussian_vectors(24, D, seed=63)
    q[0] = x[17]
    qtexts = [" ".join(WORDS[min(int(w) - 1, 299)] for w in rng.zipf(1.3, 3)) for _ in range(24)]
    qtexts[0] = "quick brown fox"
    out = []
    for eng in engines:
        ids = eng.insert_batch(x, texts=texts)
        for i in ids[::37]:
            eng.delete(i)
        if commit:
            eng.commit()
        eng.insert(x[5] + 0.01, text="quick brown fox word1", id=ids[5])
        if lexical_path == "device":
            assert eng.enable_device_lexical(max_hot_terms=64, min_df=2).device_bytes() > 0
        singles = [eng.hybrid_search(q[i], qtexts[i], k=7) for i in range(len(q))]
        bids, bsc = eng.hybrid_search_batch(q, qtexts, k=7)
        out.append((ids, [[(c.id, c.distance) for c in s] for s in singles], bids, bsc))
    (jids, jsingle, jbids, jbsc), (pids, psingle, pbids, pbsc) = out
    assert jids == pids
    for js, ps in zip(jsingle, psingle):
        assert [i for i, _ in ps] == [i for i, _ in js]
        np.testing.assert_allclose([d for _, d in ps], [d for _, d in js], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(pbids, jbids)
    np.testing.assert_allclose(pbsc, jbsc, rtol=0, atol=1e-12)
    assert pbids[0, 0] in (pids[17], pids[5])


def test_auto_device_snapshot_and_its_invalidation(monkeypatch):
    """tests/test_lexical_device.py's engine test, with the auto-build
    threshold lowered: hybrid_search_batch builds the snapshot by itself,
    keys it to (version, lsn), and a write sends the next batch to the
    exact path until a batch rebuilds it."""
    monkeypatch.setattr(engine_mod, "DEVICE_LEXICAL_MIN_DOCS", 100)
    eng = new_engine(lexical=True)
    x = tu.gaussian_vectors(200, D, seed=9)
    texts = [f"body word{i % 23} word{i % 7} filler" for i in range(200)]
    texts[5] = "unique golden phrase word1"
    ids = eng.insert_batch(x, texts=texts)
    eng.commit()
    snap = eng.enable_device_lexical(max_hot_terms=64, min_df=2)
    assert snap.device_bytes() > 0
    bids, _ = eng.hybrid_search_batch(np.stack([x[5]]), ["unique golden phrase"], k=5)
    assert int(bids[0, 0]) == ids[5] and eng._lexical_dev[1] is snap
    eng.insert(x[0], text="fresh doc word1")
    key = (eng._version, eng._lsn)
    bids2, _ = eng.hybrid_search_batch(np.stack([x[5]]), ["golden phrase"], k=5)
    assert int(bids2[0, 0]) == ids[5]
    rebuilt = eng._lexical_dev
    assert rebuilt[0] == key and rebuilt[1] is not snap and rebuilt[1].n_docs == 201
    # Off: a stale snapshot is not rebuilt, and the exact path answers.
    eng.options.lexical_device = "off"
    eng.delete(ids[5])
    bids3, _ = eng.hybrid_search_batch(np.stack([x[5]]), ["golden phrase"], k=5)
    assert eng._lexical_dev is rebuilt and ids[5] not in bids3
    # Below the threshold the auto mode answers exactly too.
    monkeypatch.setattr(engine_mod, "DEVICE_LEXICAL_MIN_DOCS", 10**6)
    eng.options.lexical_device = "auto"
    eng.insert(x[1], text="one more")
    eng.hybrid_search_batch(np.stack([x[5]]), ["golden phrase"], k=5)
    assert eng._lexical_dev is rebuilt


def test_hybrid_batch_through_snapshot_launches_the_sweep(monkeypatch):
    """The device snapshot's sweep goes through
    ops/scan_topk.scan_topk_columns (on a CPU tensor its plain version) with
    the queries' [B, 16] hot columns, the bf16 table and the alive mask, at
    kk = min(pool + margin, n_slots)."""
    calls = []
    real = scan_mod.scan_topk_columns

    def spy(cols, x, k, mask=None):
        calls.append((tuple(cols.shape), x.dtype, tuple(x.shape), k,
                      None if mask is None else mask.dtype))
        return real(cols, x, k, mask=mask)

    import vecgo_tpu_torch.lexical.device_bm25 as dbm
    monkeypatch.setattr(dbm, "scan_topk_columns", spy)
    eng = new_engine(lexical=True)
    ids, queries, qtexts = _hybrid_fixture(eng)
    snap = eng.enable_device_lexical(max_hot_terms=64, min_df=2)
    eng.hybrid_search_batch(queries, qtexts, k=10)
    assert calls == [((3, 16), torch.bfloat16, (snap.n_slots, 64), 36, torch.bool)]


# ---- databases across the packages ----


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lexical_database_opens_in_the_other_package(tmp_path, writer):
    """A lexical=True directory written (two segments and a memtable
    commit) by one package opens in the other, rebuilds its BM25 index from
    the "_text" column, and answers hybrid_search as the writer does."""
    d = str(tmp_path / "db")
    x = tu.gaussian_vectors(300, D, seed=71)
    rng = np.random.default_rng(72)
    texts = [" ".join(WORDS[min(int(w) - 1, 299)] for w in rng.zipf(1.3, 8)) for _ in range(300)]
    texts[42] = "needle haystack " + texts[42]
    opts = dict(dim=D, lexical=True, flush_threshold=10**9)
    if writer == "jax":
        db = vg.DB(JaxEngine.open(d, JaxEngineOptions(**opts), create=True))
    else:
        db = vg.Open(vg.Local(d), vg.Create(device="cpu", **opts))
    ids = db.insert_batch(x[:200], texts=texts[:200])
    db.commit()
    ids += db.insert_batch(x[200:], texts=texts[200:])
    db.commit()
    qtexts = ["needle haystack", "word1 word2", "word7", "word30 word3"]
    want = [[c.id for c in db.hybrid_search(x[42 + i], t, k=6)] for i, t in enumerate(qtexts)]
    db.close()
    if writer == "jax":
        other = vg.Open(vg.Local(d), device="cpu")
    else:
        other = vg.DB(JaxEngine.open(d, JaxEngineOptions()))
    got = [[c.id for c in other.hybrid_search(x[42 + i], t, k=6)] for i, t in enumerate(qtexts)]
    assert got == want and got[0][0] == ids[42]
    other.close()


def test_reopen_does_not_index_deleted_docs():
    """A reference fault the port repairs (ROADMAP.md §3): the JAX engine's
    reopen indexes every segment row with text, deleted ones too, and its
    hybrid_search_batch then returns a deleted id; the port indexes only the
    row the PK index sees."""
    x = tu.gaussian_vectors(50, D, seed=73)
    texts = [f"doc about topic {i % 5}" for i in range(50)]
    texts[7] = "unique golden phrase"
    found = {}
    for name, store, make, opts in (
            ("jax", JaxMemoryStore(), JaxEngine.open, JaxEngineOptions),
            ("port", MemoryStore(), Engine.open,
             lambda **kw: EngineOptions(device="cpu", **kw))):
        eng = make(store, opts(dim=D, lexical=True), create=True)
        ids = eng.insert_batch(x, texts=texts)
        eng.commit()
        eng.delete(ids[7])
        eng.commit()
        before, _ = eng.hybrid_search_batch(x[:1], ["golden phrase"], k=5)
        eng.close()
        eng = make(store, opts(dim=D, lexical=True))
        after, _ = eng.hybrid_search_batch(x[:1], ["golden phrase"], k=5)
        found[name] = (ids[7] in before, ids[7] in after, after.tolist() == before.tolist())
        eng.close()
    assert found["jax"] == (False, True, False)
    assert found["port"] == (False, False, True)


# ---- examples/hybrid_rag.py through the port ----


DOCS = [
    "jax compiles numerical programs for tpus",
    "the quick brown fox jumps over the lazy dog",
    "vector databases answer nearest neighbor queries",
    "bm25 ranks documents by term frequency statistics",
    "tpus multiply matrices with a systolic array",
    "hybrid search fuses lexical and semantic signals",
]


def test_hybrid_rag_example_through_the_port():
    """examples/hybrid_rag.py's six documents and query: the port's API
    gives the JAX example's top hits (embeddings made once, fed to both)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "hybrid_rag.py")
    spec = importlib.util.spec_from_file_location("hybrid_rag", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    assert ex.DOCS == DOCS
    embs = ex.fake_embed(DOCS)
    query = "how do tpus do matrix multiplication"
    qv = ex.fake_embed([query])[0]
    hits = []
    for db in (vg.DB(JaxEngine.open(JaxMemoryStore(), JaxEngineOptions(dim=48, lexical=True),
                                    create=True)),
               vg.Open(vg.Memory(), vg.Create(dim=48, lexical=True, device="cpu"))):
        db.insert_batch(embs, texts=DOCS, payloads=[d.encode() for d in DOCS])
        db.commit()
        hits.append([(h.payload.decode(), -h.distance) for h in db.hybrid_search(qv, query, k=3)])
        db.close()
    assert hits[1] == hits[0] and len(hits[1]) == 3
    # fake_embed hashes tokens (the process's hash seed), so which of the two
    # "tpus" documents leads varies; one of them always does: its BM25 rank
    # adds to whatever vector rank it has.
    assert "tpus" in hits[1][0][0].split()


# ---- convert ----


def test_convert_bm25_and_device_snapshot_from_jax():
    j = _build(JaxBM25Index)
    j.delete(98)
    p = convert.bm25_from_jax(j)
    qs = _queries()
    assert p.search_batch(qs, 10) == j.search_batch(qs, 10)
    j.add(99_999, "word1 fresh")  # the copy does not share the JAX lists
    assert 99_999 not in p._doc_slot and len(p) == len(j) - 1
    jd = JaxDeviceBM25(j, max_hot_terms=256, min_df=4)
    pd = convert.device_bm25_from_jax(jd, "cpu")
    assert pd.hot == jd.hot and pd.n_slots == jd.n_slots
    pw = pd._w.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(pw[:, : jd.w_host.shape[1]], jd.w_host.view(np.uint16))
    ji, js = jd.search_batch_arrays(qs, 10)
    pi, ps = pd.search_batch_arrays(qs, 10)
    _assert_same_up_to_ties(ji, js, pi, ps)
    own = DeviceBM25(pd.index, max_hot_terms=256, min_df=4, device="cpu")
    assert torch.equal(own._w, pd._w)
