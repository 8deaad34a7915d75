"""Compact-gather sub-corpora under the port engine's device budget (CPU).

A low-selectivity filter on a flat segment gathers its eligible rows into a
dense device sub-corpus that the plan cache keeps. Under `hbm_budget_bytes`
the port charges those gathers to the budget: the planner gathers only
where the sub-corpus fits what the budget has left after the resident
segments (else the filter rides the full scan as a row mask), and the plan
cache holds its gathers to the smaller of `plan_gather_budget_bytes` and
that room. Without a budget the port plans as the JAX engine does.
"""

import numpy as np
import pytest
import torch

import vecgo_tpu_torch as vg
from vecgo_tpu.blobstore import MemoryStore
from vecgo_tpu.engine import Engine as JaxEngine
from vecgo_tpu.engine import EngineOptions as JaxEngineOptions
from vecgo_tpu_torch import metadata as pmd
from vecgo_tpu_torch.engine import search as S
from vecgo_tpu_torch.index.flat import FlatSegment

torch.set_num_threads(1)

D, N = 32, 20_000


def _kinds(db):
    """Source kinds of every plan the engine's plan cache holds, newest last."""
    return [[s.kind for s in p.sources] for p in db.engine._plan_cache._d.values()]


def _gathered(db) -> int:
    return sum(S.PlanCache._gathered_bytes(p) for p in db.engine._plan_cache._d.values())


@pytest.fixture(scope="module")
def corpus():
    r = np.random.default_rng(13)
    x = r.standard_normal((N, D)).astype(np.float32)
    u = r.integers(0, 100, N)
    q = r.standard_normal((64, D)).astype(np.float32)
    backend = vg.Memory()
    db = vg.Open(backend, vg.Create(dim=D, device="cpu"))
    ids = np.asarray(db.insert_batch(x, [{"u": int(v)} for v in u]))
    db.commit()
    seg = db.engine._segments[0].segment
    assert isinstance(seg, FlatSegment)
    assert (np.diff(ids) > 0).all()
    # u of each id, by its row
    u_of = np.full(ids.max() + 1, -1)
    u_of[ids] = u
    return backend, db, x, u_of, q, seg.device_bytes()


def _reopen(backend, budget):
    return vg.Open(backend, vg.Create(dim=0, device="cpu", hbm_budget_bytes=budget))


def _segment(db) -> FlatSegment:
    return db.engine._segments[0].segment


def _sub_bytes(db, u, lo, hi):
    return _segment(db).gathered_bytes(int(((u >= lo) & (u < hi)).sum()), "bf16")


def _rows(u):
    return u[u >= 0]


def test_ten_percent_filter_gathers_when_the_budget_has_room(corpus):
    backend, db0, x, u, q, seg_bytes = corpus
    db = _reopen(backend, 4 * seg_bytes)
    f = pmd.lt("u", 10)
    ids, _ = db.search_arrays(q, k=10, filter=f)
    assert _kinds(db) == [["flat_compact"]]
    ids0, _ = db0.search_arrays(q, k=10, filter=f)
    np.testing.assert_array_equal(ids, ids0)
    hbm = db.stats()["hbm"]
    assert hbm["used_bytes"] + _gathered(db) <= hbm["budget_bytes"]


def test_filter_rides_the_masked_scan_when_the_gather_does_not_fit(corpus):
    """With the budget just above the segment's device_bytes() the same
    filter plans the masked full scan, with the compact plan's ids."""
    backend, db0, x, u, q, seg_bytes = corpus
    need = _sub_bytes(db0, u, 0, 10)
    db = _reopen(backend, seg_bytes + need // 2)
    f = pmd.lt("u", 10)
    ids, d = db.search_arrays(q, k=10, filter=f)
    assert _kinds(db) == [["flat"]]
    assert _gathered(db) <= need // 2  # the uploaded mask, no sub-corpus
    roomy = _reopen(backend, seg_bytes + 2 * need)
    ids_c, d_c = roomy.search_arrays(q, k=10, filter=f)
    assert _kinds(roomy) == [["flat_compact"]]
    np.testing.assert_array_equal(ids, ids_c)
    np.testing.assert_allclose(d, d_c, rtol=1e-5, atol=1e-4)
    assert (u[ids] < 10).all()


def test_gathers_stay_within_the_budget_over_distinct_filters(corpus):
    """Ten distinct 10% filters, with room for about two gathers beside the
    segment: after every search the resident segment plus the plan cache's
    gathered state stay within the budget, and every filter was served by
    the filter's own rows."""
    backend, db0, x, u, q, seg_bytes = corpus
    budget = seg_bytes + int(2.5 * _sub_bytes(db0, u, 0, 10))
    db = _reopen(backend, budget)
    for i in range(10):
        f = pmd.isin("u", range(10 * i, 10 * i + 10))
        ids, _ = db.search_arrays(q, k=10, filter=f)
        hbm = db.stats()["hbm"]
        assert hbm["used_bytes"] + _gathered(db) <= budget
        assert ((u[ids] >= 10 * i) & (u[ids] < 10 * i + 10)).all()
        assert _kinds(db)[-1] in (["flat_compact"], ["flat"])
    assert ["flat_compact"] in _kinds(db)


def test_gathers_stay_within_the_budget_while_they_are_allocated(corpus, monkeypatch):
    """The same run of distinct filters, read at the moment each gather is
    allocated (the plan cache still holding the earlier plans' gathers):
    resident bytes plus every gather held stay within the budget at their
    peak, not only after each search."""
    backend, db0, x, u, q, seg_bytes = corpus
    budget = seg_bytes + int(2.5 * _sub_bytes(db0, u, 0, 10))
    db = _reopen(backend, budget)
    gather, peaks = FlatSegment.gather, []

    def watched(*a):
        cc = gather(*a)
        new = sum(int(v.nbytes) for v in cc.values())
        peaks.append(db.stats()["hbm"]["used_bytes"] + _gathered(db) + new)
        return cc

    monkeypatch.setattr(FlatSegment, "gather", watched)
    for i in range(10):
        db.search_arrays(q, k=10, filter=pmd.isin("u", range(10 * i, 10 * i + 10)))
    assert len(peaks) >= 3
    assert max(peaks) <= budget


def _watch_gathers(monkeypatch, db):
    """Resident bytes plus every gather held, read at each gather's
    allocation: the plan cache's plans and the plans of the batches in flight
    (dispatched, not yet drained), each plan once, whether or not the cache
    still has it. Returns the list the peaks go to."""
    inflight, peaks = {}, []
    dispatch, drain, gather = S._dispatch_batch, S._drain_batch, FlatSegment.gather

    def dispatched(*a, **kw):
        pending = dispatch(*a, **kw)
        inflight[id(pending)] = pending
        return pending

    def drained(pending, *a, **kw):
        out = drain(pending, *a, **kw)
        inflight.pop(id(pending))
        return out

    def watched(*a):
        cc = gather(*a)
        plans = {id(p): p for p in db.engine._plan_cache._d.values()}
        plans.update((id(p.plan), p.plan) for p in inflight.values())
        held = sum(S.PlanCache._gathered_bytes(p) for p in plans.values())
        new = sum(int(v.nbytes) for v in cc.values())
        peaks.append(db.stats()["hbm"]["used_bytes"] + held + new)
        return cc

    monkeypatch.setattr(S, "_dispatch_batch", dispatched)
    monkeypatch.setattr(S, "_drain_batch", drained)
    monkeypatch.setattr(FlatSegment, "gather", watched)
    return peaks


def _assert_batches_match(got, want):
    """Stream results against search_arrays' batch by batch: the same ids,
    and distances within the exact f32 rerank's rounding (a gathered and a
    masked plan rerank the same rows)."""
    assert len(got) == len(want)
    for (ids, d), (ids_w, d_w) in zip(got, want):
        np.testing.assert_array_equal(ids, ids_w)
        np.testing.assert_allclose(d, d_w, rtol=1e-5, atol=1e-4)


def test_gathers_of_batches_in_flight_stay_within_the_budget(corpus, monkeypatch):
    """Six streams with distinct 10% filters, three batches each, advanced
    in turns through search_arrays_stream(depth=3) under a budget that holds
    the resident segment plus about one gather. A stream's batches in
    flight hold their plan's gather whether or not the plan cache still has
    the plan, so a later filter gathers only beside them (else it rides the
    masked scan): resident bytes plus the gathers of the cache and of the
    batches in flight stay within the budget at every gather's allocation,
    and every batch returns what search_arrays returns for it."""
    backend, db0, x, u, q, seg_bytes = corpus
    budget = seg_bytes + int(1.5 * _sub_bytes(db0, u, 0, 10))
    db = _reopen(backend, budget)
    peaks = _watch_gathers(monkeypatch, db)
    filters = [pmd.isin("u", range(10 * i, 10 * i + 10)) for i in range(6)]
    batches = [q[16 * j : 16 * j + 16] for j in range(3)]
    streams = [db.search_arrays_stream(iter(batches), k=10, depth=3, filter=f) for f in filters]
    got = [[] for _ in filters]
    live = list(range(len(streams)))
    while live:
        for i in list(live):
            try:
                got[i].append(next(streams[i]))
            except StopIteration:
                live.remove(i)
    assert peaks and max(peaks) <= budget
    assert not db.engine._plan_cache._held
    for f, g in zip(filters, got):
        _assert_batches_match(g, [db.search_arrays(b, k=10, filter=f) for b in batches])


def test_a_stream_drains_its_own_batches_before_it_gathers_again(corpus, monkeypatch):
    """A commit clears the plan cache while a stream (depth 3) has batches
    in flight on its snapshot: its next batch plans its filter again and
    needs the gather that its own batches in flight still hold. It drains
    them first, so the new gather fits beside nothing else and the filter
    keeps its compact gather; results are the snapshot's, batch by batch."""
    backend, db0, x, u, q, seg_bytes = corpus
    store = vg.Memory()
    db = vg.Open(store, vg.Create(dim=D, device="cpu"))
    db.insert_batch(x, [{"u": int(v)} for v in _rows(u)])
    db.commit()
    db.close()
    db = _reopen(store, seg_bytes + int(1.5 * _sub_bytes(db0, u, 0, 10)))
    f = pmd.lt("u", 10)
    batches = [q[8 * j : 8 * j + 8] for j in range(8)]
    want = [db.search_arrays(b, k=10, filter=f) for b in batches]
    peaks = _watch_gathers(monkeypatch, db)
    stream = db.search_arrays_stream(iter(batches), k=10, depth=3, filter=f)
    got = [next(stream)]
    db.insert_batch(x[:1], [{"u": 200}])
    db.commit()
    assert not db.engine._plan_cache._d
    got += list(stream)
    assert peaks and max(peaks) <= db.stats()["hbm"]["budget_bytes"]
    assert ["flat_compact"] in _kinds(db)
    assert not db.engine._plan_cache._held
    _assert_batches_match(got, want)


@pytest.mark.parametrize("scan_dtype", ["bf16", "f32"])
def test_compact_bytes_is_what_the_gather_holds(corpus, scan_dtype):
    """The budget charges a gather `FlatSegment.gathered_bytes`, which is
    what the gathered copy holds under each scan profile."""
    backend, db0, x, u, q, seg_bytes = corpus
    db = vg.Open(backend, vg.Create(dim=0, device="cpu", hbm_budget_bytes=4 * seg_bytes,
                                    flat_scan_dtype=scan_dtype))
    db.search_arrays(q, k=10, filter=pmd.lt("u", 10))
    assert _kinds(db) == [["flat_compact"]]
    rows = len(np.flatnonzero(_rows(u) < 10))
    assert _gathered(db) == _segment(db).gathered_bytes(rows, scan_dtype)


@pytest.fixture(scope="module")
def jax_db(corpus):
    _, _, x, u, _, _ = corpus
    jdb = vg.DB(JaxEngine.open(MemoryStore(), JaxEngineOptions(dim=D), create=True))
    jdb.insert_batch(x, [{"u": int(v)} for v in _rows(u)])
    jdb.commit()
    return jdb


@pytest.mark.parametrize("sel", [1, 10, 50, 80])
def test_without_a_budget_plans_match_the_jax_engine(corpus, jax_db, sel):
    """No budget: the port's plan for a filter of each selectivity is the
    JAX engine's (compact gather at or below its cutoff, the masked scan
    above), and the gathers are bounded by plan_gather_budget_bytes alone."""
    backend, db0, x, u, q, seg_bytes = corpus
    from vecgo_tpu import metadata as jmd

    jdb = jax_db
    jdb.engine._plan_cache.clear()
    port = _reopen(backend, 0)
    assert port.stats()["hbm"] is None
    ids_p, _ = port.search_arrays(q, k=10, filter=pmd.lt("u", sel))
    ids_j, _ = jdb.search_arrays(q, k=10, filter=jmd.lt("u", sel))
    jkinds = [[s.kind for s in p.sources] for p in jdb.engine._plan_cache._d.values()]
    assert _kinds(port) == jkinds
    np.testing.assert_array_equal(ids_p, np.asarray(ids_j))
