"""Spans and counters of the port's search path (`engine/tracing.py`; on the
CPU, and one test on the card).

A stream over a memtable and a flat segment with deletes and updates: every
span of a batch shares its id from the plan to `_finish`, the counters agree
with what the planner computed and with a brute count over the merged
arrays, answers do not change with recording on, and with tracing off the
path builds no span, enters no `record_function`, records no CUDA event and
makes no counting pass. Under `torch.profiler` the spans are `vecgo.*`
ranges of the trace. A filtered stream adds the plan's filter masks, the
compact gather and the masked memtable scan's counts.
"""

import numpy as np
import pytest
import torch

import vecgo_tpu_torch as vg
from vecgo_tpu_torch import metadata as vmeta
from vecgo_tpu_torch.engine import search as S
from vecgo_tpu_torch.engine import tracing
from vecgo_tpu_torch.engine.pk import DELETED
from vecgo_tpu_torch.index.flat import FlatSegment

torch.set_num_threads(1)

D, N, TAIL, K = 16, 3000, 400, 10
UPDATED = np.arange(0, 400, 10)  # committed ids given a second version in the memtable
DELETED_IDS = np.arange(1000, 1060)

STEPS = ("finish.decode", "finish.visibility", "finish.dedup", "finish.compact")
DISPATCH = ("planner.upload", "source.memtable", "source.flat", "planner.merge")


@pytest.fixture(scope="module")
def corpus():
    r = np.random.default_rng(7)
    x = r.standard_normal((N, D)).astype(np.float32)
    db = vg.Open(vg.Memory(), vg.Create(dim=D, device="cpu"))
    db.insert_batch(x, ids=np.arange(N))
    db.commit()
    db.insert_batch(r.standard_normal((TAIL, D)).astype(np.float32),
                    ids=np.arange(N, N + TAIL))
    db.insert_batch(x[UPDATED] + 0.01, ids=UPDATED)
    for i in DELETED_IDS:
        assert db.delete(int(i))
    # Queries near updated and deleted rows, so dirty ids reach the merge.
    near = np.concatenate([x[UPDATED[:24]], x[DELETED_IDS[:24]]])
    q = (near + 0.05 * r.standard_normal(near.shape)).astype(np.float32)
    return db, [q[i : i + 16] for i in range(0, 48, 16)]


def _stream(db, batches, depth=2):
    return list(db.search_arrays_stream(iter(batches), k=K, depth=depth))


def _by_batch(records):
    out = {}
    for r in records:
        out.setdefault(r.batch, []).append(r)
    return out


def test_every_span_of_a_batch_shares_its_id(corpus):
    db, batches = corpus
    with tracing.recording() as rec:
        _stream(db, batches)
    spans = _by_batch(rec.spans())
    assert None not in spans and len(spans) == 3
    for bid, sp in spans.items():
        names = [s.name for s in sp]
        for name in ("planner.plan", "planner.dispatch", "planner.wait", "planner.finish",
                     *DISPATCH, *STEPS):
            assert names.count(name) == 1, (bid, name, names)
        by = {s.name: s for s in sp}
        for name in STEPS:
            assert by[name].parent == "planner.finish"
            assert by["planner.finish"].t0_ns <= by[name].t0_ns <= by[name].t1_ns
            assert by[name].t1_ns <= by["planner.finish"].t1_ns
        for name in DISPATCH:
            assert by[name].parent == "planner.dispatch"
        # plan, then dispatch, then the wait in flight, then _finish
        assert by["planner.plan"].t1_ns <= by["planner.dispatch"].t0_ns
        assert by["planner.dispatch"].t1_ns <= by["planner.wait"].t0_ns
        assert by["planner.wait"].t1_ns <= by["planner.finish"].t0_ns
    # depth 2: the second batch is dispatched before the first one waits
    first, second = (sorted(spans)[i] for i in (0, 1))
    disp2 = next(s for s in spans[second] if s.name == "planner.dispatch")
    wait1 = next(s for s in spans[first] if s.name == "planner.wait")
    assert disp2.t1_ns <= wait1.t0_ns
    assert set(_by_batch(rec.counts())) == set(spans)
    assert rec.dropped == 0


def _watch_finish(monkeypatch):
    """Every `_finish` call's arguments, the merged arrays copied."""
    calls, real = [], S._finish

    def watched(d, code, slot_seg_ids, snap, pk, opts, batch=None):
        calls.append((d.copy(), code.copy(), list(slot_seg_ids), snap, pk, batch))
        return real(d, code, slot_seg_ids, snap, pk, opts, batch=batch)

    monkeypatch.setattr(S, "_finish", watched)
    return calls


def _counter(rec, name, batch):
    got = [c.n for c in rec.counts(name) if c.batch == batch]
    assert len(got) == 1, (name, batch, got)
    return got[0]


def test_merge_width_is_what_dispatch_computed(corpus, monkeypatch):
    db, batches = corpus
    calls = _watch_finish(monkeypatch)
    with tracing.recording() as rec:
        _stream(db, batches)
    assert len(calls) == 3
    for d, code, _, _, pk, batch in calls:
        w = d.shape[1]
        assert _counter(rec, "merge.width", batch.id) == w
        # 60 deletes and 40 updates pass the margin cap: the merge keeps all
        assert len(pk.dirty_sorted()) > S._VIS_MARGIN_CAP
        assert w == 2 * (K + S._VIS_MARGIN_CAP)
    # Only counters with a reader are kept (device times are the card's).
    assert {c.name for c in rec.counts()} == {"merge.width", "finish.flagged"}


def _brute(d, code, slot_seg_ids, snap, pk):
    """(flagged, invisible, duplicates) of merged arrays, candidate by
    candidate: the dirty candidates, those of them the PK chain hides, and
    the repeats left in their rows."""
    dirty = set(int(i) for i in pk.dirty_sorted())
    segs = {h.seg_id: h.segment for h in snap.segments}
    flagged = invisible = duplicates = 0
    for bi in range(d.shape[0]):
        keep, row_flagged = [], False
        for j in range(d.shape[1]):
            c = int(code[bi, j])
            if not np.isfinite(d[bi, j]) or c < 0:
                continue
            seg_id, row = slot_seg_ids[c >> 32], c & 0xFFFFFFFF
            src = snap.memtable if seg_id == -1 else segs[seg_id]
            i, lsn = int(src.ids[row]), int(src.lsns[row])
            if i not in dirty:
                keep.append(i)
                continue
            flagged += 1
            row_flagged = True
            ent = pk.get_entry(i, snap.lsn)
            if ent is None or ent[1] == DELETED or ent[0] != lsn:
                invisible += 1
            else:
                keep.append(i)
        if row_flagged:
            duplicates += len(keep) - len(set(keep))
    return flagged, invisible, duplicates


def test_finish_counters_match_a_brute_count(corpus, monkeypatch):
    db, batches = corpus
    calls = _watch_finish(monkeypatch)
    with tracing.recording() as rec:
        _stream(db, batches)
    total = 0
    for d, code, slots, snap, pk, batch in calls:
        flagged, _, _ = _brute(d, code, slots, snap, pk)
        assert _counter(rec, "finish.flagged", batch.id) == flagged
        total += flagged
    assert total > 0  # updated ids reach the merge


def test_finish_counters_on_stale_and_repeated_rows(corpus):
    """Merged arrays as a stale plan would leave them: each updated id's old
    (tombstoned) segment row beside its memtable row, and a memtable row
    twice. `_finish` flags every dirty candidate as the brute count does,
    and drops the old rows as invisible and the repeat as a duplicate."""
    db, _ = corpus
    eng = db.engine
    snap = eng.snapshot()
    try:
        seg_id = snap.segments[0].seg_id
        mem_ids = np.asarray(snap.memtable.ids[: snap.mem_rows])
        mem_rows = np.array([int(np.flatnonzero(mem_ids == i)[-1]) for i in UPDATED[:4]])
        slots = [seg_id, -1]
        code = np.array([[int(u), (1 << 32) + int(m), (1 << 32) + int(m), -1]
                         for u, m in zip(UPDATED[:4], mem_rows)], np.int64)
        d = np.tile(np.array([0.1, 0.2, 0.3, np.inf], np.float32), (4, 1))
        opts = vg.SearchOptions(k=3)
        batch = tracing.Batch()
        with tracing.recording() as rec:
            ids, dist, _ = S._finish(d, code, slots, snap, eng.pk, opts, batch=batch)
        want = _brute(d, code, slots, snap, eng.pk)
        assert want == (12, 4, 4)
        assert _counter(rec, "finish.flagged", batch.id) == want[0]
        np.testing.assert_array_equal(ids, np.stack([UPDATED[:4], [-1] * 4, [-1] * 4], 1))
        np.testing.assert_array_equal(dist[:, 0], np.full(4, 0.2, np.float32))
    finally:
        snap.release()


def test_recording_leaves_answers_bitwise_equal(corpus):
    db, batches = corpus
    off = _stream(db, batches)
    with tracing.recording() as rec:
        on = _stream(db, batches)
    assert rec.records
    for (ids0, d0), (ids1, d1) in zip(off, on):
        np.testing.assert_array_equal(ids0, ids1)
        assert d0.tobytes() == d1.tobytes()


def _raises(*a, **kw):
    raise AssertionError("called while tracing is off")


def test_tracing_off_builds_no_span_and_no_counter_pass(corpus, monkeypatch):
    db, batches = corpus
    want = _stream(db, batches)
    monkeypatch.setattr(tracing, "_Span", _raises)
    monkeypatch.setattr(tracing.Recorder, "add", _raises)
    monkeypatch.setattr(torch.profiler, "record_function", _raises)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raises)
    monkeypatch.setattr(torch.cuda, "Event", _raises)
    monkeypatch.setattr(np, "count_nonzero", _raises)
    monkeypatch.setattr(S, "_query_stats", _raises)
    got = _stream(db, batches)
    # The array entry points build no QueryStats even when asked for them.
    got_stats = list(db.search_arrays_stream(iter(batches), k=K, depth=2, with_stats=True))
    db.search_arrays(batches[0], k=K, with_stats=True)
    for (ids0, d0), (ids1, d1), (ids2, _) in zip(want, got, got_stats):
        np.testing.assert_array_equal(ids0, ids1)
        np.testing.assert_array_equal(ids0, ids2)
        assert d0.tobytes() == d1.tobytes()
    # Off, a device timer is the shared no-op, whatever the device.
    assert tracing.device_timer("t", tracing.Batch(), torch.device("cuda")) is tracing._OFF
    tracing.count("c", _raises, tracing.Batch())  # a costly value is not computed


def test_profiler_trace_holds_the_spans(corpus):
    db, batches = corpus
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _stream(db, batches)
    names = {e.name for e in prof.events()}
    for name in ("planner.plan", "planner.dispatch", "planner.wait", "planner.finish",
                 *DISPATCH, *STEPS):
        assert "vecgo." + name in names, name


def test_with_stats_reads_the_spans(corpus):
    db, batches = corpus
    res = db.search_batch(batches[0], k=K, with_stats=True)
    st = res[0].stats
    assert st is res[-1].stats
    assert st.planning_time_s > 0 and st.scoring_time_s > 0
    assert st.rerank_time_s >= 0 and st.materialize_time_s > 0
    parts = st.planning_time_s + st.scoring_time_s + st.materialize_time_s
    assert st.total_time_s >= parts
    assert st.strategy.startswith("brute=")
    assert "materialize=" in st.explain()


def test_recorder_drops_past_its_bound_and_counts_the_drops(corpus, monkeypatch):
    db, batches = corpus
    with tracing.recording() as full:
        _stream(db, batches[:1])
    n = len(full.records)
    assert n > 10 and full.dropped == 0
    monkeypatch.setattr(tracing, "DEFAULT_LIMIT", 10)
    with tracing.recording() as small:
        _stream(db, batches[:1])
    assert len(small.records) == 10 and small.dropped == n - 10
    assert [r.name for r in small.records] == [r.name for r in full.records[:10]]
    assert tracing._recorder is None  # uninstalled on the way out


def test_recorder_counts_every_record_across_threads(monkeypatch):
    """Threads record at once, past the bound: none is lost, and each
    thread's spans nest on its own parent stack."""
    import sys
    import threading

    n_threads, per = 16, 500
    start = threading.Barrier(n_threads)

    def work(i):
        start.wait(timeout=30)
        b = tracing.Batch()
        for _ in range(per // 2):
            with tracing.span(f"outer{i}", b), tracing.span(f"inner{i}", b):
                pass

    monkeypatch.setattr(tracing, "DEFAULT_LIMIT", n_threads * per // 3)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording() as rec:
            threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(rec.records) == rec.limit
    assert len(rec.records) + rec.dropped == n_threads * per
    for r in rec.records:
        i = r.name[5:] if r.name.startswith("inner") else None
        assert r.parent == (None if i is None else f"outer{i}")

# ---- the filtered path: filter masks, the compact gather, the masked memtable ----

FN, FTAIL = 3000, 400  # u = id % 100: u < 10 admits 300 committed rows, 40 in the memtable


@pytest.fixture
def filtered():
    """A fresh deployment (its plan cache empty) of committed rows and a
    memtable tail, each row with metadata u = id % 100, and three batches."""
    r = np.random.default_rng(11)
    db = vg.Open(vg.Memory(), vg.Create(dim=D, device="cpu"))
    db.insert_batch(r.standard_normal((FN, D)).astype(np.float32),
                    [{"u": i % 100} for i in range(FN)], ids=np.arange(FN))
    db.commit()
    db.insert_batch(r.standard_normal((FTAIL, D)).astype(np.float32),
                    [{"u": i % 100} for i in range(FN, FN + FTAIL)],
                    ids=np.arange(FN, FN + FTAIL))
    yield db, [r.standard_normal((16, D)).astype(np.float32) for _ in range(3)]
    db.close()


def _filtered_stream(db, batches, value=10):
    return list(db.search_arrays_stream(iter(batches), k=K, depth=2,
                                        filter=vmeta.lt("u", value)))


def test_filter_spans_and_counters(filtered):
    """The plan's filter masks (one `planner.filter` a source, under
    `planner.plan`) and the compact gather (`planner.gather` under
    `source.flat_compact`) belong to the first batch, which plans and
    gathers; the plan cache serves the others. Every batch counts its masked
    memtable scan."""
    db, batches = filtered
    with tracing.recording() as rec:
        _filtered_stream(db, batches)
    spans = _by_batch(rec.spans())
    assert None not in spans and len(spans) == 3
    first, *rest = sorted(spans)
    by = {}
    for s in spans[first]:
        by.setdefault(s.name, []).append(s)
    assert [s.parent for s in by["planner.filter"]] == ["planner.plan"] * 2
    assert [s.parent for s in by["planner.gather"]] == ["source.flat_compact"]
    plan, gather = by["planner.plan"][0], by["planner.gather"][0]
    src = by["source.flat_compact"][0]
    for s in by["planner.filter"]:
        assert plan.t0_ns <= s.t0_ns <= s.t1_ns <= plan.t1_ns
    assert src.t0_ns <= gather.t0_ns <= gather.t1_ns <= src.t1_ns
    for b in rest:
        names = {s.name for s in spans[b]}
        assert "planner.filter" not in names and "planner.gather" not in names
        assert {"planner.plan", "source.flat_compact", "source.memtable"} <= names

    assert _counter(rec, "filter.rows_admitted", first) == 340
    assert _counter(rec, "filter.rows_total", first) == FN + FTAIL
    assert _counter(rec, "gather.rows", first) == 300
    seg = db.engine._segments[0].segment
    assert _counter(rec, "gather.bytes", first) == seg.gathered_bytes(300, "bf16")
    for b in (first, *rest):
        assert _counter(rec, "memtable.rows_scanned", b) == FTAIL
        assert _counter(rec, "memtable.rows_admitted", b) == 40
    for name in ("filter.rows_admitted", "filter.rows_total", "gather.rows", "gather.bytes"):
        assert [c.batch for c in rec.counts(name)] == [first]


def test_gather_bytes_are_what_the_gather_holds(filtered, monkeypatch):
    """`gather.bytes` counts the device bytes of the sub-corpus the plan
    keeps: its row ids, bf16 rows and norms."""
    db, batches = filtered
    plans = []
    real = FlatSegment.gather

    def watched(seg, rows_elig, scan_dtype):
        plans.append(real(seg, rows_elig, scan_dtype))
        return plans[-1]

    monkeypatch.setattr(FlatSegment, "gather", watched)
    with tracing.recording() as rec:
        _filtered_stream(db, batches)
    assert len(plans) == 1
    held = sum(int(v.nbytes) for v in plans[0].values())
    assert [c.n for c in rec.counts("gather.bytes")] == [held]


def test_filter_above_the_cutoff_rides_the_scan_as_a_mask(filtered):
    """u < 60 admits 60% of the segment, past `compact_gather_cutoff`: the
    segment scans with a mask and nothing is gathered."""
    db, batches = filtered
    with tracing.recording() as rec:
        _filtered_stream(db, batches, value=60)
    names = {s.name for s in rec.spans()}
    assert "source.flat" in names and "planner.gather" not in names
    assert not rec.counts("gather.rows")
    assert [c.n for c in rec.counts("filter.rows_admitted")] == [0.6 * (FN + FTAIL)]


def test_filtered_tracing_off_records_nothing(filtered, monkeypatch):
    """Off, the filtered path builds no span, makes no counting pass (the
    admitted rows are counted by `np.count_nonzero` only where the counter
    goes), and answers as it does with recording on."""
    db, batches = filtered
    with tracing.recording():
        want = _filtered_stream(db, batches)
    db.engine._plan_cache.clear()
    monkeypatch.setattr(tracing, "_Span", _raises)
    monkeypatch.setattr(tracing.Recorder, "add", _raises)
    monkeypatch.setattr(torch.profiler, "record_function", _raises)
    monkeypatch.setattr(np, "count_nonzero", _raises)
    got = _filtered_stream(db, batches)
    for (ids0, d0), (ids1, d1) in zip(want, got):
        np.testing.assert_array_equal(ids0, ids1)
        assert d0.tobytes() == d1.tobytes()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (device timers are CUDA events)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_timers_on_the_card(cuda, monkeypatch):
    """On the card each source gets a device time, read after the batch's
    own done event; a `with_stats` batch's scoring time is its sources'
    device time; off, the stream records no CUDA event."""
    r = np.random.default_rng(3)
    db = vg.Open(vg.Memory(), vg.Create(dim=D, device="cuda"))
    db.insert_batch(r.standard_normal((20_000, D)).astype(np.float32), ids=np.arange(20_000))
    db.commit()
    db.insert_batch(r.standard_normal((1000, D)).astype(np.float32),
                    ids=np.arange(20_000, 21_000))
    for i in range(10):
        db.delete(i)
    batches = [r.standard_normal((64, D)).astype(np.float32) for _ in range(3)]
    with tracing.recording() as rec:
        want = _stream(db, batches)
    batch_ids = set(_by_batch(rec.spans()))
    assert len(batch_ids) == 3
    w = K + 10  # ten dirty ids: margin 10 over k
    for b in batch_ids:
        for name in ("device_ms.source.flat", "device_ms.source.memtable"):
            assert _counter(rec, name, b) > 0
        assert _counter(rec, "merge.width", b) == w

    calls = _watch_finish(monkeypatch)
    res = db.search_batch(batches[0], k=K, with_stats=True)
    ct = calls[-1][-1].counts
    scans = ct["device_ms.source.flat"] + ct["device_ms.source.memtable"]
    assert res[0].stats.scoring_time_s == pytest.approx(scans / 1e3)

    real_event = torch.cuda.Event

    def done_only(*a, **kw):
        assert not kw.get("enable_timing"), "a timing event while tracing is off"
        return real_event(*a, **kw)

    monkeypatch.setattr(torch.cuda, "Event", done_only)
    for (ids0, d0), (ids1, d1) in zip(want, _stream(db, batches)):
        np.testing.assert_array_equal(ids0, ids1)
        assert d0.tobytes() == d1.tobytes()
