"""Filtered k-NN through the port's normal path against the plain reference
(CPU).

The deployment of `benchport`'s filtered cell (`dbpedia-openai-1536-1M-append`
under `knn100-filter10-stream`) at a small size: seeded clustered rows from
`benchport.gen`, every row committed once into one flat segment, a memtable
tail, metadata `u` uniform in 0..99, built by `benchport.drive.open_db` as the
benchmark builds it. Each filtered `search_arrays_stream` answer is held to
`benchport/reference.py`'s exact filtered top-k (plain torch, float32, TF32
off) by the judge's own numbers (`benchport.judge.judge_batch`), on clean and
dirty snapshots, under the bf16 and f32 scan profiles, at k 10 and 100. The
plan's source kinds follow the filter's selectivity. Then whole runs of the
cell (`benchport.run.run_cell`) read correct, and not correct with the filter
broken underneath in each way a filtered scan can break.
"""

import numpy as np
import pytest
import torch

from benchport import drive, gen, judge, run
from benchport import reference as R
from vecgo_tpu_torch import metadata as vmeta
from vecgo_tpu_torch.engine import memtable as vmemtable
from vecgo_tpu_torch.engine import search as S
from vecgo_tpu_torch.index.flat import FlatSegment
from vecgo_tpu_torch.model import SearchOptions

torch.set_num_threads(1)

CELL = "dbpedia1536append-filter10-knn100"
SEED = 2**34 + 2027
ROWS, TAIL, DIM, DELETES = 12000, 2500, 64, 300
BATCH = 64

# dist_err: a returned distance is the exact f32 rerank (or f32 scan) of its
# row; against float64 at d 64 that is rounding, ~1e-7 (read: at most 3.7e-7).
# rank_gap: 0 where the top-k is exact; f32 rounding can swap near-ties by
# about the same. A true neighbour missed by the bf16 pool lies ~1e-3 to 1e-2
# beyond (a bf16 product's error at d 64), far above.
DIST_TOL = 2e-6
RANK_TOL = 2e-6


def _cfg(dirty=False, profile="bf16"):
    spec = run.load_spec(CELL)
    cfg = dict(spec["config"], rows=ROWS, memtable_rows=TAIL, dim=DIM,
               deletes=DELETES if dirty else 0)
    if profile == "f32":
        cfg["options"] = {"flat_scan_dtype": "f32"}
    traffic = dict(spec["traffic"], batch=BATCH, pool_batches=2, warm_batches=2)
    return cfg, traffic


class _Deployment:
    def __init__(self, dirty, profile):
        self.cfg, self.traffic = _cfg(dirty, profile)
        self.inp = gen.make(self.cfg, self.traffic, SEED, "cpu")
        self.db, _ = drive.open_db(self.cfg, self.inp.to_host(), "cpu")
        self.blocks = [(0, self.inp.base), (ROWS, self.inp.tail)]
        self.deleted = torch.from_numpy(self.inp.deleted)

    def visible(self, value):
        flt = {"field": "u", "op": "lt", "value": value}
        return R.visible_mask(ROWS + TAIL, self.deleted, self.inp.meta, flt, "cpu")

    def kinds(self, value, k):
        """(kind, masked) of each planned source for the filter u < value."""
        e = self.db.engine
        snap = e.snapshot()
        try:
            plan = S._plan_snapshot(snap, SearchOptions(k=k, filter=vmeta.lt("u", value)),
                                    e.options, e._device_budget)
        finally:
            snap.release()
        return [(s.kind, s.mask is not None) for s in plan.sources]


@pytest.fixture(scope="module")
def deployments():
    made = {}

    def get(dirty, profile):
        if (dirty, profile) not in made:
            made[dirty, profile] = _Deployment(dirty, profile)
        return made[dirty, profile]

    yield get
    for dep in made.values():
        dep.db.close()


@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("profile", ["bf16", "f32"])
@pytest.mark.parametrize("dirty", [False, True], ids=["clean", "dirty"])
@pytest.mark.parametrize("value", [10, 1, 60])
def test_filtered_stream_matches_the_reference(deployments, value, dirty, profile, k):
    dep = deployments(dirty, profile)
    cutoff = dep.db.engine.options.compact_gather_cutoff
    # u < 10 and u < 1 gather a sub-corpus; u < 60 rides the full scan as a mask.
    segment = ("flat_compact", True) if value / 100 <= cutoff else ("flat", True)
    assert dep.kinds(value, k) == [("mem", True), segment]

    visible = dep.visible(value)
    qs = dep.inp.queries
    answers = list(dep.db.search_arrays_stream(iter([q.numpy() for q in qs]), k=k, depth=2,
                                               filter=vmeta.lt("u", value)))
    assert len(answers) == len(qs)
    parts = []
    for q, (ids, dists) in zip(qs, answers):
        t = judge.truth(q, dep.blocks, visible, k, dep.cfg["metric"])
        parts.append((judge.judge_batch(q, ids, dists, t, dep.blocks, visible, dep.deleted,
                                        dep.cfg["metric"]), 1))
    nums = judge.combine(parts)
    assert nums["deleted_returned"] == 0 and nums["missing_answers"] == 0, nums
    assert nums["dist_err"] <= DIST_TOL, nums
    assert nums["rank_gap"] <= RANK_TOL, nums
    assert nums["recall_at_k"] > 0.999, nums


# ---- whole runs of the cell (benchport.run.run_cell) at a small size ----


def _cell_spec():
    spec = run.load_spec(CELL)
    spec["config"], spec["traffic"] = _cfg()
    return spec


def _run(spec):
    out = run.run_cell(spec, SEED, 1.0, trace=False, device="cpu")
    assert out["attempted"] >= 2 * BATCH, "a fault needs two batches to show"
    return out


def test_the_cells_small_run_is_correct():
    out = _run(_cell_spec())
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    assert out["metrics"]["recall_at_k"]["value"] > 0.999


def _gather_every_row(monkeypatch):
    real = FlatSegment.gather

    def every_row(seg, rows_elig, scan_dtype):
        return real(seg, torch.arange(seg.n, device=rows_elig.device), scan_dtype)

    monkeypatch.setattr(FlatSegment, "gather", every_row)


def _memtable_mask_dropped(monkeypatch):
    monkeypatch.setattr(vmemtable.MemTable, "filter_mask",
                        lambda self, f, n=None: np.ones(self._n if n is None else n, bool))


@pytest.mark.parametrize("fault", [_gather_every_row, _memtable_mask_dropped],
                         ids=["gather_takes_every_row", "memtable_mask_dropped"])
def test_broken_filter_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = _run(_cell_spec())
    assert not out["correct"], out["checks"]
    assert out["checks"]["missing_answers"]["value"] > 0


def test_probe_labels_the_compact_scans_plain_scan_topk():
    """The compact scans run outside every `.search` span, so the probe
    labels them `scan_topk`, which `scan_topk.compact_roofline` reads; the
    memtable's are masked, which `scan_topk.memtable_masked_ms` reads."""
    spec = _cell_spec()
    cfg, traffic = spec["config"], spec["traffic"]
    inputs = gen.make(cfg, traffic, SEED, "cpu").to_host()
    db, _ = drive.open_db(cfg, inputs, "cpu")
    try:
        drive.warm(db, traffic, inputs.queries, "cpu")
        with drive.Probe() as probe:
            win = drive.serve(db, traffic, inputs.queries, 0.3)
    finally:
        db.close()
    batches = len(win.done)
    assert batches >= 1
    by = {}
    for c in probe.scans:
        by.setdefault(c["span"], []).append(c)
    assert set(by) == {"scan_topk", "scan_topk@memtable.search"}
    admitted = int((inputs.meta["u"][:ROWS] < 10).sum())
    assert len(by["scan_topk"]) == batches
    for c in by["scan_topk"]:
        assert (c["n"], c["d"], c["table"], c["masked"]) == (admitted, DIM, "bf16", False)
        assert c["k"] == traffic["k"] + 24  # the bf16 pool, reranked in f32
    assert all(c["masked"] and c["table"] == "f32" for c in by["scan_topk@memtable.search"])
    assert "planner.dispatch" in probe.host and "segment.search" not in probe.host
