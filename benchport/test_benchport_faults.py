"""A whole run of a cell on the CPU at a small size, past the look for a
card: sound, it reads correct; with the timed path broken underneath in
each way the cells can break, it reads not correct. Also a filtered mix:
a new cell is a traffic file and an entry (CPU)."""

import numpy as np
import pytest

from benchport import run
from vecgo_tpu_torch.engine import memtable as vmemtable
from vecgo_tpu_torch.engine import pk as vpk
from vecgo_tpu_torch.engine import search as vsearch

SEED = 2**35 + 17


def _spec(cell="deep96-knn10-stream", **traffic):
    spec = run.load_spec(cell)
    spec["config"] = dict(spec["config"], rows=12000, memtable_rows=2500,
                          deletes=min(spec["config"]["deletes"], 300))
    spec["traffic"] = dict(spec["traffic"], batch=128, pool_batches=2, warm_batches=2, **traffic)
    return spec


def _run(spec):
    out = run.run_cell(spec, SEED, 1.0, trace=False, device="cpu")
    assert out["attempted"] >= 2 * spec["traffic"]["batch"], "a fault needs two batches to show"
    return out


@pytest.fixture(scope="module")
def sound():
    return _run(_spec())


def test_sound_run_is_correct(sound):
    assert sound["correct"], sound["checks"]
    assert sound["failed"] == 0 and sound["attempted"] > 0
    assert sound["metrics"]["recall_at_k"]["value"] > 0.999
    assert list(sound)[-1] == "checks"


def _finish_with(alter):
    real = vsearch._finish

    def broken(*args, **kwargs):
        ids, d, loc = real(*args, **kwargs)
        return (*alter(ids.copy(), d.copy()), loc)

    return broken


def _half_left_out(ids, d):
    ids[ids.shape[0] // 2 :] = -1
    d[d.shape[0] // 2 :] = np.inf
    return ids, d


def _answer_altered(ids, d):
    ids[0, 0] = (ids[0, 0] + 1) % 12000
    return ids, d


@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered", "deletes_visible",
                                   "memtable_left_out", "stale_answer"])
def test_broken_path_is_not_correct(monkeypatch, fault):
    if fault == "half_left_out":
        monkeypatch.setattr(vsearch, "_finish", _finish_with(_half_left_out))
    elif fault == "answer_altered":
        monkeypatch.setattr(vsearch, "_finish", _finish_with(_answer_altered))
    elif fault == "deletes_visible":  # MVCC: tombstones and the dirty-id check skipped
        monkeypatch.setattr(vsearch, "_source_mask", lambda src, device: None)
        monkeypatch.setattr(vpk.PKIndex, "dirty_sorted",
                            lambda self: np.zeros(0, np.int64))
    elif fault == "memtable_left_out":
        real = vmemtable.MemTable.search
        monkeypatch.setattr(vmemtable.MemTable, "search",
                            lambda self, q, k, n, mask=None: real(self, q, k, 0, mask))
    else:  # every batch answered with the first batch's answer
        first = {}
        real = vsearch._drain_batch

        def stale(*args, **kwargs):
            out = real(*args, **kwargs)
            return first.setdefault("out", out)

        monkeypatch.setattr(vsearch, "_drain_batch", stale)
    out = _run(_spec())
    assert not out["correct"], (fault, out["checks"])


def test_filtered_mix_needs_only_a_traffic_file():
    spec = _spec("dbpedia1536-knn100-stream",
                 filter={"field": "u", "op": "lt", "value": 10})
    spec["config"] = dict(spec["config"], dim=64)
    out = _run(spec)
    assert out["correct"], out["checks"]
    assert out["metrics"]["recall_at_k"]["value"] > 0.999
