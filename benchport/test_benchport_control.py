"""The control (the reference in TF32 in the program's place) fails each
cell's limits, here at a small size on the CPU with TF32 rounding
emulated; `control.py` reads it on the card at the cells' own sizes."""

import json
from pathlib import Path

import pytest

from benchport import control, judge, run

CELLS = [w["name"] for w in json.loads(
    (Path(__file__).resolve().parent.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    spec = run.load_spec(cell)
    spec["config"] = dict(spec["config"], rows=30000, memtable_rows=3000,
                          deletes=min(spec["config"]["deletes"], 300),
                          dim=min(spec["config"]["dim"], 256))
    spec["traffic"] = dict(spec["traffic"], batch=256, pool_batches=2)
    nums = control.control_numbers(spec, 2**34 + 5, "cpu")
    assert not judge.passed(judge.checks(nums, spec["limits"])), nums
