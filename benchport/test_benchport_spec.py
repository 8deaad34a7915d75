"""BENCHMARK.json and the files it names: every cell finds its
configuration, traffic mix, limits and readers by name (CPU)."""

import importlib.util
import json
import re
from pathlib import Path

from benchport import judge

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_finds_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        cfg = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        assert cfg["name"] == w["config"]
        assert (ROOT / "benchport" / "traffic" / f"{w['traffic']}.json").exists()
        limits = json.loads((ROOT / "benchport" / "limits" / f"{w['name']}.json").read_text())
        assert set(limits) == set(judge.NUMBERS)
        assert w["chips"] == 1


def test_every_per_layer_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        path = ROOT / "benchport" / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location("reader", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_names_and_bounds_keep_to_the_contract():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert 1 <= BENCH["run_seconds"] <= 51
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
