"""Every example of the port runs end to end on the CPU (the JAX package's
tests/test_examples.py for vecgo_tpu_torch/examples), with the JAX
examples' own asserts, and the port has one example for each of
examples/*.py, name for name."""

import importlib
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).parent.parent
JAX_EXAMPLES = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
PORT_EXAMPLES = sorted(p.stem for p in (ROOT / "vecgo_tpu_torch" / "examples").glob("*.py")
                       if p.stem != "__init__")

torch.set_num_threads(1)


def test_every_jax_example_has_its_port():
    assert PORT_EXAMPLES == JAX_EXAMPLES


@pytest.mark.parametrize("name", PORT_EXAMPLES)
def test_port_example_runs(name, capsys):
    importlib.import_module(f"vecgo_tpu_torch.examples.{name}").main(device="cpu")
    assert len(capsys.readouterr().out) > 0
