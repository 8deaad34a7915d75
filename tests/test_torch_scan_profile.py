"""`scripts/torch_scan_profile.py`'s variant builds against this tree's
kernel sources, on the CPU: each variant's source replacements, and its
counters', must match their source exactly once (`make_tree` raises
otherwise), so a kernel edit that moves one fails here and not in a call to
the card."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("torch_scan_profile",
                                               ROOT / "scripts" / "torch_scan_profile.py")
prof = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(prof)

CASES = [(mode, name) for mode, (_, variants, _) in prof.MODES.items() for name in variants]


@pytest.mark.parametrize("mode,name", CASES, ids=[f"{m}-{n}" for m, n in CASES])
def test_profile_variant_applies_to_the_kernel_sources(tmp_path, monkeypatch, mode, name):
    (tmp_path / "vecgo_tpu_torch").symlink_to(ROOT / "vecgo_tpu_torch")
    monkeypatch.setattr(prof, "HERE", str(tmp_path))
    source = prof.MODES[mode][0]
    built = Path(prof.make_tree(name, mode)) / "vecgo_tpu_torch" / "csrc" / source
    text = built.read_text()
    assert "vecgo_profile_count" in text
    assert text != (ROOT / "vecgo_tpu_torch" / "csrc" / source).read_text()
