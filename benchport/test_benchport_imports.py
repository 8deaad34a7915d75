"""What the benchmark imports (static, by whole top-level module name): no
JAX and no JAX package anywhere; the program only in `drive.py` (and the
tests that drive a run); the reference, the judge and the readers nothing
of it (CPU)."""

import ast
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "vecgo_tpu"}
PROGRAM = "vecgo_tpu_torch"


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources():
    return sorted(HERE.rglob("*.py"))


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        found = _top_level_imports(path) & FORBIDDEN
        assert not found, f"{path.name} imports {found}"


def test_only_drive_imports_the_program():
    allowed = {"drive.py", "test_benchport_faults.py"}
    for path in _sources():
        if PROGRAM in _top_level_imports(path):
            assert path.name in allowed, f"{path.name} imports {PROGRAM}"
    assert PROGRAM in _top_level_imports(HERE / "drive.py")


def test_the_name_check_compares_whole_names():
    assert "vecgo_tpu_torch".split(".")[0] not in FORBIDDEN
    from benchport import run

    assert set(run.FORBIDDEN) == FORBIDDEN
