"""What ``gbench/`` may import: nothing whose top-level module, compared
whole, is JAX's or the JAX package's, nor the JAX package's harness and
scripts; and the references nothing of the program."""
from __future__ import annotations

import ast

import pytest

from gbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks", "scripts", "chip_smoke"}
FILES = sorted(spec.GBENCH.rglob("*.py"))


def top_level_imports(source: str) -> set[str]:
    tree = ast.parse(source)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
    return names


def test_walk_finds_the_files():
    assert spec.GBENCH / "run.py" in FILES and len(FILES) > 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(spec.GBENCH)))
def test_no_jax_or_jax_package(path):
    found = top_level_imports(path.read_text()) & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((spec.GBENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    names = top_level_imports(path.read_text())
    assert "repro_torch" not in names
    assert names <= {"__future__", "torch", "numpy", "math"}, names


def test_whole_name_comparison():
    """``repro_torch`` begins with ``repro`` but is not it."""
    names = top_level_imports("import repro_torch.apps\nfrom repro_torch import apps\n")
    assert names == {"repro_torch"} and not names & FORBIDDEN
    assert top_level_imports("from repro.apps import sssp\n") & FORBIDDEN
