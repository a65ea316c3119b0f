"""What the benchmark's modules may import: none imports JAX or the JAX
package (top-level names compared whole, so ``auvtpu_torch`` is not taken
for ``auvtpu``), and neither the references nor the yardstick import the
program."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "auvtpu"}
MODULES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_check_compares_whole_names():
    assert "auvtpu_torch" not in FORBIDDEN and "auvtpu" in FORBIDDEN


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in MODULES if p.parent.name in ("reference", "yardstick")],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_references_and_yardstick_import_nothing_of_the_program(path):
    assert "auvtpu_torch" not in top_level_imports(path)
    assert "auvtpu_torch" not in path.read_text()


def test_harness_names_its_forbidden_modules():
    from benchmark import harness

    assert set(harness.FORBIDDEN) == FORBIDDEN
