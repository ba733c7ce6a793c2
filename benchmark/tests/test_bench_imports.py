"""Nothing of the benchmark imports JAX or the JAX package, compared by the
whole top-level name (the port's name begins with the JAX package's), and
the plain references import nothing of the program either."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from benchmark.run import FORBIDDEN, forbidden_modules

BENCH = Path(__file__).resolve().parents[1]


def _top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not _top_level_imports(path) & {"jax", "jaxlib", "flax", "tstar_tpu"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _top_level_imports(path) & {"tstar_tpu_torch", "jax", "tstar_tpu"}


def test_the_run_names_a_loaded_forbidden_module(monkeypatch):
    import sys
    import types

    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "tstar_tpu"}
    monkeypatch.setitem(sys.modules, "tstar_tpu_torch_lookalike", types.ModuleType("x"))
    for name in FORBIDDEN:
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tstar_tpu.search", types.ModuleType("tstar_tpu.search"))
    assert forbidden_modules() == ["tstar_tpu"]
