"""No module of the benchmark imports JAX, the JAX package or its bench
script, and the plain reference imports nothing of the port: top-level
module names compared whole."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "slowflow_tpu", "bench"}


def imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_port(path):
    assert "slowflow_tpu_torch" not in imported(path)


def test_the_check_compares_whole_names():
    assert {"slowflow_tpu_torch", "benchmarks"}.isdisjoint(FORBIDDEN)
