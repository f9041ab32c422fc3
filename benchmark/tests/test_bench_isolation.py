"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the port: top-level module names compared as
whole words (``sdvar_tpu_torch`` begins with ``sdvar_tpu``)."""

import ast
import sys
from pathlib import Path

import pytest

from benchmark.harness import runner

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))
REFERENCE = sorted((BENCH / "reference").rglob("*.py"))
JAX = {"jax", "jaxlib", "flax", "sdvar_tpu"}


def top_level_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & JAX


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_port(path):
    mods = set(top_level_imports(path))
    assert "sdvar_tpu_torch" not in mods
    assert mods <= {"__future__", "contextlib", "dataclasses", "math", "typing",
                    "numpy", "torch", "benchmark"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.startswith("benchmark."):
            assert node.module.startswith("benchmark.reference"), node.module


def test_whole_name_comparison(monkeypatch):
    monkeypatch.setitem(sys.modules, "sdvar_tpu_torch_fake", object())
    assert runner.loaded_forbidden() == sorted(
        {m.split(".")[0] for m in sys.modules} & JAX)
    monkeypatch.setitem(sys.modules, "sdvar_tpu.config", object())
    assert "sdvar_tpu" in runner.loaded_forbidden()
