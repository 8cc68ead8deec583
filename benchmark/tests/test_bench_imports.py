"""No module of the benchmark imports JAX or the JAX package, and the plain
references import nothing of the program; the run's own guard on
``sys.modules`` compares top-level names whole."""

import ast
import sys

import pytest

import run
from conftest import BENCH

PROGRAM = "portable_multigrid_tpu_torch"


def imported(path):
    """Top-level names of every module that ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not imported(path) & set(run.FORBIDDEN)


def test_references_import_nothing_of_the_program():
    refs = sorted((BENCH / "configs").glob("*.py"))
    assert refs
    for path in refs + [BENCH / "pmgbench" / "fe1d.py"]:
        assert PROGRAM not in imported(path), path


def test_guard_compares_whole_names(monkeypatch):
    for name in ("portable_multigrid_tpu_torch", "portable_multigrid_tpu_torchx",
                 "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "portable_multigrid_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax.numpy",
                                       "portable_multigrid_tpu.ops"]
