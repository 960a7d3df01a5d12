"""Nothing of the benchmark imports JAX or the JAX package, its reference
and its scene recipes import nothing of the program, and a run that finds
JAX or the JAX package loaded prints no result."""

from __future__ import annotations

import ast
import sys
import types

import pytest

from gsbench import harness as H

FORBIDDEN = {"jax", "jaxlib", "flax", "intro_to_gaussian_splatting_tpu"}
# what feeds or judges both sides imports nothing of the program either
BOTH_SIDES = ("reference", "scenes")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _broken(path, root=H.HERE) -> set:
    """The imports of ``path`` that the rule of its directory forbids."""
    tops = {name.split(".")[0] for name in _imports(path)}
    forbidden = set(FORBIDDEN)
    if path.relative_to(root).parts[0] in BOTH_SIDES:
        forbidden.add(H.PACKAGE)
    return tops & forbidden


SOURCES = sorted(p for p in H.HERE.rglob("*.py") if "_build" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(H.HERE)))
def test_no_jax_and_no_program_in_the_reference(path):
    assert not _broken(path), path
    # nothing reads the JAX package's benchmark or its records
    text = path.read_text()
    for name in ("BENCH_" + "r", "bench" + ".py"):
        assert name not in text, path


@pytest.mark.parametrize("sub, caught", [("scenes", True),
                                         ("reference", True),
                                         ("traffic", False)])
def test_the_program_is_caught_where_both_sides_are_fed(tmp_path, sub,
                                                        caught):
    path = tmp_path / sub / "planted.py"
    path.parent.mkdir()
    path.write_text(f"from {H.PACKAGE}.ops import render\n")
    assert _broken(path, tmp_path) == ({H.PACKAGE} if caught else set())


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, H.PACKAGE + ".fake",
                        types.ModuleType("fake"))
    assert H.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "intro_to_gaussian_splatting_tpu.ops",
                        types.ModuleType("ops"))
    assert H.forbidden_modules() == ["intro_to_gaussian_splatting_tpu.ops"]


def test_a_run_holding_jax_prints_no_result(monkeypatch, capsys):
    from gsbench import run
    from gsbench.tests.tiny import tiny_cell

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    cell = tiny_cell("treehill_3dgs.render")
    assert run.report(H.benchmark(), cell, 1) != 0
    out, err = capsys.readouterr()
    assert out == "" and "jax" in err


def test_no_card_exits_without_a_result(capsys):
    import torch

    from gsbench import run

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "treehill_3dgs.render", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
