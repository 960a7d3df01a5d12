"""The port stands alone: no file of it, nor chip_smoke.py, imports JAX or
the JAX package; importing every module of it loads no JAX; and
chip_smoke.py fails, printing no result, where there is no card. The work
counts and the card's peaks live in gsbench/counts.py alone: neither the
port nor chip_smoke.py keeps a copy."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

from tests.procs import communicate_all

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "intro_to_gaussian_splatting_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "intro_to_gaussian_splatting_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_no_file_of_the_port_imports_jax():
    files = _port_files()
    assert len(files) > 15
    bad = [(str(p.relative_to(REPO)), m) for p in files
           for m in _imported_modules(p) if _forbidden(m)]
    assert bad == []
    assert _forbidden("intro_to_gaussian_splatting_tpu.ops")
    assert not _forbidden("intro_to_gaussian_splatting_tpu_torch.ops")


def _assigned_names(path: Path):
    """Every name the file binds by assignment, and ``name()`` for each
    function it defines."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name + "()"
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(
                       node, (ast.AnnAssign, ast.AugAssign)) else [])
        for target in targets:
            for leaf in ast.walk(target):
                if isinstance(leaf, ast.Name):
                    yield leaf.id


PEAKS = {"HBM_BYTES_PER_S", "FP32_FLOP_PER_S"}


def _copies(names, counts: str):
    """The peaks, a ``bound()`` and the work counts named like ``counts``
    among ``names``."""
    return sorted(n for n in names if n in PEAKS or n == "bound()"
                  or re.fullmatch(counts, n))


def test_no_copy_of_the_work_counts_or_peaks():
    port = {str(p.relative_to(REPO)): set(_assigned_names(p))
            for p in sorted(PORT.rglob("*.py"))}
    assert len(port) > 15
    bad = {f: _copies(names, r"\w+_OPS_PER_(EVALUATION|PIXEL)")
           for f, names in port.items()}
    assert {f: v for f, v in bad.items() if v} == {}
    smoke = set(_assigned_names(REPO / "chip_smoke.py"))
    assert _copies(smoke, r"B[123]_\w*(OPS|ROWS)\w*") == []
    # what is left there counts the kernels gsbench/counts.py does not
    assert "B4A_OPS_PER_PIXEL" in smoke


def _start(code_or_args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.Popen([sys.executable, *code_or_args], cwd=cwd,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


# about 10x the slowest wait seen: 9.0 s to import every module of the port
# in a tier-1 run (6 xdist workers on 8 cores, load averages up to 15)
WAIT_LIMIT_S = 100


def _wait(*procs):
    return [subprocess.CompletedProcess(p.args, p.returncode, out, err)
            for p, (out, err) in zip(procs,
                                     communicate_all(procs, WAIT_LIMIT_S))]


def _run(code_or_args, cwd):
    return _wait(_start(code_or_args, cwd))[0]


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__") for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"modules = {modules!r}\n"
            "for m in modules:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'intro_to_gaussian_splatting_tpu')]\n"
            "assert not bad, bad\n"
            "print('imported', len(modules))\n")
    r = _run(["-c", code], REPO)
    assert r.returncode == 0, r.stderr
    assert f"imported {len(modules)}" in r.stdout


def test_chip_smoke_fails_without_a_card(tmp_path):
    # in the checkout, and alone in a directory without the port beside it
    # (the two runs at once)
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    procs = [_start([str(REPO / "chip_smoke.py")], REPO),
             _start([str(alone)], tmp_path)]
    r, r_alone = _wait(*procs)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert r_alone.returncode != 0
    assert '"ok"' not in r_alone.stdout
