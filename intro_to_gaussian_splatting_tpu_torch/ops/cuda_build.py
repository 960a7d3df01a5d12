"""Build the port's CUDA kernels with nvcc, and its host C++ with the C++
compiler, and call them through ctypes.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface, built
at first use into a shared library for Hopper (``sm_90a``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v [per-kernel flags] -o lib<name>-<hash>.so

Each host library (``HostSource``: the CPU compositing oracle, the COLMAP
reader) is one ``csrc/<name>.cpp`` file with a plain C interface, built
with ``$CXX`` (``g++`` by default) and the JAX package's native flags:

    g++ -O3 -march=native -fPIC -shared -std=c++17 -Wall -o lib<name>-<hash>.so

No PyTorch header is compiled, so a build takes seconds. The library name
carries a hash of the source and the flags (for a host library also of
what ``-march=native`` means on this machine, so a checkout moved to
another CPU rebuilds), so an edited source is rebuilt; a build writes to a
temporary name and renames, so concurrent processes do not see
half-written files. The compiler's report (for nvcc, ``ptxas``'s
registers, shared memory and spills) is kept beside each library as
``<library>.log``; ``sass`` dumps a built kernel library's machine code.

The build directory is ``_build/`` inside the package, or
``$GSTPU_TORCH_BUILD_DIR``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the JAX package's native/Makefile flags
HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
              "-Wall")


def build_dir() -> Path:
    return Path(os.environ.get("GSTPU_TORCH_BUILD_DIR",
                               CSRC.parent / "_build"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ with the CUDA toolkit")


def cxx_path() -> Optional[str]:
    """The host C++ compiler, ``$CXX`` or ``g++`` on ``PATH``; None if
    there is none."""
    return shutil.which(os.environ.get("CXX", "g++"))


@dataclasses.dataclass(frozen=True)
class KernelSource:
    name: str                       # csrc/<name><suffix>
    extra_flags: Tuple[str, ...] = ()

    suffix = ".cu"

    @property
    def path(self) -> Path:
        return CSRC / f"{self.name}{self.suffix}"

    def compiler(self) -> str:
        return nvcc_path()

    def flags(self) -> Tuple[str, ...]:
        return NVCC_FLAGS + self.extra_flags

    def _digest(self):
        digest = hashlib.sha256(self.path.read_bytes())
        digest.update(" ".join(self.flags()).encode())
        return digest

    def library(self) -> Path:
        return (build_dir()
                / f"lib{self.name}-{self._digest().hexdigest()[:16]}.so")

    def command(self, out: Path) -> list:
        return [self.compiler(), *self.flags(), "-o", str(out),
                str(self.path)]


@dataclasses.dataclass(frozen=True)
class HostSource(KernelSource):
    """A host library, ``csrc/<name>.cpp``, built with the C++ compiler."""

    suffix = ".cpp"

    def compiler(self) -> str:
        found = cxx_path()
        if found is None:
            raise RuntimeError(
                f"no C++ compiler ({os.environ.get('CXX', 'g++')}) on PATH: "
                f"the port's host library {self.name} is built from csrc/")
        return found

    def flags(self) -> Tuple[str, ...]:
        return HOST_FLAGS + self.extra_flags

    def _digest(self):
        # -march=native differs from CPU to CPU: hash the target macros it
        # defines here
        digest = super()._digest()
        target = subprocess.run(
            [self.compiler(), "-march=native", "-dM", "-E", "-x", "c++",
             os.devnull], capture_output=True, text=True)
        digest.update(target.stdout.encode())
        return digest


def build(sources: Sequence[KernelSource]) -> Dict[str, Path]:
    """Build every source not built yet, one compiler process each, all at
    once. Returns {name: library path}; raises with the compiler's output
    on failure."""
    out = {src.name: src.library() for src in sources}
    todo = [src for src in sources if not out[src.name].exists()]
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        tmp = out[src.name].with_suffix(f".tmp{os.getpid()}.so")
        procs.append((src, tmp, subprocess.Popen(
            src.command(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} ({Path(proc.args[0]).name} exit "
                          f"{proc.returncode}):\n{log}")
            continue
        Path(str(out[src.name]) + ".log").write_text(log)
        os.replace(tmp, out[src.name])
    if failed:
        raise RuntimeError("build failed: " + "\n".join(failed))
    return out


def sass(source: KernelSource) -> str:
    """The SASS of ``source``'s built library (``cuobjdump -sass``, beside
    nvcc in the CUDA toolkit)."""
    cuobjdump = (shutil.which("cuobjdump")
                 or str(Path(nvcc_path()).parent / "cuobjdump"))
    return subprocess.run([cuobjdump, "-sass", str(source.library())],
                          capture_output=True, text=True, check=True).stdout


def ptxas_report(source: KernelSource) -> str:
    """ptxas's resource lines from the last build of ``source``."""
    log = Path(str(source.library()) + ".log").read_text()
    return "\n".join(line.strip() for line in log.splitlines()
                     if "ptxas" in line)


class CudaKernel:
    """One C entry point of a built library, with its launch count.

    The C function returns ``cudaGetLastError()`` right after its launch;
    ``launch`` raises when that is not 0 and otherwise adds one to
    ``launches``.
    """

    def __init__(self, source: KernelSource, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._lib = None

    def _load(self):
        if self._fn is None:
            path = build([self.source])[self.source.name]
            self._lib = ctypes.CDLL(str(path))
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(self._lib, f"{self.source.name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._error_string = err
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        code = self._load()(*args)
        if code != 0:
            raise RuntimeError(
                f"{self.symbol}: CUDA error {code} "
                f"({self._error_string(code).decode()})")
        self.launches += 1
