"""Build the port's CUDA kernels with nvcc and call them through ctypes.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface, built
at first use into a shared library for Hopper (``sm_90a``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v [per-kernel flags] -o lib<name>-<hash>.so

No PyTorch header is compiled, so a build takes seconds. The library name
carries a hash of the source and the flags, so an edited source is rebuilt;
a build writes to a temporary name and renames, so concurrent processes do
not see half-written files. ``ptxas``'s report (registers, shared memory,
spills) is kept beside each library as ``<library>.log``; ``sass`` dumps a
built library's machine code.

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
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


@dataclasses.dataclass(frozen=True)
class KernelSource:
    name: str                       # csrc/<name>.cu
    extra_flags: Tuple[str, ...] = ()

    @property
    def path(self) -> Path:
        return CSRC / f"{self.name}.cu"

    def library(self) -> Path:
        digest = hashlib.sha256(self.path.read_bytes())
        digest.update(" ".join(NVCC_FLAGS + self.extra_flags).encode())
        return build_dir() / f"lib{self.name}-{digest.hexdigest()[:16]}.so"

    def command(self, out: Path) -> list:
        return [nvcc_path(), *NVCC_FLAGS, *self.extra_flags, "-o", str(out),
                str(self.path)]


def build(sources: Sequence[KernelSource]) -> Dict[str, Path]:
    """Build every source not built yet, one nvcc each, all at once.
    Returns {name: library path}; raises with nvcc's output on failure."""
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
            failed.append(f"{src.name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        Path(str(out[src.name]) + ".log").write_text(log)
        os.replace(tmp, out[src.name])
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
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
