"""Build and load the port's CUDA kernels.

Each source under ``dj_brdf_torch/csrc`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, at
first use, into ``build/dj_brdf_torch/`` at the root of the checkout.
The library's name carries a hash of its source, so an edited source
is rebuilt and an unchanged one is loaded as it is. Libraries are
loaded with ``ctypes``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "dj_brdf_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: seconds each library took to build (0.0 when it was already built)
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of dj_brdf_torch "
                       "are built from source and need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    sha = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libdjbt_{name}_{sha}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library's path. The compiler's ``-Xptxas -v`` report (registers,
    spills) is kept beside it as ``<library>.ptxas.txt``."""
    out = library_path(name)
    if out.exists():
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    report = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{report}")
    Path(str(out) + ".ptxas.txt").write_text(report)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` output of the current build of ``name``."""
    path = Path(str(library_path(name)) + ".ptxas.txt")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build(name)))
