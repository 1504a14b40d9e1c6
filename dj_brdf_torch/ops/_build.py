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


def build_all(names) -> dict[str, Path]:
    """Compile each ``csrc/<name>.cu`` of ``names`` whose library does
    not exist yet, one ``nvcc`` process per source, all started
    together; returns every library's path. The compiler's ``-Xptxas
    -v`` report (registers, spills) is kept beside each library as
    ``<library>.ptxas.txt``. Raises if any build fails."""
    paths = {name: library_path(name) for name in names}
    todo = [name for name, out in paths.items() if not out.exists()]
    for name in set(paths) - set(todo):
        BUILD_SECONDS.setdefault(name, 0.0)
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    started = {}
    for name in todo:
        tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        started[name] = (tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, t0, proc) in started.items():
        report, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {name}.cu "
                          f"(exit {proc.returncode}):\n{report}")
            continue
        Path(str(paths[name]) + ".ptxas.txt").write_text(report)
        os.replace(tmp, paths[name])  # atomic: a loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library's path (see :func:`build_all`)."""
    return build_all([name])[name]


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` output of the current build of ``name``."""
    path = Path(str(library_path(name)) + ".ptxas.txt")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build(name)))
