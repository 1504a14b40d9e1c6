"""Build and load the port's CUDA kernels and its host library.

Each source under ``dj_brdf_torch/csrc`` is compiled into a shared
library with a plain C interface, at first use, into
``build/dj_brdf_torch/`` at the root of the checkout: a ``.cu`` source
by ``nvcc`` for Hopper (``sm_90a``), a ``.cpp`` source (host code, such
as the environment map's alias-table builder) by the host C++ compiler
``g++``. The library's name carries a hash of its source, so an edited
source is rebuilt and an unchanged one is loaded as it is; a build is
written under a temporary name and moved into place, so processes that
build at once never load half a file. Libraries are loaded with
``ctypes``. Nothing here runs at import time, and a missing compiler
raises: there is no fallback.
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
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-fopenmp")

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


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host library of dj_brdf_torch "
                           "is built from source and needs a C++ compiler")
    return cxx


def source(name: str) -> Path:
    """``csrc/<name>.cu`` (a CUDA source) or ``csrc/<name>.cpp`` (host)."""
    for suffix in (".cu", ".cpp"):
        if (CSRC / f"{name}{suffix}").exists():
            return CSRC / f"{name}{suffix}"
    raise FileNotFoundError(f"no source csrc/{name}.cu or .cpp")


def library_path(name: str) -> Path:
    sha = hashlib.sha256(source(name).read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libdjbt_{name}_{sha}.so"


def build_all(names) -> dict[str, Path]:
    """Compile each source of ``names`` whose library does not exist
    yet, one compiler process per source, all started together; returns
    every library's path. For a CUDA source the compiler's ``-Xptxas
    -v`` report (registers, spills) is kept beside its library as
    ``<library>.ptxas.txt``. Raises if any build fails."""
    paths = {name: library_path(name) for name in names}
    todo = [name for name, out in paths.items() if not out.exists()]
    for name in set(paths) - set(todo):
        BUILD_SECONDS.setdefault(name, 0.0)
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in todo:
        src = source(name)
        tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
        cuda = src.suffix == ".cu"
        cmd = ([_nvcc(), *NVCC_FLAGS] if cuda else [_cxx(), *CXX_FLAGS]) + [
            "-o", str(tmp), str(src)]
        started[name] = (tmp, cuda, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, cuda, t0, proc) in started.items():
        report, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{'nvcc' if cuda else 'g++'} failed to build "
                          f"{name} (exit {proc.returncode}):\n{report}")
            continue
        if cuda:
            Path(str(paths[name]) + ".ptxas.txt").write_text(report)
        os.replace(tmp, paths[name])  # atomic: a loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` or ``.cpp`` unless its library exists;
    returns the library's path (see :func:`build_all`)."""
    return build_all([name])[name]


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` output of the current build of ``name``."""
    path = Path(str(library_path(name)) + ".ptxas.txt")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` or ``.cpp``."""
    return ctypes.CDLL(str(build(name)))
