"""ctypes bindings for the port's native ``djbio`` data plane.

``csrc/djbio.cpp`` is built with ``g++`` (OpenMP) at first use into
``build/dj_brdf_torch/`` by :mod:`dj_brdf_torch.ops._build`, like the
environment map's alias builder, and exposes the native MERL, UTIA and
Radiance .hdr parsers and the LEAN map builders. Inputs and outputs are
numpy arrays on the host. A missing compiler, a failed build or a file
the parser rejects raises: nothing here falls back to numpy (the numpy
and torch forms live in :mod:`dj_brdf_torch.io.merl_io`, ``utia_io``,
``hdr`` and :mod:`dj_brdf_torch.lean.maps`, and are called by name).

Counterpart of ``dj_brdf_tpu/io/native.py``.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from dj_brdf_torch.models.merl import TABLE_SHAPE as MERL_SHAPE
from dj_brdf_torch.models.utia import TABLE_SHAPE as UTIA_SHAPE

_lock = threading.Lock()
_lib = None

# the parsers' error codes (csrc/djbio.cpp), worded as the numpy readers
# word the same faults
_MERL_ERRORS = {-1: "cannot open MERL file", -2: "failed to read MERL header of",
                -3: "unexpected MERL dims in", -4: "truncated MERL file"}
_UTIA_ERRORS = {-1: "cannot open UTIA file", -4: "truncated UTIA file"}
_HDR_ERRORS = {-1: "not a Radiance file (missing #? magic):",
               -2: "not a Radiance file (missing #? magic):",
               -3: "truncated .hdr header in",
               -4: "unsupported .hdr format in",
               -5: "missing .hdr resolution line in",
               -6: "unsupported .hdr resolution line in",
               -7: "bad .hdr resolution in",
               -10: "cannot open .hdr file"}


def _raise(fn, rc, path, messages):
    """``ValueError`` for the native call ``fn``'s error code ``rc``."""
    what = messages.get(rc, "malformed .hdr scanline in" if rc <= -100
                        else "failed on")
    raise ValueError(f"{what} {path} ({fn} returned {rc})")


def _load():
    global _lib
    with _lock:
        if _lib is None:
            from dj_brdf_torch.ops import _build

            lib = _build.load("djbio")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32 = ctypes.POINTER(ctypes.c_int32)
            lib.djbt_load_merl.argtypes = [ctypes.c_char_p, f32p]
            lib.djbt_load_merl.restype = ctypes.c_int
            lib.djbt_load_utia.argtypes = [ctypes.c_char_p, f32p]
            lib.djbt_load_utia.restype = ctypes.c_int
            lib.djbt_dmap_to_nmap.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                                              ctypes.c_float, ctypes.c_int,
                                              f32p]
            lib.djbt_dmap_to_nmap.restype = None
            lib.djbt_nmap_to_lean.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                                              ctypes.c_float, ctypes.c_float,
                                              f32p]
            lib.djbt_nmap_to_lean.restype = None
            lib.djbt_lean_mip_reduce.argtypes = [f32p, ctypes.c_int,
                                                 ctypes.c_int, f32p]
            lib.djbt_lean_mip_reduce.restype = None
            lib.djbt_hdr_size.argtypes = [ctypes.c_char_p, i32, i32]
            lib.djbt_hdr_size.restype = ctypes.c_int
            lib.djbt_load_hdr.argtypes = [ctypes.c_char_p, f32p]
            lib.djbt_load_hdr.restype = ctypes.c_int
            _lib = lib
        return _lib


def load_merl(path: str) -> np.ndarray:
    """(3, 90, 90, 180) raw float32 table via the native parser."""
    out = np.empty(MERL_SHAPE, np.float32)
    rc = _load().djbt_load_merl(str(path).encode(), out)
    if rc != 0:
        _raise("djbt_load_merl", rc, path, _MERL_ERRORS)
    return out


def load_utia(path: str) -> np.ndarray:
    """(3, 6, 48, 6, 48) normalized float32 table via the native parser.
    A positive return from the native call is the count of clamped
    negative samples (the reference's per-value warning in
    utia::normalize, dj_brdf.h:1162-1177, reported once)."""
    out = np.empty(UTIA_SHAPE, np.float32)
    rc = _load().djbt_load_utia(str(path).encode(), out)
    if rc < 0:
        _raise("djbt_load_utia", rc, path, _UTIA_ERRORS)
    if rc > 0:
        from dj_brdf_torch.config import logger
        logger.debug("utia %s: clamped %d negative samples", path, rc)
    return out


def dmap_to_nmap(dmap: np.ndarray, scale: float = 0.01,
                 clamp_to_border: bool = False) -> np.ndarray:
    """Displacement (h, w) -> unit normals (h, w, 3), as
    :func:`dj_brdf_torch.lean.maps.dmap_to_nmap`."""
    dmap = np.ascontiguousarray(dmap, np.float32)
    h, w = dmap.shape
    out = np.empty((h, w, 3), np.float32)
    _load().djbt_dmap_to_nmap(dmap, h, w, scale, int(clamp_to_border), out)
    return out


def nmap_to_lean(nmap: np.ndarray, base_roughness: float = 1e-5,
                 bias: float = 0.0) -> np.ndarray:
    """Normal map (h, w, 3) -> the 5 LEAN moment planes stacked as
    (5, h, w), as :func:`dj_brdf_torch.lean.maps.nmap_to_lean`."""
    nmap = np.ascontiguousarray(nmap, np.float32)
    h, w = nmap.shape[:2]
    out = np.empty((5, h, w), np.float32)
    _load().djbt_nmap_to_lean(nmap, h, w, base_roughness, bias, out)
    return out


def lean_mip_reduce(lean: np.ndarray) -> np.ndarray:
    """(5, h, w) -> (5, h/2, w/2): one 2x2-mean mip level."""
    lean = np.ascontiguousarray(lean, np.float32)
    _, h, w = lean.shape
    out = np.empty((5, h // 2, w // 2), np.float32)
    _load().djbt_lean_mip_reduce(lean, h, w, out)
    return out


def load_hdr(path: str) -> np.ndarray:
    """Decode a Radiance .hdr image to (h, w, 3) float32 radiance
    (RLE and flat scanlines; EXPOSURE headers divided out). Raises
    ``ValueError`` for a file the decoder rejects."""
    lib = _load()
    h, w = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.djbt_hdr_size(str(path).encode(), ctypes.byref(h),
                           ctypes.byref(w))
    if rc != 0:
        _raise("djbt_hdr_size", rc, path, _HDR_ERRORS)
    out = np.empty((h.value, w.value, 3), np.float32)
    rc = lib.djbt_load_hdr(str(path).encode(), out)
    if rc != 0:
        _raise("djbt_load_hdr", rc, path, _HDR_ERRORS)
    return out
