"""UTIA binary file I/O (host side).

Format (reference utia::utia, dj_brdf.h:1039-1059): raw float64 array
of 3 planes x 6 theta_i x 48 phi_i x 6 theta_v x 48 phi_v. Loading
clamps negatives to zero and applies the 1/140 scale, matching
``utia::normalize`` (dj_brdf.h:1162-1177).

Counterpart of ``dj_brdf_tpu/io/utia_io.py``. With ``use_native=True``
the file is parsed by the port's ``djbio`` library
(:mod:`dj_brdf_torch.io.native`); a failed build or parse raises, there
is no quiet fallback to numpy.
"""

from __future__ import annotations

import numpy as np

from dj_brdf_torch.models.utia import TABLE_SHAPE

_COUNT = int(np.prod(TABLE_SHAPE))


def load_utia(path: str, dtype=np.float32,
              use_native: bool = True) -> np.ndarray:
    """Load a UTIA binary -> normalized (3, 6, 48, 6, 48) array.

    ``use_native=True`` (float32 only, as in the JAX package) parses with
    the native ``djbio`` library, built with ``g++`` at first use; its
    build or parse failing raises. ``use_native=False`` reads with
    numpy."""
    if use_native and dtype == np.float32:
        from dj_brdf_torch.io import native
        return native.load_utia(path)
    data = np.fromfile(path, dtype="<f8", count=_COUNT)
    if data.size != _COUNT:
        raise ValueError(f"truncated UTIA file {path}")
    neg = int((data < 0).sum())
    if neg:
        # the reference warns per clamped value in utia::normalize
        # (dj_brdf.h:1162-1177); the count is reported once, at load
        from dj_brdf_torch.config import logger
        logger.debug("utia %s: clamped %d negative samples", path, neg)
    data = np.maximum(data, 0.0) * (1.0 / 140.0)
    return data.reshape(TABLE_SHAPE).astype(dtype)


def save_utia(path: str, table) -> None:
    """Write a raw (3, 6, 48, 6, 48) table (pre-normalization values;
    a numpy array or a tensor)."""
    if hasattr(table, "detach"):
        table = table.detach().cpu().numpy()
    table = np.asarray(table, dtype="<f8")
    if table.shape != TABLE_SHAPE:
        raise ValueError(f"UTIA table must be {TABLE_SHAPE}, got "
                         f"{table.shape}")
    table.tofile(path)
