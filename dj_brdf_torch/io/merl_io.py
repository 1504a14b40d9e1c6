"""MERL binary file I/O (host side, numpy).

Format (reference merl::merl, dj_brdf.h:963-983): three little-endian
int32 dims followed by dims[0]*dims[1]*dims[2]*3 float64 samples,
channel-major (R plane, G plane, B plane).

Counterpart of ``dj_brdf_tpu/io/merl_io.py``. With ``use_native=True``
the file is parsed by the port's ``djbio`` library
(:mod:`dj_brdf_torch.io.native`); a failed build or parse raises, there
is no quiet fallback to numpy.
"""

from __future__ import annotations

import numpy as np

from dj_brdf_torch.models.merl import PLANE, TABLE_SHAPE


def load_merl(path: str, dtype=np.float32,
              use_native: bool = True) -> np.ndarray:
    """Load a MERL .binary file -> (3, 90, 90, 180) raw (unscaled) array.

    ``use_native=True`` (float32 only, as in the JAX package) parses with
    the native ``djbio`` library, built with ``g++`` at first use; its
    build or parse failing raises. ``use_native=False`` reads with
    numpy."""
    if use_native and dtype == np.float32:
        from dj_brdf_torch.io import native
        return native.load_merl(path)
    with open(path, "rb") as f:
        dims = np.fromfile(f, dtype="<i4", count=3)
        n = (int(dims[0]) * int(dims[1]) * int(dims[2])
             if dims.size == 3 else 0)
        if n <= 0:
            raise ValueError(f"failed to read MERL header of {path}")
        data = np.fromfile(f, dtype="<f8", count=3 * n)
    if data.size != 3 * n:
        raise ValueError(f"truncated MERL file {path}")
    if n != PLANE:
        raise ValueError(f"unexpected MERL dims {tuple(dims)} in {path}")
    table = data.reshape(TABLE_SHAPE).astype(dtype)
    neg = int((table < 0).any(axis=0).sum())
    if neg:
        # the reference warns per below-horizon lookup at eval time
        # (dj_brdf.h:1016-1021); the count is reported once, at load
        from dj_brdf_torch.config import logger
        logger.debug("merl %s: %d below-horizon bins (negative values "
                     "evaluate to zero)", path, neg)
    return table


def save_merl(path: str, table) -> None:
    """Write a (3, 90, 90, 180) raw table (numpy array or tensor) as a
    MERL .binary file."""
    if hasattr(table, "detach"):
        table = table.detach().cpu().numpy()
    table = np.asarray(table, dtype=np.float64)
    if table.shape != TABLE_SHAPE:
        raise ValueError(f"MERL table must be {TABLE_SHAPE}, got "
                         f"{table.shape}")
    with open(path, "wb") as f:
        np.asarray(TABLE_SHAPE[1:], dtype="<i4").tofile(f)
        table.astype("<f8").tofile(f)
