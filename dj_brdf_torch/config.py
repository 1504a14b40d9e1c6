"""Global configuration.

Mirrors the reference's compile-time switches (dj_brdf.h:44-51):
``DJB_USE_DOUBLE_PRECISION`` -> :func:`use_x64`, ``DJB_EPSILON`` ->
:data:`EPSILON`.
"""

from __future__ import annotations

import logging

import torch

logger = logging.getLogger("dj_brdf_torch")

#: Numerical epsilon used for horizon / degeneracy clamps
#: (reference DJB_EPSILON, dj_brdf.h:49-51).
EPSILON = 1e-4


def use_x64(enable: bool = True) -> None:
    """Make float64 the default float type (reference
    DJB_USE_DOUBLE_PRECISION)."""
    torch.set_default_dtype(torch.float64 if enable else torch.float32)


def default_float() -> torch.dtype:
    return torch.get_default_dtype()
