"""Moment-based roughness extraction from tabulated NDFs.

Port of the reference's direct parametric conversions
``tabular::fit_beckmann_parameters`` (dj_brdf.h:3133-3158) and
``tabular::fit_ggx_parameters`` (3160-3184). The quadrature grids and
weights match the reference exactly. A :class:`Tabular` holding a stack
of tables (*B, res) yields (*B,) alphas.

Counterpart of ``dj_brdf_tpu/fit/moments.py``. The anisotropic
5-moment variants (3186-3307) need ``TabularAnisotropic`` and are not
ported yet.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from dj_brdf_torch.config import logger, round_to
from dj_brdf_torch.microfacet.params import MicrofacetParams


def _log_alpha(name, alpha):
    """The reference prints each fitted alpha (dj_brdf.h:3154, 3180);
    here at debug level, read back from the device only when that level
    is on."""
    if logger.isEnabledFor(logging.DEBUG):
        logger.debug("%s: alpha = %s", name, alpha.tolist())


def _quadrature(dist):
    """The 128-pt u^2-warped grid of both fits, in the precision of the
    distribution's tables (float32 for analytic ones): u, cos and
    tan of theta_h, and p22_radial(tan^2)."""
    t = getattr(dist, "p22", None)
    ft = t.dtype if t is not None else torch.float32
    device = t.device if t is not None else None
    ntheta = 128
    u = torch.arange(ntheta, dtype=ft, device=device) / ntheta
    theta_h = u * u * round_to(np.pi * 0.5, ft)
    cos_h = torch.cos(theta_h)
    r_h = torch.tan(theta_h)
    return u, cos_h, r_h, dist.p22_radial(r_h * r_h)


def fit_beckmann_parameters(dist) -> MicrofacetParams:
    """alpha = sqrt(2 E[r^2 cos^2 phi]) (dj_brdf.h:3133-3158)."""
    u, cos_h, r_h, p22_r = _quadrature(dist)
    nint = torch.sum((u * r_h ** 3 * p22_r) / (cos_h * cos_h), dim=-1)
    nint = nint * (np.pi / 128) * np.pi  # int_0^2pi cos^2 = pi
    alpha = torch.sqrt(2.0 * nint)
    _log_alpha("fit_beckmann_parameters", alpha)  # dj_brdf.h:3154
    return MicrofacetParams.isotropic(alpha)


def fit_ggx_parameters(dist) -> MicrofacetParams:
    """alpha = E[r |cos phi|]-style first moment (dj_brdf.h:3160-3184)."""
    u, cos_h, r_h, p22_r = _quadrature(dist)
    nint = torch.sum((u * r_h ** 2 * p22_r) / (cos_h * cos_h), dim=-1)
    alpha = nint * (np.pi / 128) * 4.0  # int_0^2pi |cos| = 4
    _log_alpha("fit_ggx_parameters", alpha)  # dj_brdf.h:3180
    return MicrofacetParams.isotropic(alpha)
