"""Moment-based roughness extraction from tabulated NDFs.

Port of the reference's direct parametric conversions
``tabular::fit_beckmann_parameters`` (dj_brdf.h:3133-3158),
``tabular::fit_ggx_parameters`` (3160-3184), and the anisotropic
5-moment variants (3186-3307). The quadrature grids and weights match
the reference exactly. A :class:`Tabular` holding a stack of tables
(*B, res) yields (*B,) alphas. Every fit is tensor arithmetic on the
table's device, differentiable w.r.t. the table.

Counterpart of ``dj_brdf_tpu/fit/moments.py``.
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


def _aniso_moments(dist):
    """The 5-moment quadrature grid over the standard slope PDF
    (dj_brdf.h:3186-3307), in the precision and on the device of the
    distribution's tables: the weights p22 tan / cos^2 of each node, the
    node slopes (e1, e2) and the node's tan, cos and sin of phi."""
    ft, dev = dist.p22.dtype, dist.p22.device
    ntheta, nphi = 128, 512
    phi = (torch.arange(nphi, dtype=ft, device=dev) / nphi) \
        * round_to(2.0 * np.pi, ft)
    theta = (torch.arange(ntheta, dtype=ft, device=dev) / ntheta) \
        * round_to(np.sqrt(np.pi * 0.5), ft)
    T2, P = torch.meshgrid(theta * theta, phi, indexing="xy")  # (nphi, ntheta)
    Tw = torch.meshgrid(theta, phi, indexing="xy")[0]
    p22 = dist.p22_std_theta_phi(T2, P)
    tan_t = torch.tan(T2)
    cos_t = torch.cos(T2)
    w = Tw * p22 * tan_t / (cos_t * cos_t)
    cos_p = torch.cos(P)
    sin_p = torch.sin(P)
    return w, -tan_t * cos_p, -tan_t * sin_p, tan_t, cos_p, sin_p


def _moment(w, e):
    scale = 2.0 * (np.sqrt(np.pi * 0.5) / 128) * (2.0 * np.pi / 512)
    return torch.sum(w * e) * scale


def fit_beckmann_parameters_anisotropic(dist) -> MicrofacetParams:
    """Mean slopes, slope variances and correlation of a
    :class:`TabularAnisotropic` (dj_brdf.h:3186-3247)."""
    w, e1, e2, tan_t, cos_p, sin_p = _aniso_moments(dist)
    mux, muy = _moment(w, e1), _moment(w, e2)
    m3 = _moment(w, tan_t ** 2 * cos_p ** 2)
    m4 = _moment(w, tan_t ** 2 * sin_p ** 2)
    m5 = _moment(w, tan_t ** 2 * cos_p * sin_p)
    ax = torch.sqrt(2.0 * (m3 - mux * mux))
    ay = torch.sqrt(2.0 * (m4 - muy * muy))
    rho = 2.0 * (m5 - mux * muy) / (ax * ay)
    return MicrofacetParams.pdfparams(ax, ay, rho, mux, muy)


def fit_ggx_parameters_anisotropic(dist) -> MicrofacetParams:
    """First absolute slope moments of a :class:`TabularAnisotropic`
    (dj_brdf.h:3249-3307; rho fixed to 0 as in the reference's TODO)."""
    w, e1, e2, _, _, _ = _aniso_moments(dist)
    mux, muy = _moment(w, e1), _moment(w, e2)
    m3, m4 = _moment(w, torch.abs(e1)), _moment(w, torch.abs(e2))
    ax = torch.sqrt(torch.clamp(m3 * m3 - mux * mux, min=0.0))
    ay = torch.sqrt(torch.clamp(m4 * m4 - muy * muy, min=0.0))
    return MicrofacetParams.pdfparams(ax, ay, 0.0, mux, muy)
