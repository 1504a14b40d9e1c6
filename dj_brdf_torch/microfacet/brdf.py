"""Generic Smith-microfacet BRDF: Torrance-Sparrow with the sigma-based
height-correlated Smith masking term.

Port of the reference ``djb::microfacet`` evaluation core
(dj_brdf.h:1529-1665). The reference's virtual dispatch becomes static
dispatch: each function takes the distribution (``GGX``/``Beckmann``)
plus a :class:`~dj_brdf_torch.microfacet.params.MicrofacetParams`, and
is pure, branchless, and broadcasting over leading batch dimensions.

The affine slope-space warp that carries the elliptic anisotropy and
the non-central mean normal (dj_brdf.h:1574-1587, 1620-1631) appears
in p22 and sigma. Sampling (``sample``, ``pdf``, ``evalp_is``) is not
ported yet.
"""

from __future__ import annotations

import torch

from dj_brdf_torch.config import EPSILON
from dj_brdf_torch.core.math import dot, normalize, sat, vec3


def _safe_div(num, den, den_floor=1e-12):
    """num/den with the double-where trick: no NaN in grad when den≈0
    (``torch.where`` has the same 0 * inf trap in backward as
    ``jnp.where``)."""
    small = torch.abs(den) < den_floor
    safe = torch.where(small, 1.0, den)
    return torch.where(small, 0.0, num / safe)


def p22(dist, params, x, y):
    """Warped slope PDF (reference microfacet::p22, dj_brdf.h:1574-1587)."""
    x = x - params.txn
    y = y - params.tyn
    s = params.sqrt_one_minus_rho_sqr
    nrm = params.ax * params.ay * s
    x_ = x / params.ax
    y_ = (params.ax * y - params.rho * params.ay * x) / (params.ax * params.ay * s)
    return dist.p22_std(x_, y_) / nrm


def ndf(dist, params, h):
    """NDF from the slope PDF: D = P22(slopes) / cos^4(theta_h)
    (reference microfacet::ndf, dj_brdf.h:1559-1570)."""
    hz = h[..., 2]
    valid = hz > EPSILON
    safe_hz = torch.where(valid, hz, 1.0)
    xslope = -h[..., 0] / safe_hz
    yslope = -h[..., 1] / safe_hz
    c2 = safe_hz * safe_hz
    return torch.where(valid, p22(dist, params, xslope, yslope) / (c2 * c2),
                       0.0)


def sigma(dist, params, k):
    """Projected microflake area in direction k: warp k by the slope
    transform, then scale the standard sigma (reference
    microfacet::sigma, dj_brdf.h:1620-1631)."""
    a = k[..., 0] * params.ax + k[..., 1] * params.ay * params.rho
    b = k[..., 1] * params.ay * params.sqrt_one_minus_rho_sqr
    c = k[..., 2] - k[..., 0] * params.txn - k[..., 1] * params.tyn
    nrm = torch.sqrt(a * a + b * b + c * c)
    safe_nrm = torch.clamp(nrm, min=1e-20)
    k_std = vec3(a / safe_nrm, b / safe_nrm, c / safe_nrm)
    return nrm * dist.sigma_std(k_std)


def g1(dist, params, h, k):
    """Monodirectional Smith factor G1 = k.z / sigma(k), zero below the
    mean-normal horizon (reference microfacet::g1, dj_brdf.h:1633-1642)."""
    above = dot(k, params.mean_normal) > 0.0
    return torch.where(above, _safe_div(k[..., 2], sigma(dist, params, k)),
                       0.0)


def gaf(dist, params, h, i, o, shadow: bool = True):
    """Height-correlated Smith GAF G = G1i G1o / (G1i + G1o - G1i G1o)
    (reference microfacet::gaf, dj_brdf.h:1644-1665)."""
    g1_o = g1(dist, params, h, o)
    if not shadow:
        return g1_o
    g1_i = g1(dist, params, h, i)
    tmp = g1_i * g1_o
    return torch.where(tmp > 0.0, _safe_div(tmp, g1_i + g1_o - tmp), 0.0)


def vndf(dist, params, h, k):
    """Visible NDF = <k,h> D(h) / sigma(k) (reference microfacet::vndf,
    dj_brdf.h:1601-1615)."""
    kh = dot(k, h)
    val = _safe_div(kh * ndf(dist, params, h), sigma(dist, params, k))
    return torch.where(kh > 0.0, val, 0.0)


def vp22(dist, params, x, y, k):
    """Visible slope PDF (reference microfacet::vp22, dj_brdf.h:1591-1598)."""
    h = normalize(vec3(-x, -y, torch.ones_like(x)))
    jacobian = h[..., 2] ** 3
    return jacobian * vndf(dist, params, h, k)


def evalp(dist, fres, params, i, o, shadow: bool = True):
    """f_r * cos(theta_i) = F D G / (4 o.z) (reference
    microfacet::evalp, dj_brdf.h:1529-1547). Returns (..., 3)."""
    h = normalize(i + o, eps=1e-24)
    g = gaf(dist, params, h, i, o, shadow)
    cos_theta_d = sat(dot(o, h))
    f = fres(cos_theta_d)
    d = ndf(dist, params, h)
    val = f * _safe_div(d * g, 4.0 * o[..., 2])[..., None]
    return torch.where((g > 0.0)[..., None], val, 0.0)


def eval(dist, fres, params, i, o, shadow: bool = True):
    """f_r (reference microfacet::eval, dj_brdf.h:1551-1555)."""
    return evalp(dist, fres, params, i, o, shadow) / i[..., 2:3]
