"""Generic Smith-microfacet BRDF: Torrance-Sparrow with the sigma-based
height-correlated Smith masking term.

Port of the reference ``djb::microfacet`` evaluation and sampling core
(dj_brdf.h:1529-1791). The reference's virtual dispatch becomes static
dispatch: each function takes the distribution (``GGX``/``Beckmann``)
plus a :class:`~dj_brdf_torch.microfacet.params.MicrofacetParams`, and
is pure, branchless, and broadcasting over leading batch dimensions.

The affine slope-space warp that carries the elliptic anisotropy and
the non-central mean normal (dj_brdf.h:1574-1587, 1620-1631,
1669-1709) appears in three places: p22, sigma, and sampling.
"""

from __future__ import annotations

import torch

from dj_brdf_torch.config import EPSILON
from dj_brdf_torch.core.math import dot, normalize, reflect, sat, vec3


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


def sample(dist, params, u1, u2, o):
    """Importance-sample the (V)NDF and reflect (reference
    microfacet::sample, dj_brdf.h:1669-1709). Returns i of shape (..., 3)."""
    u1 = sat(u1) * 0.99998 + 0.00001
    u2 = sat(u2) * 0.99998 + 0.00001

    # warp the receiver direction into the standard frame
    a = o[..., 0] * params.ax + o[..., 1] * params.ay * params.rho
    b = o[..., 1] * params.ay * params.sqrt_one_minus_rho_sqr
    c = o[..., 2] - o[..., 0] * params.txn - o[..., 1] * params.tyn
    o_std = normalize(vec3(a, b, c), eps=1e-24)
    valid = o_std[..., 2] > 0.0

    tx_m, ty_m = dist.sample_vp22_std(u1, u2, o_std)

    # unwarp via the Cholesky factor + mean-normal offset
    tx_h = params.ax * tx_m + params.txn
    choleski = params.rho * tx_m + params.sqrt_one_minus_rho_sqr * ty_m
    ty_h = params.ay * choleski + params.tyn

    h = normalize(vec3(-tx_h, -ty_h, torch.ones_like(tx_h)))
    i = reflect(o, h)
    up = torch.zeros_like(i)
    up[..., 2] = 1.0
    return torch.where(valid[..., None], i, up)


def pdf(dist, params, i, o, shadow: bool = True):
    """PDF of :func:`sample` (reference microfacet::pdf,
    dj_brdf.h:1713-1730): VNDF-based when the distribution supports
    Smith VNDF sampling, D-based otherwise."""
    h = normalize(i + o, eps=1e-24)
    g = gaf(dist, params, h, i, o, shadow)
    ih = dot(i, h)
    if dist.supports_smith_vndf:
        val = _safe_div(vndf(dist, params, h, o), 4.0 * ih)
    else:
        val = _safe_div(h[..., 2] * ndf(dist, params, h), 4.0 * ih)
    return torch.where(g > 0.0, val, 0.0)


def evalp_is(dist, fres, params, u1, u2, o, shadow: bool = True):
    """Sample + weight: returns (weight (...,3), i (...,3), pdf (...))
    with weight = evalp/pdf — F G / G1 for Smith-VNDF samplers
    (reference microfacet::evalp_is, dj_brdf.h:1734-1765)."""
    i = sample(dist, params, u1, u2, o)
    # sanitize before the weight math: below-warped-horizon receivers
    # make the sampler emit garbage directions, and near-degenerate half
    # vectors make 1/h.z blow up; both are gated out of the output, but
    # an inf in a gated lane's forward intermediates turns its zero
    # backward gradient into NaN
    up = torch.zeros_like(i)
    up[..., 2] = 1.0
    valid = dot(o, params.mean_normal) > 0.0
    i = torch.where(valid[..., None], i, up)
    h = normalize(i + o, eps=1e-24)
    ok_h = h[..., 2] > 1e-6
    h = torch.where(ok_h[..., None], h, up)
    g = gaf(dist, params, h, i, o, shadow)
    cos_theta_d = sat(dot(o, h))
    ok = (g > 0.0) & valid & ok_h

    if dist.supports_smith_vndf:
        f = fres(cos_theta_d)
        g1_o = g1(dist, params, h, o)
        pdf_val = _safe_div(vndf(dist, params, h, o), 4.0 * cos_theta_d)
        weight = f * _safe_div(g, g1_o)[..., None]
    else:
        pdf_val = _safe_div(h[..., 2] * ndf(dist, params, h),
                            4.0 * cos_theta_d)
        weight = evalp(dist, fres, params, i, o, shadow) \
            * _safe_div(torch.ones_like(pdf_val), pdf_val)[..., None]

    weight = torch.where(ok[..., None], weight, 0.0)
    pdf_val = torch.where(ok, pdf_val, 0.0)
    return weight, i, pdf_val
