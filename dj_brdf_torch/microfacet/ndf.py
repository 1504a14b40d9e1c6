"""Microfacet normal/slope distributions: the evaluation half.

Port of the reference's analytic distributions ``djb::beckmann``
(dj_brdf.h:1863-2051) and ``djb::ggx`` (2053-2146), and of the
isotropic tabulated one, ``djb::tabular`` (2148-2176). Each
distribution is a frozen dataclass exposing the *standard-frame*
interface consumed by :mod:`dj_brdf_torch.microfacet.brdf`:

  * ``p22_std(x, y)`` — standard slope PDF
  * ``sigma_std(k)``  — standard projected area (microflake sigma)

Everything is branchless (``torch.where`` instead of the reference's
``if`` trees). The samplers (``qf1``/``qf2``/``qf3``,
``sample_vp22_std``) and ``TabularAnisotropic`` are not ported yet.
"""

from __future__ import annotations

import math

import torch

from dj_brdf_torch.core import spline
from dj_brdf_torch.core.pytree import pytree_dataclass, static_field
from dj_brdf_torch.core.special import erf

_SQRT_PI_INV = 0.5641895835477563  # 1/sqrt(pi)


@pytree_dataclass
class Beckmann:
    """Beckmann (Gaussian-slope) distribution (reference djb::beckmann,
    dj_brdf.h:1863-1957)."""

    supports_smith_vndf: bool = static_field(default=True)

    # -- radial queries ----------------------------------------------
    def p22_radial(self, r_sqr):
        return torch.exp(-r_sqr) / math.pi

    def sigma_std_radial(self, cos_theta_k):
        """Closed-form projected area with erf (dj_brdf.h:1871-1879)."""
        c = cos_theta_k
        sin_theta_k = torch.sqrt(torch.clamp(1.0 - c * c, min=1e-24))
        safe_sin = torch.clamp(sin_theta_k, min=1e-12)
        nu = c / safe_sin
        tmp = torch.exp(-nu * nu) * _SQRT_PI_INV
        sigma = (c * (1.0 + erf(nu)) + sin_theta_k * tmp) / 2.0
        return torch.where(c >= 1.0, 1.0, sigma)

    def cdf_radial(self, r):
        return 1.0 - torch.exp(-r * r)

    def qf_radial(self, u):
        return torch.sqrt(-torch.log(torch.clamp(1.0 - u, min=1e-38)))

    # -- standard-frame interface -------------------------------------
    def p22_std(self, x, y):
        return self.p22_radial(x * x + y * y)

    def sigma_std(self, k):
        return self.sigma_std_radial(k[..., 2])


@pytree_dataclass
class GGX:
    """GGX / Trowbridge-Reitz distribution (reference djb::ggx,
    dj_brdf.h:2053-2146)."""

    supports_smith_vndf: bool = static_field(default=True)

    def p22_radial(self, r_sqr):
        tmp = 1.0 + r_sqr
        return 1.0 / (math.pi * tmp * tmp)

    def sigma_std_radial(self, cos_theta_k):
        return (1.0 + cos_theta_k) / 2.0

    def cdf_radial(self, r):
        tmp = r * r
        return tmp / (1.0 + tmp)

    def qf_radial(self, u):
        return torch.sqrt(u / torch.clamp(1.0 - u, min=1e-12))

    def p22_std(self, x, y):
        return self.p22_radial(x * x + y * y)

    def sigma_std(self, k):
        return self.sigma_std_radial(k[..., 2])


@pytree_dataclass
class GGXSphericalCaps(GGX):
    """GGX with spherical-cap VNDF sampling (Dupuy & Benyoub,
    "Sampling Visible GGX Normals with Spherical Caps", 2023,
    arXiv:2306.05044). Its distribution, and so everything evaluated
    here, is GGX's; only its sampler (not ported yet) differs."""


@pytree_dataclass
class Tabular:
    """Isotropic tabulated distribution (reference djb::tabular,
    dj_brdf.h:2148-2176). Tables are produced by the fitting pipeline
    (:mod:`dj_brdf_torch.fit.tabular`):

    * ``p22``:  (res,) slope PDF sampled in u = sqrt(2 atan(r)/pi)
    * ``sigma``: (res,) projected area sampled in u = 2 theta/pi
    * ``cdf``, ``qf``: (res,) radial CDF/quantile for nmap sampling

    The tables may carry leading stack axes, (*B, res): every query
    then returns (*B, *query shape), one answer per table.
    """

    p22: torch.Tensor
    sigma: torch.Tensor
    cdf: torch.Tensor
    qf: torch.Tensor
    supports_smith_vndf: bool = static_field(default=False)

    # The 1e-24 floors and the atan2 arccos: sqrt/arccos have infinite
    # derivatives at 0 / +-1, and those inputs are hit exactly by
    # sanitized lanes (h = up => r_sqr = 0, i = up => cos = 1); a
    # 0-cotangent x inf-derivative is NaN in reverse mode. Value changes
    # are <= 1e-12.
    def p22_radial(self, r_sqr):
        r = torch.sqrt(torch.clamp(r_sqr, min=1e-24))
        u = torch.sqrt(torch.clamp(2.0 * torch.arctan(r) / math.pi,
                                   min=1e-24))
        return spline.eval1d_stack(self.p22, u)

    def sigma_std_radial(self, cos_theta_k):
        c = torch.clamp(cos_theta_k, -1.0, 1.0)
        # arccos via atan2 with a floored sine: same value, finite
        # derivative at the poles
        theta = torch.atan2(torch.sqrt(torch.clamp(1.0 - c * c, min=1e-24)),
                            c)
        return spline.eval1d_stack(self.sigma, 2.0 * theta / math.pi)

    def cdf_radial(self, r):
        u = torch.clamp(torch.arctan(r) * 2.0 / math.pi, min=1e-24)
        return spline.eval1d_stack(self.cdf, torch.sqrt(u))

    def qf_radial(self, u):
        qf = spline.eval1d_stack(self.qf, u)
        return torch.tan(qf * math.pi / 2.0)

    def p22_std(self, x, y):
        return self.p22_radial(x * x + y * y)

    def sigma_std(self, k):
        return self.sigma_std_radial(k[..., 2])
