"""Microfacet normal/slope distributions.

Port of the reference's analytic distributions ``djb::beckmann``
(dj_brdf.h:1863-2051) and ``djb::ggx`` (2053-2146), and of the
tabulated ones, ``djb::tabular`` (2148-2176) and
``djb::tabular_anisotropic`` (2178-2211, 2766-3103). Each
distribution is a frozen dataclass exposing the *standard-frame*
interface consumed by :mod:`dj_brdf_torch.microfacet.brdf`:

  * ``p22_std(x, y)``            — standard slope PDF
  * ``sigma_std(k)``             — standard projected area (microflake sigma)
  * ``sample_vp22_std(u1, u2, k)`` — visible-slope sampling (Smith VNDF
    for Beckmann/GGX; NDF ("nmap") sampling for the tabulated ones)

Everything is branchless (``torch.where`` instead of the reference's
``if`` trees).
"""

from __future__ import annotations

import math

import torch

from dj_brdf_torch.core import spline
from dj_brdf_torch.core.pytree import pytree_dataclass, static_field
from dj_brdf_torch.core.special import erf, erfinv

_SQRT_PI_INV = 0.5641895835477563  # 1/sqrt(pi)


def beckmann_qf2_slope_domain(u, cos_theta_k, sin_theta_k,
                              iterations: int = 4, shared=None):
    """Beckmann visible-slope quantile solved directly in *slope*
    space: returns the sampled x-slope t (== erfinv of the erf-domain
    solution of dj_brdf.h:1897-1952). Each safeguarded Halley step
    costs one exp (the A&S erf polynomial reuses the step's e^{-t^2}),
    with the reference's power-law init (1915-1921).

    ``shared``: optional (cot, tan, c0, e_cot2) precomputed by the
    caller (the fused SoA samplers share them with sigma_std(o), which
    needs erf/exp of the very same cot)."""
    if shared is None:
        safe_sin = torch.clamp(sin_theta_k, min=1e-12)
        safe_cos = torch.clamp(cos_theta_k, min=1e-12)
        cot = safe_cos * (1.0 / safe_sin)
        tan = sin_theta_k * (1.0 / safe_cos)
        c0 = erf(cot)
        e_cot2 = torch.exp(-cot * cot)
    else:
        cot, tan, c0, e_cot2 = shared

    u = torch.clamp(u, min=1e-6)
    fit = 1.0 + cos_theta_k * (-0.876 + cos_theta_k
                               * (0.4265 - 0.0594 * cos_theta_k))
    b0 = c0 - (1.0 + c0) * torch.pow(1.0 - u, fit)
    # the CDF normalization 1 + erf(cot) + tan e^{-cot^2}/sqrt(pi) is
    # >= 1 for every valid receiver; it approaches 0 only on
    # below-horizon lanes that callers gate out. The floor keeps the
    # reciprocal finite, so backward through gated lanes stays
    # 0 * finite instead of 0 * inf = NaN.
    normalization = 1.0 / torch.clamp(
        1.0 + c0 + _SQRT_PI_INV * tan * e_cot2, min=1e-12)

    t0 = erfinv(torch.clamp(b0, min=-0.9999))
    hi = torch.clamp(cot, max=4.0)
    return _Qf2Root.apply(u, tan, normalization, t0, hi, iterations)


def _qf2_halley(u, tan, normalization, t0, hi, iterations: int):
    """The Halley iteration core of :func:`beckmann_qf2_slope_domain`:
    unrolled, without a convergence mask (refining a converged lane is
    a ~0 step), safeguarded by a clip to the root bracket
    [-3.5, min(cot, 4)]."""
    # erf-poly constants (A&S 7.1.26), inlined so the iteration reuses
    # the step's e^{-t^2} for both the CDF's erf and its Gaussian term
    a1, a2, a3 = 0.254829592, -0.284496736, 1.421413741
    a4, a5, p = -1.453152027, 1.061405429, 0.3275911

    t = t0
    lo = -3.5  # u >= 1e-6 => root >= erfinv(2e-6 - 1) ~ -3.36
    for _ in range(iterations):
        t = torch.clamp(torch.clamp(t, min=lo), max=hi)
        e = torch.exp(-t * t)
        at = torch.abs(t)
        k = 1.0 / (1.0 + p * at)
        erf_t = torch.sign(t) * (1.0 - (((((a5 * k + a4) * k) + a3) * k
                                         + a2) * k + a1) * k * e)
        value = normalization * (1.0 + erf_t + _SQRT_PI_INV * tan * e) - u

        dfac = 1.0 - t * tan                     # f' ∝ e (1 - t tan)
        fp = normalization * (2.0 * _SQRT_PI_INV) * e * dfac
        ok_fp = torch.abs(fp) > 1e-20
        r = value * (1.0 / torch.where(ok_fp, fp, 1.0))
        # Halley: f''/(2f') = (-2t(1 - t tan) - tan) / (2 (1 - t tan))
        h = (-2.0 * t * dfac - tan) * (1.0 / (
            2.0 * torch.where(torch.abs(dfac) > 1e-12, dfac, 1.0)))
        den = 1.0 - r * h
        ok_h = ok_fp & (den > 0.5) & (torch.abs(dfac) > 1e-12)
        step = r * torch.where(ok_h, 1.0 / torch.where(ok_h, den, 1.0), 1.0)
        step = torch.where(ok_fp, step, 0.0)
        t = t - step
    return torch.clamp(torch.clamp(t, min=lo), max=hi)


class _Qf2Root(torch.autograd.Function):
    """The converged root t* of F(t; u, tan, N) = N (1 + erf t + tan
    e^{-t^2}/sqrt(pi)) - u, differentiated by the implicit function
    theorem, never through the unrolled iterations (the JAX package's
    ``custom_jvp`` of ``_qf2_root``). The root depends only on
    (u, tan, N), not on the init t0 or the bracket, so the backward is
    the transpose of dt* = (du - F_tan dtan - F_N dN) / F_t: the
    cotangent g goes to u as g / F_t, to tan as -g F_tan / F_t and to N
    as -g F_N / F_t, and nothing to t0 or hi."""

    @staticmethod
    def forward(ctx, u, tan, normalization, t0, hi, iterations):
        t = _qf2_halley(u, tan, normalization, t0, hi, iterations)
        ctx.save_for_backward(t, u, tan, normalization)
        return t

    @staticmethod
    def backward(ctx, g):
        t, u, tan, normalization = ctx.saved_tensors
        e = torch.exp(-t * t)
        # F_t = N (2/sqrt(pi)) e (1 - t tan) (>= 0; -> 0 in the flat
        # tail, where the true quantile sensitivity diverges). The floor
        # is deliberate gradient clipping: it bounds the amplification
        # of tail lanes at 1e3x; interior lanes are unaffected.
        ft = normalization * (2.0 * _SQRT_PI_INV) * e * (1.0 - t * tan)
        ft = torch.clamp(ft, min=1e-3)
        f_tan = normalization * _SQRT_PI_INV * e
        f_norm = u * (1.0 / torch.clamp(normalization, min=1e-30))
        inv_ft = 1.0 / ft
        grads = (g * inv_ft, -g * f_tan * inv_ft, -g * f_norm * inv_ft)
        return tuple(
            gr.sum_to_size(x.shape) if need else None
            for gr, x, need in zip(grads, (u, tan, normalization),
                                   ctx.needs_input_grad[:3])) + (None,) * 3


def _sample_smith_radial(dist, u1, u2, k):
    """Rotate standard visible slopes into the azimuthal frame of k
    (reference radial::sample_vp22_std_smith, dj_brdf.h:1818-1846)."""
    cos_theta_k = k[..., 2]
    sin_theta_k = torch.sqrt(torch.clamp(1.0 - cos_theta_k * cos_theta_k,
                                         min=1e-24))
    tx = dist.qf2_radial(u1, cos_theta_k, sin_theta_k)
    ty = dist.qf3_radial(u2, tx)

    normal_incidence = sin_theta_k <= 1e-9  # floored sqrt: never == 0
    nrm = torch.rsqrt(torch.clamp(k[..., 0] ** 2 + k[..., 1] ** 2,
                                  min=1e-24))
    cos_phi_k = torch.where(normal_incidence, 1.0, k[..., 0] * nrm)
    sin_phi_k = torch.where(normal_incidence, 0.0, k[..., 1] * nrm)
    xslope = cos_phi_k * tx - sin_phi_k * ty
    yslope = sin_phi_k * tx + cos_phi_k * ty
    return xslope, yslope


def _sample_nmap_radial(dist, u1, u2):
    """Polar NDF sampling (reference radial::sample_vp22_std_nmap,
    dj_brdf.h:1806-1816)."""
    phi_h = u1 * 2.0 * math.pi
    r_h = dist.qf_radial(u2)
    return r_h * torch.cos(phi_h), r_h * torch.sin(phi_h)


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

    def qf1(self, u):
        return erfinv(2.0 * u - 1.0)

    def qf2_radial(self, u, cos_theta_k, sin_theta_k):
        """Visible-slope quantile (dj_brdf.h:1897-1952); see
        :func:`beckmann_qf2_slope_domain`."""
        return beckmann_qf2_slope_domain(u, cos_theta_k, sin_theta_k)

    def qf3_radial(self, u, qf2):
        return self.qf1(u)

    # -- standard-frame interface -------------------------------------
    def p22_std(self, x, y):
        return self.p22_radial(x * x + y * y)

    def sigma_std(self, k):
        return self.sigma_std_radial(k[..., 2])

    def sample_vp22_std(self, u1, u2, k):
        return _sample_smith_radial(self, u1, u2, k)


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

    def qf1(self, u):
        """Closed-form marginal slope quantile (dj_brdf.h:2078-2087)."""
        t = torch.abs(2.0 * u - 1.0)
        mag = t * torch.rsqrt(torch.clamp(1.0 - t * t, min=1e-12))
        return torch.where(u < 0.5, -mag, mag)

    def qf2_radial(self, u, cos_theta_k, sin_theta_k):
        """Closed-form visible x-slope quantile, 4-branch tan/cot form
        made branchless (dj_brdf.h:2089-2119)."""
        sin_theta = u * (1.0 + cos_theta_k) - 1.0
        cos_theta = torch.sqrt(torch.clamp(1.0 - sin_theta * sin_theta,
                                           min=1e-24))

        safe_cos = torch.clamp(cos_theta, min=1e-12)
        safe_sin_t = torch.where(sin_theta == 0.0, 1e-12, sin_theta)
        tan_theta = sin_theta / safe_cos
        cot_theta = cos_theta / safe_sin_t

        safe_cos_k = torch.clamp(cos_theta_k, min=1e-12)
        safe_sin_k = torch.clamp(sin_theta_k, min=1e-12)
        tan_theta_k = sin_theta_k / safe_cos_k
        cot_theta_k = cos_theta_k / safe_sin_k

        # branch on cos_theta > sin(pi/4) and sin_theta_k < sin(pi/4)
        s = 0.707107
        r_tt = -(tan_theta + tan_theta_k) / (1.0 - tan_theta * tan_theta_k)
        r_tc = (1.0 + tan_theta * cot_theta_k) / (tan_theta - cot_theta_k)
        r_ct = (1.0 + tan_theta_k * cot_theta) / (tan_theta_k - cot_theta)
        r_cc = (cot_theta + cot_theta_k) / (1.0 - cot_theta * cot_theta_k)
        return torch.where(cos_theta > s,
                           torch.where(sin_theta_k < s, r_tt, r_tc),
                           torch.where(sin_theta_k < s, r_ct, r_cc))

    def qf3_radial(self, u, qf2):
        """Sign-split rational approximation (dj_brdf.h:2121-2146,
        coefficients from Mitsuba)."""
        alpha = torch.sqrt(1.0 + qf2 * qf2)
        s = torch.where(u < 0.5, -1.0, 1.0)
        t = torch.where(u < 0.5, 2.0 * (0.5 - u), 2.0 * (u - 0.5))
        p = t * (t * (t * (-0.365728915865723) + 0.790235037209296)
                 - 0.424965825137544) + 0.000152998850436920
        q = t * (t * (t * (t * 0.169507819808272 - 0.397203533833404)
                      - 0.232500544458471) + 1.0) - 0.539825872510702
        return s * alpha * (p / q)

    def p22_std(self, x, y):
        return self.p22_radial(x * x + y * y)

    def sigma_std(self, k):
        return self.sigma_std_radial(k[..., 2])

    def sample_vp22_std(self, u1, u2, k):
        return _sample_smith_radial(self, u1, u2, k)


@pytree_dataclass
class GGXSphericalCaps(GGX):
    """GGX with spherical-cap VNDF sampling (Dupuy & Benyoub,
    "Sampling Visible GGX Normals with Spherical Caps", 2023,
    arXiv:2306.05044): samples the visible half-vector directly from a
    uniform spherical cap — 2 transcendentals instead of the
    reference's 4-branch qf2 + rational qf3 (dj_brdf.h:2089-2146).
    Identical distribution (VNDF) and pdf."""

    def sample_vp22_std(self, u1, u2, k):
        kz = k[..., 2]
        phi = 2.0 * math.pi * u1
        # uniform z on the cap [-kz, 1]
        z = (1.0 - u2) * (1.0 + kz) - kz
        sin_t = torch.sqrt(torch.clamp(1.0 - z * z, 0.0, 1.0))
        cx = sin_t * torch.cos(phi)
        cy = sin_t * torch.sin(phi)
        # visible half-vector (un-normalized is fine for slopes)
        hx = cx + k[..., 0]
        hy = cy + k[..., 1]
        hz = torch.clamp(z + kz, min=1e-12)
        return -hx / hz, -hy / hz


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

    def sample_vp22_std(self, u1, u2, k):
        return _sample_nmap_radial(self, u1, u2)


def p22_theta_phi(p22, theta, phi):
    """The slope PDF of an anisotropic (H, W) table at slope angles
    (theta, phi) (reference tabular_anisotropic::p22_std_theta_phi,
    dj_brdf.h:2185-2196): a bilinear lookup, edge-clamped in elevation,
    periodic in azimuth."""
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    u1 = theta * 2.0 / math.pi
    u2 = phi * 0.5 / math.pi
    return spline.eval2d(p22, u1, u2, wrap1="edge", wrap2="repeat")


@pytree_dataclass
class TabularAnisotropic:
    """Anisotropic tabulated distribution (reference
    djb::tabular_anisotropic, dj_brdf.h:2178-2211, 2766-3103). Tables are
    produced by :mod:`dj_brdf_torch.fit.tabular_aniso`.

    2D tables are stored as (azimuthal_res, elevation_res), the
    elevation axis fast, matching the reference's flat
    ``points[i + w*j]`` layout. Sampling uses the marginal-azimuth /
    conditional-elevation factorization (pdf1/cdf1/qf1, pdf2/cdf2/qf2).
    """

    p22: torch.Tensor        # (H=azimuthal, W=elevation)
    sigma: torch.Tensor      # (H, W)
    pdf1: torch.Tensor       # (H,)
    cdf1: torch.Tensor       # (H,)
    qf1_table: torch.Tensor  # (H,)
    pdf2: torch.Tensor       # (H, W)
    cdf2: torch.Tensor       # (H, W)
    qf2_table: torch.Tensor  # (H, W)
    supports_smith_vndf: bool = static_field(default=False)

    # -- eval ----------------------------------------------------------
    def p22_std_theta_phi(self, theta, phi):
        """(dj_brdf.h:2185-2196)."""
        return p22_theta_phi(self.p22, theta, phi)

    # pole/origin guards as in Tabular: sqrt/arccos/atan2 have infinite
    # or 0/0 derivatives exactly where sanitized lanes land (slopes
    # (0, 0), k = up); the floors keep backward finite at <= 1e-12
    # value change
    def p22_std(self, x, y):
        r2 = x * x + y * y
        theta = torch.arctan(torch.sqrt(torch.clamp(r2, min=1e-24)))
        phi = torch.atan2(-y, torch.where(r2 < 1e-24, -1.0, -x))
        return self.p22_std_theta_phi(theta, phi)

    def sigma_std(self, k):
        """(dj_brdf.h:2198-2211)."""
        c = torch.clamp(k[..., 2], -1.0, 1.0)
        theta = torch.atan2(torch.sqrt(torch.clamp(1.0 - c * c, min=1e-24)),
                            c)
        r2 = k[..., 0] * k[..., 0] + k[..., 1] * k[..., 1]
        phi = torch.atan2(k[..., 1], torch.where(r2 < 1e-24, 1.0, k[..., 0]))
        phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
        u1 = theta * 2.0 / math.pi
        u2 = phi * 0.5 / math.pi
        return spline.eval2d(self.sigma, u1, u2, wrap1="edge",
                             wrap2="repeat")

    # -- sampling tables ----------------------------------------------
    def pdf1_eval(self, phi):
        return spline.eval1d(self.pdf1, phi * 0.5 / math.pi, wrap="repeat")

    def cdf1_eval(self, phi):
        return spline.eval1d(self.cdf1, phi * 0.5 / math.pi, wrap="repeat")

    def qf1_eval(self, u1):
        return spline.eval1d(self.qf1_table, u1, wrap="edge") * 2.0 * math.pi

    def pdf2_eval(self, theta, phi):
        val = spline.eval2d(self.pdf2, theta * 2.0 / math.pi,
                            phi * 0.5 / math.pi, wrap1="edge", wrap2="repeat")
        return torch.where(theta >= 0.5 * math.pi, 0.0, val)

    def cdf2_eval(self, theta, phi):
        val = spline.eval2d(self.cdf2, theta * 2.0 / math.pi,
                            phi * 0.5 / math.pi, wrap1="edge", wrap2="repeat")
        return torch.where(theta >= 0.5 * math.pi, 1.0, val)

    def qf2_eval(self, u, phi):
        return spline.eval2d(self.qf2_table, u, phi / (2.0 * math.pi),
                             wrap1="edge", wrap2="repeat") * 0.5 * math.pi

    def sample_vp22_std(self, u1, u2, k):
        """Marginal/conditional nmap sampling (dj_brdf.h:2826-2837)."""
        phi = self.qf1_eval(u1)
        theta = self.qf2_eval(u2, phi)
        tan_theta = torch.tan(theta)
        return -tan_theta * torch.cos(phi), -tan_theta * torch.sin(phi)
