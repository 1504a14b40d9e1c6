"""Structure-of-arrays formulation of the fitting step and of the
renderer's sampling kernels.

The general microfacet path (:mod:`dj_brdf_torch.microfacet.brdf`)
works on (..., 3) direction tensors. The fitting step and the path
tracer's hot loop instead work on plain f32 component arrays: a GGX or
Beckmann + Schlick specialization of evalp (the reference's
F*D*G/(4 o.z) chain, dj_brdf.h:1529-1547), the relative-L2 fitting
loss, its hand-written adjoint, and the fused VNDF sample + importance
weight of the render half (:func:`ggx_evalp_is_soa`,
:func:`beckmann_evalp_is_soa`, :func:`mixed_nee_evalp_is_soa`).

:func:`ggx_lsq_fwdbwd_soa` and :func:`beckmann_lsq_fwdbwd_soa` are the
plain versions of the CUDA fit kernel (``csrc/fused_fit.cu``): the
path a CPU tensor takes, and the oracle the kernel is held against.
The render half was XLA-fused, never a Pallas kernel, in the JAX
package, and is plain torch ops here.

Semantics match ``brdf.evalp(GGX(), Schlick(f0), params, i, o)`` to
f32 rounding, including the horizon/validity gates. Sums run over the
last (sample) axis only, so ``pvec`` rows may carry leading material
axes: a (8, M, 1) ``pvec`` against (M, N) targets gives (M,) losses
and (M, 8) gradients. In the render half ``pvec`` is (8,) for a
uniform material or (8, N) for per-ray parameters.
"""

from __future__ import annotations

import math

import torch

from dj_brdf_torch.core.special import erf, erfinv

_SQRT_PI_INV = 0.5641895835477563  # 1/sqrt(pi)


def _where0(cond, x):
    return torch.where(cond, x, 0.0)


def _half_vector(ix, iy, iz, ox, oy, oz):
    hx, hy, hz = ix + ox, iy + oy, iz + oz
    hn = torch.rsqrt(torch.clamp(hx * hx + hy * hy + hz * hz, min=1e-24))
    return hx * hn, hy * hn, hz * hn


def _smith_g(si, ci, so, co, iz, oz):
    g1i = _where0((ci > 0) & (torch.abs(si) >= 1e-12),
                  iz / torch.where(torch.abs(si) < 1e-12, 1.0, si))
    g1o = _where0((co > 0) & (torch.abs(so) >= 1e-12),
                  oz / torch.where(torch.abs(so) < 1e-12, 1.0, so))
    tmp = g1i * g1o
    den = g1i + g1o - tmp
    return _where0((tmp > 0) & (torch.abs(den) >= 1e-12),
                   tmp / torch.where(torch.abs(den) < 1e-12, 1.0, den))


def _evalp_rgb(pvec, g, d, ox, oy, oz, hx, hy, hz, so, co, iz, with_pdf,
               fresnel_fn):
    """F D G / (4 o.z) from the evalp intermediates, with Schlick from
    ``pvec`` or ``fresnel_fn(cos_d) -> (Fr, Fg, Fb)``; with ``with_pdf``
    also the VNDF sampler's density D / (4 sigma(o)) at (i, o)."""
    cosd = torch.clamp(ox * hx + oy * hy + oz * hz, 0.0, 1.0)
    c1 = 1.0 - cosd
    c2 = c1 * c1
    c5 = c2 * c2 * c1
    oz4 = 4.0 * oz
    base = _where0((g > 0) & (torch.abs(oz4) >= 1e-12),
                   d * g / torch.where(torch.abs(oz4) < 1e-12, 1.0, oz4))
    if fresnel_fn is None:
        rgb = tuple((f0 + c5 * (1.0 - f0)) * base for f0 in pvec[5:8])
    else:
        rgb = tuple(f * base for f in fresnel_fn(cosd))
    if not with_pdf:
        return rgb
    # gates match the sampler's own pdf output (evalp_is): a lane where
    # the VNDF sampler reports pdf 0 (receiver below the warped horizon
    # or Smith-G gated) sees counter-pdf 0 too
    okp = (co > 0) & (so > 1e-12) & (iz > 0) & (g > 0)
    pdf = _where0(okp, 0.25 * d / torch.where(okp, so, 1.0))
    return rgb + (pdf,)


def ggx_evalp_soa(pvec, ix, iy, iz, ox, oy, oz, with_pdf: bool = False,
                  fresnel_fn=None):
    """GGX+Schlick evalp on component arrays.

    ``pvec``: (8,) = [ax, ay, rho, txn, tyn, f0r, f0g, f0b] (already in
    constrained space); rows broadcast, so (8, N) carries per-sample
    parameters. Returns (r, g, b) component arrays; with ``with_pdf``
    also the VNDF sampler's density D/(4 sigma(o)) at (i, o) (reference
    microfacet::pdf, dj_brdf.h:1713-1730), the MIS counter-pdf.
    ``fresnel_fn(cos_d) -> (Fr, Fg, Fb)`` overrides the
    Schlick-from-pvec Fresnel."""
    ax, ay, rho, txn, tyn = pvec[0], pvec[1], pvec[2], pvec[3], pvec[4]
    s = torch.sqrt(torch.clamp(1.0 - rho * rho, min=1e-24))
    inv_ax = 1.0 / ax
    inv_axays = 1.0 / (ax * ay * s)
    ay_rho = ay * rho
    ay_s = ay * s
    hx, hy, hz = _half_vector(ix, iy, iz, ox, oy, oz)

    def sigma(kx, ky, kz):
        # warp + closed-form GGX sigma_std (dj_brdf.h:1620-1631, 2062-2065)
        a = kx * ax + ky * ay_rho
        b = ky * ay_s
        c = kz - kx * txn - ky * tyn
        nrm = torch.sqrt(a * a + b * b + c * c)
        return (nrm + c) * 0.5, c

    si, ci = sigma(ix, iy, iz)
    so, co = sigma(ox, oy, oz)
    g = _smith_g(si, ci, so, co, iz, oz)

    # ndf (dj_brdf.h:1559-1587): slopes, affine warp, GGX p22
    valid_h = hz > 1e-4
    inv_hz = 1.0 / torch.where(valid_h, hz, 1.0)
    sx = -hx * inv_hz - txn
    sy = -hy * inv_hz - tyn
    x_ = sx * inv_ax
    y_ = (ax * sy - ay_rho * sx) * inv_axays
    t1 = 1.0 + (x_ * x_ + y_ * y_)
    inv_hz2 = inv_hz * inv_hz
    d_num = (1.0 / math.pi) * inv_axays * (inv_hz2 * inv_hz2)
    d = _where0(valid_h, d_num / (t1 * t1))
    return _evalp_rgb(pvec, g, d, ox, oy, oz, hx, hy, hz, so, co, iz,
                      with_pdf, fresnel_fn)


def beckmann_evalp_soa(pvec, ix, iy, iz, ox, oy, oz,
                       with_pdf: bool = False, fresnel_fn=None):
    """Beckmann+Schlick evalp on component arrays — the Beckmann
    counterpart of :func:`ggx_evalp_soa` (erf-based sigma_std,
    dj_brdf.h:1871-1879, and Gaussian p22, 1866-1869). ``with_pdf`` and
    ``fresnel_fn`` as there."""
    ax, ay, rho, txn, tyn = pvec[0], pvec[1], pvec[2], pvec[3], pvec[4]
    s = torch.sqrt(torch.clamp(1.0 - rho * rho, min=1e-24))
    inv_ax = 1.0 / ax
    inv_axays = 1.0 / (ax * ay * s)
    ay_rho = ay * rho
    ay_s = ay * s
    hx, hy, hz = _half_vector(ix, iy, iz, ox, oy, oz)

    def sigma(kx, ky, kz):
        a = kx * ax + ky * ay_rho
        b = ky * ay_s
        c = kz - kx * txn - ky * tyn
        q = a * a + b * b + c * c
        inrm = torch.rsqrt(torch.clamp(q, min=1e-24))
        nrm = q * inrm
        c_std = c * inrm
        sin_k = torch.sqrt(torch.clamp(1.0 - c_std * c_std, min=1e-24))
        nu = c_std / torch.clamp(sin_k, min=1e-12)
        sig_std = (c_std * (1.0 + erf(nu))
                   + sin_k * torch.exp(-nu * nu) * _SQRT_PI_INV) * 0.5
        sig_std = torch.where(c_std >= 1.0, 1.0, sig_std)
        return nrm * sig_std, c

    si, ci = sigma(ix, iy, iz)
    so, co = sigma(ox, oy, oz)
    g = _smith_g(si, ci, so, co, iz, oz)

    valid_h = hz > 1e-4
    inv_hz = 1.0 / torch.where(valid_h, hz, 1.0)
    sx = -hx * inv_hz - txn
    sy = -hy * inv_hz - tyn
    x_ = sx * inv_ax
    y_ = (ax * sy - ay_rho * sx) * inv_axays
    r2 = x_ * x_ + y_ * y_
    inv_hz2 = inv_hz * inv_hz
    d = _where0(valid_h, (1.0 / math.pi) * inv_axays * (inv_hz2 * inv_hz2)
                * torch.exp(-r2))
    return _evalp_rgb(pvec, g, d, ox, oy, oz, hx, hy, hz, so, co, iz,
                      with_pdf, fresnel_fn)


def raw_to_pvec(raw):
    """RawFit (unconstrained, see fit.lsq) -> constrained pvec: (8,),
    or (..., 8) for RawFit leaves with leading material axes."""
    return torch.stack([
        torch.exp(raw.log_ax) + 1e-4,
        torch.exp(raw.log_ay) + 1e-4,
        0.99 * torch.tanh(raw.raw_rho),
        raw.txn, raw.tyn,
        torch.sigmoid(raw.logit_f0[..., 0]),
        torch.sigmoid(raw.logit_f0[..., 1]),
        torch.sigmoid(raw.logit_f0[..., 2]),
    ], dim=-1)


def _lsq_loss(rgb, tr, tg, tb, eps):
    r, g, b = rgb
    lr = (r - tr) / (tr + eps)
    lg = (g - tg) / (tg + eps)
    lb = (b - tb) / (tb + eps)
    return ((lr * lr).mean(-1) + (lg * lg).mean(-1)
            + (lb * lb).mean(-1)) / 3.0


def ggx_lsq_loss_soa(pvec, ix, iy, iz, ox, oy, oz, tr, tg, tb,
                     eps: float = 1e-2):
    """Relative-L2 fitting loss on component arrays (mean over samples
    and channels, matching fit.lsq.relative_l2)."""
    return _lsq_loss(ggx_evalp_soa(pvec, ix, iy, iz, ox, oy, oz),
                     tr, tg, tb, eps)


def beckmann_lsq_loss_soa(pvec, ix, iy, iz, ox, oy, oz, tr, tg, tb,
                          eps: float = 1e-2):
    """Beckmann counterpart of :func:`ggx_lsq_loss_soa`."""
    return _lsq_loss(beckmann_evalp_soa(pvec, ix, iy, iz, ox, oy, oz),
                     tr, tg, tb, eps)


def split_dirs(i, o):
    """(..., 3) pairs -> component arrays."""
    return (i[..., 0], i[..., 1], i[..., 2],
            o[..., 0], o[..., 1], o[..., 2])


def _clip_u(u):
    return torch.clamp(u, 0.0, 1.0) * 0.99998 + 0.00001


def _schlick(pvec, cosd, fresnel_fn):
    if fresnel_fn is not None:
        return fresnel_fn(cosd)
    c1 = 1.0 - cosd
    c2 = c1 * c1
    c5 = c2 * c2 * c1
    return tuple(f0 + c5 * (1.0 - f0) for f0 in pvec[5:8])


def _reflect(ox, oy, oz, tx_m, ty_m, ax, ay, rho, s, txn, tyn):
    """Cholesky unwarp + mean-normal offset of the sampled standard
    slopes (dj_brdf.h:1697-1703), the half vector, and o reflected
    about it; the warped slopes are h's slope coordinates."""
    tx_h = ax * tx_m + txn
    ty_h = ay * (rho * tx_m + s * ty_m) + tyn
    q_h = tx_h * tx_h + ty_h * ty_h + 1.0
    hn = torch.rsqrt(q_h)
    hx, hy, hz = -tx_h * hn, -ty_h * hn, hn
    oh = ox * hx + oy * hy + oz * hz
    ix = 2.0 * oh * hx - ox
    iy = 2.0 * oh * hy - oy
    iz = 2.0 * oh * hz - oz
    return ix, iy, iz, q_h, oh


def _is_weight(pvec, fresnel_fn, iz, sig_i, c_i, oz, sig_o, c_o, valid,
               oh, d_):
    """Smith G1s, the importance weight F G / G1o = F g1i / den
    (dj_brdf.h:1760) and the pdf D / (4 sigma(o)) of the fused
    samplers."""
    ok_i = (c_i > 0) & (torch.abs(sig_i) >= 1e-12)
    ok_o = (c_o > 0) & (torch.abs(sig_o) >= 1e-12)
    g1i = _where0(ok_i, iz * (1.0 / torch.where(ok_i, sig_i, 1.0)))
    g1o = _where0(ok_o, oz * (1.0 / torch.where(ok_o, sig_o, 1.0)))
    tmp = g1i * g1o
    den = g1i + g1o - tmp
    ok_g = (tmp > 0) & (torch.abs(den) >= 1e-12)
    inv_den = _where0(ok_g, 1.0 / torch.where(ok_g, den, 1.0))

    w_s = g1i * inv_den
    cosd = torch.clamp(oh, 0.0, 1.0)
    ok = valid & ok_g & (tmp * inv_den > 0.0)
    w_s = _where0(ok, w_s)
    fr, fg, fb = _schlick(pvec, cosd, fresnel_fn)
    ok_p = ok & (oh > 0.0) & (torch.abs(sig_o) >= 1e-12)
    pdf = _where0(ok_p, 0.25 * d_ * (1.0 / torch.where(ok_p, sig_o, 1.0)))
    return fr * w_s, fg * w_s, fb * w_s, pdf


def _up_where_invalid(valid, ix, iy, iz):
    zero = torch.zeros_like(ix)
    return (torch.where(valid, ix, zero), torch.where(valid, iy, zero),
            torch.where(valid, iz, torch.ones_like(iz)))


def _radial_frame(kx, ky, sin_k, tx, ty):
    """Rotate radial-frame slopes into the azimuthal frame of k
    (dj_brdf.h:1830-1842)."""
    ni = sin_k <= 1e-9  # floored sqrt: exact normal incidence reads
    #   1e-12, never 0; an == 0 test would go dead and zero the frame
    nrm = torch.rsqrt(torch.clamp(kx * kx + ky * ky, min=1e-24))
    cos_pk = torch.where(ni, 1.0, kx * nrm)
    sin_pk = torch.where(ni, 0.0, ky * nrm)
    return cos_pk * tx - sin_pk * ty, sin_pk * tx + cos_pk * ty


def _caps_slopes(u1, u2, kx, ky, kz):
    """Spherical-cap VNDF sampling (arXiv:2306.05044): standard-frame
    slopes directly."""
    phi = (2.0 * math.pi) * u1
    z = (1.0 - u2) * (1.0 + kz) - kz
    sin_t = torch.sqrt(torch.clamp(1.0 - z * z, 0.0, 1.0))
    inv_hz_c = 1.0 / torch.clamp(z + kz, min=1e-12)
    return (-(sin_t * torch.cos(phi) + kx) * inv_hz_c,
            -(sin_t * torch.sin(phi) + ky) * inv_hz_c)


def ggx_evalp_is_soa(pvec, u1, u2, ox, oy, oz, caps: bool = True,
                     fresnel_fn=None):
    """Fused GGX VNDF sample + importance-sampled eval on component
    arrays: one pass produces (wr, wg, wb, ix, iy, iz, pdf), the SoA
    equivalent of ``brdf.evalp_is(GGX*(), Schlick(f0), params, ...)``
    (reference microfacet::evalp_is, dj_brdf.h:1734-1765).

    ``caps=True`` samples via the spherical-cap construction
    (GGXSphericalCaps — identical VNDF); ``caps=False`` uses the
    reference's closed-form qf2 + rational qf3 (dj_brdf.h:2089-2146).
    For receivers below the mean-normal horizon (warped o.z <= 0) this
    returns weight = pdf = 0 and i = +z."""
    from dj_brdf_torch.microfacet.ndf import GGX

    ax, ay, rho = pvec[0], pvec[1], pvec[2]
    txn, tyn = pvec[3], pvec[4]
    s = torch.sqrt(torch.clamp(1.0 - rho * rho, min=1e-24))
    inv_axays = 1.0 / (ax * ay * s)
    u1, u2 = _clip_u(u1), _clip_u(u2)

    # receiver warp into the standard frame (dj_brdf.h:1686-1689);
    # |warp(o)| recurs as sigma(o) = (nrm + c)/2
    a_o = ox * ax + oy * ay * rho
    b_o = oy * ay * s
    c_o = oz - ox * txn - oy * tyn
    q_o = a_o * a_o + b_o * b_o + c_o * c_o
    inrm_o = torch.rsqrt(torch.clamp(q_o, min=1e-24))
    kx, ky, kz = a_o * inrm_o, b_o * inrm_o, c_o * inrm_o
    valid = kz > 0.0
    sig_o = (q_o * inrm_o + c_o) * 0.5

    if caps:
        tx_m, ty_m = _caps_slopes(u1, u2, kx, ky, kz)
    else:
        g = GGX()
        sin_k = torch.sqrt(torch.clamp(1.0 - kz * kz, min=1e-24))
        tx = g.qf2_radial(u1, kz, sin_k)
        ty = g.qf3_radial(u2, tx)
        tx_m, ty_m = _radial_frame(kx, ky, sin_k, tx, ty)

    ix, iy, iz, q_h, oh = _reflect(ox, oy, oz, tx_m, ty_m, ax, ay, rho, s,
                                   txn, tyn)
    # sigma(i) for the Smith GAF
    a_i = ix * ax + iy * ay * rho
    b_i = iy * ay * s
    c_i = iz - ix * txn - iy * tyn
    q_i = a_i * a_i + b_i * b_i + c_i * c_i
    inrm_i = torch.rsqrt(torch.clamp(q_i, min=1e-24))
    sig_i = (q_i * inrm_i + c_i) * 0.5

    # pdf = vndf(o) / (4 cosd) = D / (4 sigma(o)): the <o,h> factors
    # cancel, and 1/cos^4(theta_h) = q_h^2 (h was built from slopes)
    t1_m = 1.0 + tx_m * tx_m + ty_m * ty_m
    inv_t1m = 1.0 / t1_m
    d_ = ((1.0 / math.pi) * inv_axays) * q_h * q_h * (inv_t1m * inv_t1m)
    wr, wg, wb, pdf = _is_weight(pvec, fresnel_fn, iz, sig_i, c_i, oz,
                                 sig_o, c_o, valid, oh, d_)
    return (wr, wg, wb, *_up_where_invalid(valid, ix, iy, iz), pdf)


def _sigma_beck(c_std, nrm):
    """nrm * sigma_std_radial(c_std) (dj_brdf.h:1871-1879)."""
    sin_k = torch.sqrt(torch.clamp(1.0 - c_std * c_std, min=1e-24))
    nu = c_std * (1.0 / torch.clamp(sin_k, min=1e-12))
    sig_std = (c_std * (1.0 + erf(nu))
               + sin_k * torch.exp(-nu * nu) * _SQRT_PI_INV) * 0.5
    return nrm * torch.where(c_std >= 1.0, 1.0, sig_std)


def beckmann_evalp_is_soa(pvec, u1, u2, ox, oy, oz, fresnel_fn=None):
    """Fused Beckmann VNDF sample + importance-sampled eval on
    component arrays (reference microfacet::evalp_is
    dj_brdf.h:1734-1765 with beckmann::qf2 1897-1952). Same contract
    as :func:`ggx_evalp_is_soa`; Beckmann differs in the visible-slope
    solver (the slope-space Halley solve of
    ``ndf.beckmann_qf2_slope_domain``) and the erf-based sigma_std. The
    receiver's erf(cot) / e^{-cot^2} pair is computed once and shared
    between sigma_std(o) and the solver's CDF normalization."""
    from dj_brdf_torch.microfacet.ndf import beckmann_qf2_slope_domain

    ax, ay, rho = pvec[0], pvec[1], pvec[2]
    txn, tyn = pvec[3], pvec[4]
    s = torch.sqrt(torch.clamp(1.0 - rho * rho, min=1e-24))
    inv_axays = 1.0 / (ax * ay * s)
    u1, u2 = _clip_u(u1), _clip_u(u2)

    def warp(kx, ky, kz):
        a = kx * ax + ky * ay * rho
        b = ky * ay * s
        c = kz - kx * txn - ky * tyn
        q = a * a + b * b + c * c
        return a, b, c, q, torch.rsqrt(torch.clamp(q, min=1e-24))

    a_o, b_o, c_o, q_o, inrm_o = warp(ox, oy, oz)
    kx, ky, kz = a_o * inrm_o, b_o * inrm_o, c_o * inrm_o
    valid = kz > 0.0

    # receiver cot terms, shared by sigma_std(o) and the slope solver
    # (below-horizon lanes produce gated garbage either way)
    sin_k = torch.sqrt(torch.clamp(1.0 - kz * kz, min=1e-24))
    safe_sin = torch.clamp(sin_k, min=1e-12)
    safe_cos = torch.clamp(kz, min=1e-12)
    cot = safe_cos * (1.0 / safe_sin)
    tan = sin_k * (1.0 / safe_cos)
    erf_cot = erf(cot)
    e_cot2 = torch.exp(-cot * cot)
    sig_std_o = (kz * (1.0 + erf_cot) + sin_k * e_cot2 * _SQRT_PI_INV) * 0.5
    sig_o = (q_o * inrm_o) * torch.where(kz >= 1.0, 1.0, sig_std_o)

    tx = beckmann_qf2_slope_domain(u1, kz, sin_k,
                                   shared=(cot, tan, erf_cot, e_cot2))
    ty = erfinv(2.0 * torch.clamp(u2, min=1e-6) - 1.0)
    tx_m, ty_m = _radial_frame(kx, ky, sin_k, tx, ty)

    ix, iy, iz, q_h, oh = _reflect(ox, oy, oz, tx_m, ty_m, ax, ay, rho, s,
                                   txn, tyn)
    a_i, b_i, c_i, q_i, inrm_i = warp(ix, iy, iz)
    sig_i = _sigma_beck(c_i * inrm_i, q_i * inrm_i)

    # pdf = D / (4 sigma(o)); Beckmann p22_std = e^{-r^2}/pi
    r2_m = tx_m * tx_m + ty_m * ty_m
    d_ = ((1.0 / math.pi) * inv_axays) * q_h * q_h * torch.exp(-r2_m)
    wr, wg, wb, pdf = _is_weight(pvec, fresnel_fn, iz, sig_i, c_i, oz,
                                 sig_o, c_o, valid, oh, d_)
    return (wr, wg, wb, *_up_where_invalid(valid, ix, iy, iz), pdf)


def mixed_nee_evalp_is_soa(pvec, is_beck, lx, ly, lz, u1, u2, ox, oy, oz,
                           caps: bool = False, with_nee: bool = True,
                           with_nee_pdf: bool = False, fresnel_fn=None):
    """Dual-family fused NEE evalp + VNDF sample + IS weight for
    per-ray GGX/Beckmann dispatch — the mixed-material path tracer's
    bounce body.

    Everything family-independent (the receiver/light/sample warps,
    half vector, reflection, Smith G, Fresnel, the D/(4 sigma) pdf) is
    computed once; only three distribution-specific terms select per
    lane on ``is_beck``: sigma_std (the Beckmann erf form,
    dj_brdf.h:1871-1879, vs the GGX closed form, 2062-2065), p22_std
    (e^{-r^2}/pi vs 1/(pi (1+r^2)^2)), and the visible-slope quantiles
    (the slope-space Halley solve vs GGX's closed-form qf2 + rational
    qf3, 2089-2146, or the spherical caps with ``caps``). ``pvec``:
    (8,) or per-ray (8, N); ``is_beck``: bool mask. Returns (fr, fg,
    fb, wr, wg, wb, ix, iy, iz, pdf); ``with_nee=False`` skips the NEE
    eval and returns the last 7 only (the path tracer's
    spp-deduplicated first bounce evaluates NEE once per pixel);
    ``with_nee_pdf`` also returns the VNDF sampler's density at the NEE
    direction after (fr, fg, fb), the MIS counter-pdf of environment
    lighting: (fr, fg, fb, pdf_nee, wr, wg, wb, ix, iy, iz, pdf)."""
    from dj_brdf_torch.microfacet.ndf import GGX, beckmann_qf2_slope_domain

    ax, ay, rho = pvec[0], pvec[1], pvec[2]
    txn, tyn = pvec[3], pvec[4]
    s = torch.sqrt(torch.clamp(1.0 - rho * rho, min=1e-24))
    inv_ax = 1.0 / ax
    inv_axays = 1.0 / (ax * ay * s)
    ay_rho = ay * rho
    ay_s = ay * s

    def p22_sel(r2):
        t1 = 1.0 + r2
        return torch.where(is_beck, torch.exp(-r2), 1.0 / (t1 * t1)) / math.pi

    def warp_sigma(kx, ky, kz, with_shared: bool = False):
        """warp + family-selected sigma; with ``with_shared`` also the
        (sin_k, nu, tan_nu, erf_nu, e_nu2) terms the Beckmann slope
        solver reuses (the same transcendentals as its sigma_std)."""
        a = kx * ax + ky * ay_rho
        b = ky * ay_s
        c = kz - kx * txn - ky * tyn
        q = a * a + b * b + c * c
        inrm = torch.rsqrt(torch.clamp(q, min=1e-24))
        nrm = q * inrm
        c_std = c * inrm
        sin_k = torch.sqrt(torch.clamp(1.0 - c_std * c_std, min=1e-24))
        nu = c_std * (1.0 / torch.clamp(sin_k, min=1e-12))
        erf_nu = erf(nu)
        e_nu2 = torch.exp(-nu * nu)
        sig_beck = (c_std * (1.0 + erf_nu)
                    + sin_k * e_nu2 * _SQRT_PI_INV) * 0.5
        sig_beck = torch.where(c_std >= 1.0, 1.0, sig_beck)
        sig = torch.where(is_beck, nrm * sig_beck, (nrm + c) * 0.5)
        if with_shared:
            tan_nu = sin_k * (1.0 / torch.clamp(c_std, min=1e-12))
            return sig, c, a, b, inrm, (sin_k, nu, tan_nu, erf_nu, e_nu2)
        return sig, c, a, b, inrm

    def g1(kz_w, sig, c):
        ok = (c > 0) & (torch.abs(sig) >= 1e-12)
        return _where0(ok, kz_w * (1.0 / torch.where(ok, sig, 1.0)))

    # shared receiver terms (+ the cot pieces the Beckmann solver reuses)
    sig_o, c_o, a_o, b_o, inrm_o, shared_o = warp_sigma(
        ox, oy, oz, with_shared=True)
    g1o = g1(oz, sig_o, c_o)

    if with_nee:
        # ---- NEE evalp at the light direction (F D G / (4 o.z)) ----
        sig_l, c_l, _, _, _ = warp_sigma(lx, ly, lz)
        g1l = g1(lz, sig_l, c_l)
        tmp_n = g1l * g1o
        den_n = g1l + g1o - tmp_n
        ok_n = (tmp_n > 0) & (torch.abs(den_n) >= 1e-12)
        g_nee = _where0(ok_n, tmp_n * (1.0 / torch.where(ok_n, den_n, 1.0)))

        hx_n, hy_n, hz_n = lx + ox, ly + oy, lz + oz
        hn_n = torch.rsqrt(torch.clamp(
            hx_n * hx_n + hy_n * hy_n + hz_n * hz_n, min=1e-24))
        hx_n, hy_n, hz_n = hx_n * hn_n, hy_n * hn_n, hz_n * hn_n
        valid_h = hz_n > 1e-4
        inv_hz = 1.0 / torch.where(valid_h, hz_n, 1.0)
        sx = -hx_n * inv_hz - txn
        sy = -hy_n * inv_hz - tyn
        x_ = sx * inv_ax
        y_ = (ax * sy - ay_rho * sx) * inv_axays
        inv_hz2 = inv_hz * inv_hz
        d_nee = _where0(valid_h, inv_axays * (inv_hz2 * inv_hz2)
                        * p22_sel(x_ * x_ + y_ * y_))
        cosd_n = torch.clamp(ox * hx_n + oy * hy_n + oz * hz_n, 0.0, 1.0)
        fr_n, fg_n, fb_n = _schlick(pvec, cosd_n, fresnel_fn)
        oz4 = 4.0 * oz
        ok_b = (g_nee > 0) & (torch.abs(oz4) >= 1e-12)
        base = _where0(ok_b, d_nee * g_nee
                       * (1.0 / torch.where(ok_b, oz4, 1.0)))
        nee = (fr_n * base, fg_n * base, fb_n * base)
        if with_nee_pdf:
            # D(h) / (4 sigma(o)) at the light direction (dj_brdf.h:
            # 1713-1730); the g_nee gate mirrors the sampler's own pdf
            # gating, so the two MIS weights sum to 1 at edge lanes
            okp = ((c_o > 0) & (torch.abs(sig_o) >= 1e-12) & valid_h
                   & (lz > 0) & (g_nee > 0))
            nee = nee + (_where0(okp, 0.25 * d_nee
                                 * (1.0 / torch.where(okp, sig_o, 1.0))),)

    # ---- VNDF sample + IS weight -----------------------------------
    u1, u2 = _clip_u(u1), _clip_u(u2)
    kx, ky, kz = a_o * inrm_o, b_o * inrm_o, c_o * inrm_o
    valid = kz > 0.0
    sin_k, nu_o, tan_o, erf_nu_o, e_nu2_o = shared_o

    # slope quantiles: slope-space Halley (Beckmann, reusing the
    # receiver-sigma transcendentals) vs closed form / caps (GGX)
    tx_b = beckmann_qf2_slope_domain(
        u1, kz, sin_k, shared=(nu_o, tan_o, erf_nu_o, e_nu2_o))
    ty_b = erfinv(2.0 * torch.clamp(u2, min=1e-6) - 1.0)
    tx_mb, ty_mb = _radial_frame(kx, ky, sin_k, tx_b, ty_b)
    if caps:
        tx_mg, ty_mg = _caps_slopes(u1, u2, kx, ky, kz)
    else:
        g = GGX()
        tx_g = g.qf2_radial(u1, kz, sin_k)
        ty_g = g.qf3_radial(u2, tx_g)
        tx_mg, ty_mg = _radial_frame(kx, ky, sin_k, tx_g, ty_g)
    tx_m = torch.where(is_beck, tx_mb, tx_mg)
    ty_m = torch.where(is_beck, ty_mb, ty_mg)

    ix, iy, iz, q_h, oh = _reflect(ox, oy, oz, tx_m, ty_m, ax, ay, rho, s,
                                   txn, tyn)
    sig_i, c_i, _, _, _ = warp_sigma(ix, iy, iz)
    d_ = inv_axays * q_h * q_h * p22_sel(tx_m * tx_m + ty_m * ty_m)
    wr, wg, wb, pdf = _is_weight(pvec, fresnel_fn, iz, sig_i, c_i, oz,
                                 sig_o, c_o, valid, oh, d_)
    out = (wr, wg, wb, *_up_where_invalid(valid, ix, iy, iz), pdf)
    return nee + out if with_nee else out


def _lsq_fwdbwd(pvec, ix, iy, iz, ox, oy, oz, tr, tg, tb, eps, beckmann):
    """The hand adjoint shared by both families; see
    :func:`ggx_lsq_fwdbwd_soa`. Only sigma(k) and the p22 factor of D
    differ between them."""
    ax, ay, rho = pvec[0], pvec[1], pvec[2]
    txn, tyn = pvec[3], pvec[4]
    f0r, f0g, f0b = pvec[5], pvec[6], pvec[7]

    s = torch.sqrt(torch.clamp(1.0 - rho * rho, min=1e-24))
    inv_ax = 1.0 / ax
    inv_ay = 1.0 / ay
    inv_s = 1.0 / s
    inv_axays = inv_ax * inv_ay * inv_s
    ay_rho = ay * rho
    ay_s = ay * s
    hx, hy, hz = _half_vector(ix, iy, iz, ox, oy, oz)

    def sigma(kx, ky, kz):
        a = kx * ax + ky * ay_rho
        b = ky * ay_s
        c = kz - kx * txn - ky * tyn
        q = a * a + b * b + c * c
        inv_nrm = torch.rsqrt(torch.clamp(q, min=1e-24))
        nrm = q * inv_nrm
        if not beckmann:
            return (nrm + c) * 0.5, (a, b, c, inv_nrm)
        c_std = c * inv_nrm
        sin2 = torch.clamp(1.0 - c_std * c_std, min=1e-24)
        sin_k = torch.sqrt(sin2)
        nu = c_std * (1.0 / torch.clamp(sin_k, min=1e-12))
        e_nu2 = torch.exp(-nu * nu)
        half_1pe = 0.5 * (1.0 + erf(nu))
        f = c_std * half_1pe + 0.5 * sin_k * e_nu2 * _SQRT_PI_INV
        f = torch.where(c_std >= 1.0, 1.0, f)
        # f'(c_std); ->1 smoothly at normal incidence
        fp = half_1pe - 0.5 * nu * e_nu2 * _SQRT_PI_INV
        return nrm * f, (a, b, c, inv_nrm, c_std, sin2, f, fp)

    si, res_i = sigma(ix, iy, iz)
    so, res_o = sigma(ox, oy, oz)
    ok_i = (res_i[2] > 0) & (torch.abs(si) >= 1e-12)
    ok_o = (res_o[2] > 0) & (torch.abs(so) >= 1e-12)
    inv_si = _where0(ok_i, 1.0 / torch.where(ok_i, si, 1.0))
    inv_so = _where0(ok_o, 1.0 / torch.where(ok_o, so, 1.0))
    g1i = iz * inv_si
    g1o = oz * inv_so
    tmp = g1i * g1o
    den = g1i + g1o - tmp
    ok_g = (tmp > 0) & (torch.abs(den) >= 1e-12)
    inv_den = _where0(ok_g, 1.0 / torch.where(ok_g, den, 1.0))
    g = tmp * inv_den

    valid_h = hz > 1e-4
    inv_hz = 1.0 / torch.where(valid_h, hz, 1.0)
    sx = -hx * inv_hz - txn
    sy = -hy * inv_hz - tyn
    u = sx * inv_ax
    v = sy * inv_ay
    y_ = (v - rho * u) * inv_s
    r2 = u * u + y_ * y_
    inv_hz2 = inv_hz * inv_hz
    if beckmann:
        p22 = torch.exp(-r2)
        q4 = 2.0        # Gaussian p22: dlogD/dr^2 = -1
    else:
        inv_t1 = 1.0 / (1.0 + r2)
        p22 = inv_t1 * inv_t1
        q4 = 4.0 * inv_t1
    d = _where0(valid_h, ((1.0 / math.pi) * inv_axays)
                * (inv_hz2 * inv_hz2) * p22)

    cosd = torch.clamp(ox * hx + oy * hy + oz * hz, 0.0, 1.0)
    c1 = 1.0 - cosd
    c2 = c1 * c1
    c5 = c2 * c2 * c1

    oz4 = 4.0 * oz
    ok_b = (g > 0) & (torch.abs(oz4) >= 1e-12)
    inv_oz4 = _where0(ok_b, 1.0 / torch.where(ok_b, oz4, 1.0))
    base = d * g * inv_oz4

    # --- loss (per-sample mean over channels) + upstream weights
    third = 1.0 / 3.0
    inv_tr = 1.0 / (tr + eps)
    inv_tg = 1.0 / (tg + eps)
    inv_tb = 1.0 / (tb + eps)
    Fr = f0r + c5 * (1.0 - f0r)
    Fg = f0g + c5 * (1.0 - f0g)
    Fb = f0b + c5 * (1.0 - f0b)
    rr = (Fr * base - tr) * inv_tr
    rg = (Fg * base - tg) * inv_tg
    rb = (Fb * base - tb) * inv_tb
    loss_sum = third * (rr * rr + rg * rg + rb * rb).sum(-1)

    wr = (2.0 * third) * rr * inv_tr        # dL/dpred_c
    wg = (2.0 * third) * rg * inv_tg
    wb = (2.0 * third) * rb * inv_tb

    one_m_c5_base = (1.0 - c5) * base
    g_f0 = [(w * one_m_c5_base).sum(-1) for w in (wr, wg, wb)]

    gbase = wr * Fr + wg * Fg + wb * Fb
    gd = gbase * g * inv_oz4                # dL/dD (inv_oz4 gates)
    gg = gbase * d * inv_oz4                # dL/dG

    # --- G path: dG/dg1 = (other/den)^2; dg1/dsigma = -g1/sigma
    gsig_i = -gg * (g1o * inv_den) ** 2 * g1i * inv_si
    gsig_o = -gg * (g1i * inv_den) ** 2 * g1o * inv_so

    def sigma_bwd(gsig, res, kx, ky):
        if beckmann:
            # sigma = nrm * f(c/nrm): d/da = (a/nrm)(f - f' c_std);
            # d/db likewise; d/dc = c_std f + f' sin^2
            a, b, c, inv_nrm, c_std, sin2, f, fp = res
            rad = f - fp * c_std
            da = gsig * a * inv_nrm * rad
            db = gsig * b * inv_nrm * rad
            dc = gsig * (c_std * f + fp * sin2)
        else:
            a, b, c, inv_nrm = res
            da = 0.5 * gsig * a * inv_nrm
            db = 0.5 * gsig * b * inv_nrm
            dc = 0.5 * gsig * (c * inv_nrm + 1.0)
        return (da * kx, ky * (da * rho + db * s),
                ky * ay * (da - db * rho * inv_s), -dc * kx, -dc * ky)

    g_i = sigma_bwd(gsig_i, res_i, ix, iy)
    g_o = sigma_bwd(gsig_o, res_o, ox, oy)

    # --- D path: dD/dp = D * (-dlog(ax ay s)/dp - (q4/2) dr^2/dp)
    S = gd * d
    g_d = (S * inv_ax * (q4 * (u * u - y_ * rho * u * inv_s) - 1.0),
           S * inv_ay * (q4 * y_ * v * inv_s - 1.0),
           S * (rho * (inv_s * inv_s)
                - q4 * y_ * (y_ * rho * (inv_s * inv_s) - u * inv_s)),
           S * q4 * inv_ax * (u - y_ * rho * inv_s),
           S * q4 * inv_ay * inv_s * y_)

    grad = [(a + b + c).sum(-1) for a, b, c in zip(g_i, g_o, g_d)]
    return loss_sum, torch.stack(grad + g_f0, dim=-1)


def ggx_lsq_fwdbwd_soa(pvec, ix, iy, iz, ox, oy, oz, tr, tg, tb,
                       eps: float = 1e-2):
    """Hand-written forward + adjoint of the GGX fitting loss.

    Returns ``(loss_sum, grad(8,))`` where ``loss_sum`` is the
    per-sample channel-mean loss *summed* over samples and ``grad`` is
    its exact derivative w.r.t. ``pvec``. Dividing both by the sample
    count reproduces :func:`ggx_lsq_loss_soa` and its autograd
    gradient (tested); every backward term reuses a forward
    intermediate, which is what lets the CUDA kernel do the whole step
    in one pass over the samples.

    All gates mirror :func:`ggx_evalp_soa` exactly; gated-out samples
    contribute exactly zero to every gradient component.
    """
    return _lsq_fwdbwd(pvec, ix, iy, iz, ox, oy, oz, tr, tg, tb, eps,
                       beckmann=False)


def beckmann_lsq_fwdbwd_soa(pvec, ix, iy, iz, ox, oy, oz, tr, tg, tb,
                            eps: float = 1e-2):
    """Hand-written forward + adjoint of the Beckmann fitting loss —
    the Beckmann half of the reference's co-equal fit pair
    (fit_beckmann_parameters dj_brdf.h:3133-3158). Same contract as
    :func:`ggx_lsq_fwdbwd_soa`.

    The two derivative novelties vs the GGX adjoint:

    * D path: Gaussian p22 means dlogD/dr^2 = -1 (vs -2/(1+r^2)), so
      the identical slope-chain code runs with the constant q4 = 2 in
      place of GGX's 4/(1+r^2).
    * sigma path: sigma = |warp(k)| * f(c_std) with
      f = sigma_std_beckmann; f'(t) = (1+erf nu)/2 - nu e^{-nu^2} /
      (2 sqrt(pi)) (nu = cot theta) — both transcendentals are the
      forward's own erf/exp terms.
    """
    return _lsq_fwdbwd(pvec, ix, iy, iz, ox, oy, oz, tr, tg, tb, eps,
                       beckmann=True)
