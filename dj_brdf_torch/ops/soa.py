"""Structure-of-arrays formulation of the fitting step.

The general microfacet path (:mod:`dj_brdf_torch.microfacet.brdf`)
works on (..., 3) direction tensors. The fitting step instead works on
plain f32 component arrays: a GGX or Beckmann + Schlick specialization
of evalp (the reference's F*D*G/(4 o.z) chain, dj_brdf.h:1529-1547),
the relative-L2 fitting loss, and its hand-written adjoint.

:func:`ggx_lsq_fwdbwd_soa` and :func:`beckmann_lsq_fwdbwd_soa` are the
plain versions of the CUDA fit kernel (``csrc/fused_fit.cu``): the
path a CPU tensor takes, and the oracle the kernel is held against.

Semantics match ``brdf.evalp(GGX(), Schlick(f0), params, i, o)`` to
f32 rounding, including the horizon/validity gates. Sums run over the
last (sample) axis only, so ``pvec`` rows may carry leading material
axes: a (8, M, 1) ``pvec`` against (M, N) targets gives (M,) losses
and (M, 8) gradients.
"""

from __future__ import annotations

import math

import torch

from dj_brdf_torch.core.special import erf

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


def _schlick_rgb(pvec, g, d, ox, oy, oz, hx, hy, hz):
    cosd = torch.clamp(ox * hx + oy * hy + oz * hz, 0.0, 1.0)
    c1 = 1.0 - cosd
    c2 = c1 * c1
    c5 = c2 * c2 * c1
    oz4 = 4.0 * oz
    base = _where0((g > 0) & (torch.abs(oz4) >= 1e-12),
                   d * g / torch.where(torch.abs(oz4) < 1e-12, 1.0, oz4))
    return tuple((f0 + c5 * (1.0 - f0)) * base for f0 in pvec[5:8])


def ggx_evalp_soa(pvec, ix, iy, iz, ox, oy, oz):
    """GGX+Schlick evalp on component arrays.

    ``pvec``: (8,) = [ax, ay, rho, txn, tyn, f0r, f0g, f0b] (already in
    constrained space); rows broadcast, so (8, N) carries per-sample
    parameters. Returns (r, g, b) component arrays."""
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

    g = _smith_g(*sigma(ix, iy, iz), *sigma(ox, oy, oz), iz, oz)

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
    return _schlick_rgb(pvec, g, d, ox, oy, oz, hx, hy, hz)


def beckmann_evalp_soa(pvec, ix, iy, iz, ox, oy, oz):
    """Beckmann+Schlick evalp on component arrays — the Beckmann
    counterpart of :func:`ggx_evalp_soa` (erf-based sigma_std,
    dj_brdf.h:1871-1879, and Gaussian p22, 1866-1869)."""
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

    g = _smith_g(*sigma(ix, iy, iz), *sigma(ox, oy, oz), iz, oz)

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
    return _schlick_rgb(pvec, g, d, ox, oy, oz, hx, hy, hz)


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
