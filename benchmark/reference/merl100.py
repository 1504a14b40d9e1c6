"""Plain reference of the ``merl100`` configuration: the MERL database's
inputs, its lookup, the GGX + Schlick fit and the isotropic tabulation.

Plain PyTorch, written for the benchmark from the published formulas
(Matusik et al. 2003 for the table layout; the reference C++ library's
``djb::merl``, ``djb::microfacet`` and ``djb::tabular`` for the warps,
the microfacet BRDF and the tabulation pipeline). It imports nothing of
the program, works every derived quantity out again from the inputs
the benchmark makes, and takes a ``dtype`` so that the same code gives
the reference (float64, float32 where the configuration fixes a
float32 stage) and the control (bfloat16, one precision below the
configuration's float32).

TF32 plays no part here (no matrix product runs in float32 outside the
power iteration, which is float64), and the callers turn it off.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RES_TH, RES_TD, RES_PD = 90, 90, 180          # theta_h, theta_d, phi_d bins
PLANE = RES_TH * RES_TD * RES_PD
#: the per-channel radiometric scales of the MERL format
SCALES = (1.00 / 1500.0, 1.15 / 1500.0, 1.66 / 1500.0)


def _lower(dtype):
    """The precision of the float64 stages when ``dtype`` is the
    control's: float32 below float64."""
    return torch.float32 if dtype == torch.bfloat16 else torch.float64


# -- inputs ----------------------------------------------------------

def database_params(n: int, alpha_range, f0_range, generator, device):
    """``n`` isotropic GGX + Schlick materials: alpha uniform in
    ``alpha_range`` and each f0 channel uniform in ``f0_range``."""
    a_lo, a_hi = alpha_range
    f_lo, f_hi = f0_range
    u = torch.rand((n, 4), generator=generator, device=device,
                   dtype=torch.float32)
    return a_lo + (a_hi - a_lo) * u[:, 0], f_lo + (f_hi - f_lo) * u[:, 1:]


def bin_centre_directions(device):
    """(i, o), each (90, 90, 180, 3) float32: the directions at the
    centre of every MERL bin (theta_h warped by its square root, theta_d
    and phi_d uniform), with phi_h = 0."""
    ih = torch.arange(RES_TH, dtype=torch.float64, device=device)
    theta_h = ((ih + 0.5) ** 2 / RES_TH) * (math.pi / 2) / RES_TH
    theta_d = (torch.arange(RES_TD, dtype=torch.float64, device=device)
               + 0.5) / RES_TD * (math.pi / 2)
    phi_d = (torch.arange(RES_PD, dtype=torch.float64, device=device)
             + 0.5) / RES_PD * math.pi
    th, td, pd = torch.meshgrid(theta_h, theta_d, phi_d, indexing="ij")
    # d in the frame of h, then rotated by theta_h about y
    dx, dy, dz = torch.sin(td) * torch.cos(pd), torch.sin(td) * \
        torch.sin(pd), torch.cos(td)
    c, s = torch.cos(th), torch.sin(th)
    i = torch.stack([dx * c + dz * s, dy, dz * c - dx * s], -1)
    h = torch.stack([s, torch.zeros_like(s), c], -1)
    o = 2.0 * (i * h).sum(-1, keepdim=True) * h - i
    return i.float(), o.float()


def ggx_iso_evalp(alpha, f0, i, o):
    """f_r cos(theta_i) of isotropic GGX + Schlick with height-correlated
    Smith shadowing, ``alpha`` (M,), ``f0`` (M, 3) against directions
    (..., 3): (M, ..., 3). Zero where either direction is below the
    horizon."""
    shape = (-1,) + (1,) * (i.dim() - 1)
    a = alpha.reshape(shape)
    h = i + o
    h = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True).clamp_min(
        1e-12)
    hz = h[..., 2].clamp_min(1e-12)
    t2 = (h[..., 0] ** 2 + h[..., 1] ** 2) / (hz * hz)
    d = 1.0 / (math.pi * a * a * hz ** 4 * (1.0 + t2 / (a * a)) ** 2)

    def g1(k):
        kz = k[..., 2]
        nrm = torch.sqrt(a * a * (k[..., 0] ** 2 + k[..., 1] ** 2) + kz * kz)
        return torch.where(kz > 0, kz / ((nrm + kz) * 0.5), 0.0)

    gi, go = g1(i), g1(o)
    g = torch.where(gi * go > 0, gi * go / (gi + go - gi * go), 0.0)
    cosd = (o * h).sum(-1).clamp(0.0, 1.0)
    f = f0.reshape(shape + (3,)) + (1.0 - cosd)[..., None] ** 5 * (
        1.0 - f0.reshape(shape + (3,)))
    ok = (i[..., 2] > 0) & (o[..., 2] > 0)
    val = f * (d * g / (4.0 * o[..., 2].clamp_min(1e-12)))[..., None]
    return torch.where(ok[..., None], val, 0.0)


def bake_database(alpha, f0, out=None):
    """Raw MERL tables (M, 3, 90, 90, 180) float32 of the materials, as a
    MERL file holds them: f_r at the bin centres over the channel
    scales, -1 below the horizon. Baked one material at a time into
    ``out`` when given."""
    i, o = bin_centre_directions(alpha.device)
    if out is None:
        out = torch.empty((alpha.shape[0], 3, RES_TH, RES_TD, RES_PD),
                          dtype=torch.float32, device=alpha.device)
    below = (i[..., 2] <= 0) | (o[..., 2] <= 0)
    inv = torch.tensor([1.0 / s for s in SCALES], device=alpha.device)
    for m in range(alpha.shape[0]):
        fr = ggx_iso_evalp(alpha[m:m + 1], f0[m:m + 1], i, o)[0] \
            / i[..., 2:3].clamp_min(1e-12)
        fr = torch.where(below[..., None], -1.0, fr * inv)
        out[m] = fr.movedim(-1, 0)
    return out


def direction_set(n: int, generator, device):
    """The fit's shared directions: i and o (n, 3) float32 with theta
    uniform in [0.03, 1.5) and phi in [0, 2 pi)."""
    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=generator,
                                           device=device,
                                           dtype=torch.float32)

    def direction():
        theta, phi = uniform(0.03, 1.5), uniform(0.0, 2 * math.pi)
        s = torch.sin(theta)
        return torch.stack([s * torch.cos(phi), s * torch.sin(phi),
                            torch.cos(theta)], -1)
    i = direction()
    return i, direction()


# -- the lookup --------------------------------------------------------

def merl_index(i, o):
    """Flat bin index (theta_h, theta_d, phi_d) of each direction pair:
    the Rusinkiewicz angles (with the reference's pole clamps at
    0.99999) and the MERL warps (sqrt-warped theta_h, phi_d folded by
    reciprocity), in the directions' precision."""
    h = i + o
    h = h * torch.rsqrt(torch.clamp((h * h).sum(-1), min=1e-24))[..., None]
    hx, hy, hz = h[..., 0], h[..., 1], h[..., 2]
    rho = torch.sqrt(torch.clamp(hx * hx + hy * hy, min=0.0))
    pole = hz > 0.99999
    inv_rho = torch.where(rho > 0.0, 1.0 / torch.clamp(rho, min=1e-24), 1.0)
    cos_ph = torch.where(pole, 1.0, hx * inv_rho)
    sin_ph = torch.where(pole, 0.0, hy * inv_rho)
    sin_th = torch.where(pole, 0.0, rho)
    cos_th = torch.where(pole, 1.0, hz)
    ix, iy, iz = i[..., 0], i[..., 1], i[..., 2]
    t = cos_ph * ix + sin_ph * iy
    dx = cos_th * t - sin_th * iz
    dy = -sin_ph * ix + cos_ph * iy
    dz = sin_th * t + cos_th * iz
    dn = torch.rsqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-24))
    dx, dy, dz = dx * dn, dy * dn, dz * dn
    theta_h = torch.where(pole, 0.0, torch.arccos(torch.clamp(hz, -1.0, 1.0)))
    d_pole = dz > 0.99999
    theta_d = torch.where(d_pole, 0.0,
                          torch.arccos(torch.clamp(dz, -1.0, 1.0)))
    phi_d = torch.where(d_pole, 0.0, torch.atan2(dy, dx))

    deg = theta_h / (math.pi / 2.0) * RES_TH
    ih = torch.floor(torch.sqrt(torch.clamp(deg * RES_TH, min=0.0)))
    ih = torch.where(theta_h <= 0.0, 0, ih.long().clamp(0, RES_TH - 1))
    id_ = torch.floor(theta_d / (math.pi * 0.5) * RES_TD).long().clamp(
        0, RES_TD - 1)
    phi_d = torch.where(phi_d < 0.0, phi_d + math.pi, phi_d)
    ip = torch.floor(phi_d / math.pi * RES_PD).long().clamp(0, RES_PD - 1)
    return (ih * RES_TD + id_) * RES_PD + ip


def lookup(tables, i, o, cosine: bool = True, dtype=torch.float32):
    """(M, N, 3): each table at the bins of the direction pairs (N, 3),
    scaled to f_r, all channels 0 where a raw entry is negative, times
    cos(theta_i) when ``cosine``. The index maths runs in ``dtype``."""
    idx = merl_index(i.to(dtype), o.to(dtype)).reshape(-1)
    flat = tables.reshape(tables.shape[0], 3, PLANE)
    rgb = flat[:, :, idx].permute(0, 2, 1).to(dtype)
    rgb = rgb * torch.tensor(SCALES, device=rgb.device).to(dtype)
    rgb = torch.where(torch.any(rgb < 0.0, -1, keepdim=True), 0.0, rgb)
    if cosine:
        rgb = rgb * i.reshape(-1, 3)[:, 2].to(dtype)[:, None]
    return rgb.reshape(tables.shape[0], *i.shape[:-1], 3)


def lookup_entries(tables, i, o, mat, row, dtype=torch.float32):
    """The lookup's (f_r cos) entries ``(mat[k], row[k])`` only: (K, 3)."""
    idx = merl_index(i[row].to(dtype), o[row].to(dtype))
    flat = tables.reshape(tables.shape[0], 3, PLANE)
    rgb = flat[mat[:, None], torch.arange(3, device=mat.device), idx[:, None]]
    rgb = rgb.to(dtype) * torch.tensor(SCALES, device=rgb.device).to(dtype)
    rgb = torch.where(torch.any(rgb < 0.0, -1, keepdim=True), 0.0, rgb)
    return rgb * i[row, 2].to(dtype)[:, None]


# -- the fit -----------------------------------------------------------

def raw_to_pvec(raw):
    """Unconstrained leaves -> (S, 8) [ax, ay, rho, txn, tyn, f0 rgb]."""
    log_ax, log_ay, raw_rho, txn, tyn, logit_f0 = raw
    return torch.cat([torch.stack([torch.exp(log_ax) + 1e-4,
                                   torch.exp(log_ay) + 1e-4,
                                   0.99 * torch.tanh(raw_rho), txn, tyn], -1),
                      torch.sigmoid(logit_f0)], -1)


def ggx_evalp_pvec(pv, i, o):
    """Elliptic, off-centre GGX + Schlick f_r cos(theta_i), per material
    row of ``pv`` (S, 8), at directions (N, 3): (S, N, 3). The slope
    warp (ax, ay, rho, txn, tyn) enters the NDF and the projected areas
    of the height-correlated Smith term."""
    ax, ay, rho, txn, tyn = (pv[:, k:k + 1] for k in range(5))
    f0 = pv[:, None, 5:8]
    s = torch.sqrt(torch.clamp(1.0 - rho * rho, min=1e-24))
    ix, iy, iz = i[:, 0], i[:, 1], i[:, 2]
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    hx, hy, hz = ix + ox, iy + oy, iz + oz
    hn = torch.rsqrt(torch.clamp(hx * hx + hy * hy + hz * hz, min=1e-24))
    hx, hy, hz = hx * hn, hy * hn, hz * hn

    def sigma(kx, ky, kz):
        a = kx * ax + ky * ay * rho
        b = ky * ay * s
        c = kz - kx * txn - ky * tyn
        return (torch.sqrt(a * a + b * b + c * c) + c) * 0.5, c

    def g1(kz, sig, c):
        ok = (c > 0) & (sig.abs() >= 1e-12)
        return torch.where(ok, kz / torch.where(ok, sig, 1.0), 0.0)

    gi = g1(iz, *sigma(ix, iy, iz))
    go = g1(oz, *sigma(ox, oy, oz))
    tmp = gi * go
    den = gi + go - tmp
    okg = (tmp > 0) & (den.abs() >= 1e-12)
    g = torch.where(okg, tmp / torch.where(okg, den, 1.0), 0.0)

    valid_h = hz > 1e-4
    inv_hz = 1.0 / torch.where(valid_h, hz, 1.0)
    sx = -hx * inv_hz - txn
    sy = -hy * inv_hz - tyn
    x_ = sx / ax
    y_ = (ax * sy - ay * rho * sx) / (ax * ay * s)
    d = torch.where(valid_h, inv_hz ** 4 / (math.pi * ax * ay * s
                                            * (1.0 + x_ * x_ + y_ * y_) ** 2),
                    0.0)
    cosd = torch.clamp(ox * hx + oy * hy + oz * hz, 0.0, 1.0)
    oz4 = 4.0 * oz
    okb = (g > 0) & (oz4.abs() >= 1e-12)
    base = torch.where(okb, d * g / torch.where(okb, oz4, 1.0), 0.0)
    fres = f0 + ((1.0 - cosd) ** 5)[..., None] * (1.0 - f0)
    return fres * base[..., None]


def fit(targets, i, o, steps: int, lr: float, m_total: int,
        init_alpha: float, init_f0: float, dtype=torch.float64):
    """Adam on the relative-L2 loss of each material's targets (S, N, 3)
    at the shared directions, from the isotropic ``init_alpha`` and grey
    ``init_f0``: the gradient of the mean loss over all ``m_total``
    materials, of which these are S. Returns ((S, 8) parameters, (S,)
    loss of the last step, taken before its update)."""
    n_mat = targets.shape[0]
    t = targets.to(dtype)
    i, o = i.to(dtype), o.to(dtype)
    a0, f0 = math.log(init_alpha), math.log(init_f0 / (1.0 - init_f0))

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=t.device,
                          requires_grad=True)

    leaves = [full((n_mat,), a0), full((n_mat,), a0), full((n_mat,), 0.0),
              full((n_mat,), 0.0), full((n_mat,), 0.0), full((n_mat, 3), f0)]
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           foreach=False)
    loss = None
    for _ in range(steps):
        pred = ggx_evalp_pvec(raw_to_pvec(leaves), i, o)
        r = (pred - t) / (t + 1e-2)
        loss = (r * r).mean((-2, -1))
        opt.zero_grad(set_to_none=True)
        (loss.sum() / m_total).backward()
        opt.step()
    with torch.no_grad():
        return raw_to_pvec(leaves).detach(), loss.detach()


# -- the tabulation ------------------------------------------------------

def _f(x, dtype):
    """A constant rounded to ``dtype``."""
    return float(torch.tensor(x, dtype=dtype))


def _lerp(points, u):
    """Edge-clamped linear lookup of tables (*B, n) at u (*Q) in [0, 1]:
    (*B, *Q)."""
    n = points.shape[-1]
    t = u * (n - 1)
    i0 = torch.floor(t).long()
    frac = t - i0
    p0 = points[..., i0.clamp(0, n - 1)]
    p1 = points[..., (i0 + 1).clamp(0, n - 1)]
    return p0 + frac * (p1 - p0)


def _radial_grid(n, dtype, device):
    u = torch.arange(n, dtype=dtype, device=device) / n
    theta = u * u * _f(math.pi * 0.5, dtype)
    r = torch.tan(theta)
    return u, torch.cos(theta), r, torch.sqrt(2.0 * torch.arctan(r)
                                              / math.pi)


def _phi_nodes(dtype):
    """The azimuthal nodes of the kernel's inner integral: steps of
    pi/180 accumulated in ``dtype`` while below 2 pi."""
    ft = np.float32 if dtype in (torch.float32, torch.bfloat16) \
        else np.float64
    step, two_pi, phi, out = ft(np.pi / 180.0), ft(2 * np.pi), ft(0.0), []
    while phi < two_pi:
        out.append(phi)
        phi = ft(phi + step)
    return np.asarray(out)


def _spherical(theta, phi):
    s = torch.sin(theta)
    return torch.stack([s * torch.cos(phi), s * torch.sin(phi),
                        torch.cos(theta) * torch.ones_like(phi)], -1)


def _luma(rgb):
    w = torch.tensor((0.2126, 0.7152, 0.0722), dtype=rgb.dtype,
                     device=rgb.device)
    return (rgb * w).sum(-1)


def _tabular_eval(p22, sigma, i, o):
    """f_r of the tabulated distribution at standard parameters with
    ideal Fresnel: D G / (4 i.z o.z), D from the radial slope table and
    G the height-correlated Smith term of the projected-area table."""
    h = i + o
    h = h * torch.rsqrt(torch.clamp((h * h).sum(-1), min=1e-24))[..., None]
    hz = h[..., 2]
    valid = hz > 1e-4
    shz = torch.where(valid, hz, 1.0)
    r2 = (h[..., 0] ** 2 + h[..., 1] ** 2) / (shz * shz)
    u = torch.sqrt(torch.clamp(2.0 * torch.arctan(torch.sqrt(
        torch.clamp(r2, min=1e-24))) / math.pi, min=1e-24))
    d = torch.where(valid, _lerp(p22, u) / shz ** 4, 0.0)

    def g1(k):
        kz = k[..., 2]
        nrm = torch.sqrt((k * k).sum(-1))
        c = torch.clamp(kz / torch.clamp(nrm, min=1e-20), -1.0, 1.0)
        th = torch.atan2(torch.sqrt(torch.clamp(1.0 - c * c, min=1e-24)), c)
        sig = nrm * _lerp(sigma, 2.0 * th / math.pi)
        small = sig.abs() < 1e-12
        return torch.where((kz > 0) & ~small,
                           kz / torch.where(small, 1.0, sig), 0.0)

    gi, go = g1(i), g1(o)
    tmp = gi * go
    den = gi + go - tmp
    small = den.abs() < 1e-12
    g = torch.where(tmp > 0, torch.where(small, 0.0, tmp / torch.where(
        small, 1.0, den)), 0.0)
    den = 4.0 * o[..., 2]
    small = den.abs() < 1e-12
    evalp = torch.where(g > 0, torch.where(
        small, 0.0, d * g / torch.where(small, 1.0, den)), 0.0)
    return evalp / i[..., 2]


def tabulate(tables, res: int, dtype=torch.float32):
    """The isotropic tabulation of each table (M, 3, 90, 90, 180): the
    retro-reflective kernel's leading eigenvector by a 4-step power
    iteration in float64 (``dtype``'s lower precision for the control),
    the normalised slope table p22, the projected-area table sigma, the
    per-theta_d Fresnel ratio points, the radial CDF and its inverse
    qf, and the Beckmann and GGX alphas of the slope moments.

    Returns a dict of (M, res) ``p22``, ``sigma``, ``cdf``, ``qf``,
    (M, res, 3) ``fresnel`` and (M,) ``alpha_beckmann``,
    ``alpha_ggx``."""
    dev = tables.device
    ft = dtype
    cnt = res - 1

    def merl_eval(i, o):
        return lookup(tables, i, o, cosine=False, dtype=ft)

    # kernel matrix A[i, j] = K(j, i) and its power iteration
    t = (torch.arange(cnt, dtype=ft, device=dev) / cnt) * _f(
        math.sqrt(math.pi * 0.5), ft)
    theta = t * t
    cos_t, tan_t = torch.cos(theta), torch.tan(theta)
    d = _spherical(theta, torch.zeros_like(theta))
    fr = _luma(merl_eval(d, d))                                 # (M, cnt)
    kji = (_f(math.sqrt(math.pi * 0.5) / cnt, ft) * cos_t ** 6) * (8.0 * fr)
    phis = torch.as_tensor(_phi_nodes(ft), device=dev).to(ft)
    nint = torch.clamp((tan_t[:, None] * tan_t[None, :])[..., None]
                       * torch.cos(phis), min=1.0).sum(-1) * _f(
        math.pi / 180.0, ft)
    k = (t[:, None] * kji[..., None, :] * nint
         * (tan_t / cos_t ** 2)[:, None])
    a = k.transpose(-1, -2).to(_lower(dtype))
    v = torch.ones(a.shape[:-1], dtype=a.dtype, device=dev)
    for _ in range(4):
        v = torch.matmul(a, v[..., None])[..., 0]
    p22 = torch.cat([1e-2 * v, torch.zeros_like(v[..., :1])], -1).to(ft)

    # normalisation: 128-node u^2-warped quadrature
    u, cos_h, r_h, uu = _radial_grid(128, ft, dev)
    norm = ((u * _lerp(p22, uu) * r_h) / (cos_h * cos_h)).sum(-1)
    norm = norm * _f(math.pi / 128, ft) * _f(2.0 * math.pi, ft)
    p22 = p22 / norm[..., None]

    # projected area: 90 theta_h x 180 phi_h nodes for each theta_k
    theta_k = (torch.arange(cnt, dtype=ft, device=dev) / cnt) * _f(
        0.5 * math.pi, ft)
    cos_k, sin_k = torch.cos(theta_k), torch.sin(theta_k)
    u_i, cos_h, _, uu = _radial_grid(90, ft, dev)
    theta_h = u_i * u_i * _f(math.pi * 0.5, ft)
    sin_h = torch.sin(theta_h)
    phi_h = (torch.arange(180, dtype=ft, device=dev) / 180) * _f(
        2.0 * math.pi, ft)
    kh = (sin_k[:, None, None] * (sin_h * torch.cos(phi_h)[:, None])[None]
          + (cos_k[:, None] * cos_h[None, :])[:, None, :])
    kh = torch.clamp(kh, min=0.0).sum(1)                          # (cnt, 90)
    w = _lerp(p22, uu) / cos_h ** 4 * u_i * sin_h
    proj = (kh * w[..., None, :]).sum(-1) * _f(math.pi / 90, ft) * _f(
        2.0 * math.pi / 180, ft)
    sigma = torch.maximum(cos_k, proj)
    sigma = torch.cat([sigma, sigma[..., -1:]], -1)

    # Fresnel: per theta_d, the mean measured / microfacet ratio with i
    # at the normal, over the theta_h nodes whose predecessor lies
    # below pi/2 - theta_d
    half_pi = _f(math.pi * 0.5, ft)
    theta_d = (torch.arange(cnt, dtype=ft, device=dev) / cnt) * half_pi
    j = torch.arange(2 * cnt, dtype=ft, device=dev)
    th = (j / cnt) ** 2 * half_pi
    th_prev = torch.cat([torch.zeros(1, dtype=ft, device=dev), th[:-1]])
    active = (th_prev[None, :] < (half_pi - theta_d[:, None])) \
        & (th[None, :] <= half_pi)
    TH = th[None, :].expand(cnt, -1)
    TD = theta_d[:, None].expand(-1, 2 * cnt)
    hvec = _spherical(TH, torch.zeros_like(TH))
    dvec = _spherical(TD, torch.full_like(TD, half_pi))
    # (h, d) -> o, with the pole clamp of the angles of h
    hz = hvec[..., 2]
    pole = hz > 0.99999
    th_h = torch.where(pole, 0.0, torch.arccos(torch.clamp(hz, -1.0, 1.0)))
    ph_h = torch.where(pole, 0.0, torch.atan2(hvec[..., 1], hvec[..., 0]))
    c, s = torch.cos(th_h)[..., None], torch.sin(th_h)[..., None]
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=ft, device=dev).expand(
        dvec.shape)
    tmp = dvec * c + ey * ((ey * dvec).sum(-1, keepdim=True) * (1.0 - c)) \
        + torch.linalg.cross(ey, dvec, dim=-1) * s
    c, s = torch.cos(ph_h)[..., None], torch.sin(ph_h)[..., None]
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=ft, device=dev).expand(
        dvec.shape)
    iv = tmp * c + ez * ((ez * tmp).sum(-1, keepdim=True) * (1.0 - c)) \
        + torch.linalg.cross(ez, tmp, dim=-1) * s
    iv = iv * torch.rsqrt((iv * iv).sum(-1, keepdim=True))
    ov = 2.0 * (iv * hvec).sum(-1, keepdim=True) * hvec - iv
    ov = ov * torch.rsqrt((ov * ov).sum(-1, keepdim=True))
    ivz = torch.tensor([0.0, 0.0, 1.0], dtype=ft, device=dev).expand(
        ov.shape)
    fr1 = merl_eval(ivz, ov)                                  # (M, cnt, nj, 3)
    fr2 = _tabular_eval(p22, sigma, ivz, ov)[..., None]
    ok = active[..., None] & (fr2 > 1e-4)
    ratio = torch.where(ok, fr1 / torch.where(ok, fr2, 1.0), 0.0)
    count = ok.sum(-2)
    avg = torch.where(count == 0, 1.0, torch.clamp(
        ratio.sum(-2) / torch.clamp(count, min=1), max=1.0))
    fresnel = torch.cat([avg, avg[..., -1:, :]], -2)

    # radial CDF and its inverse at 8x resolution
    u, cos_h, r_h, uu = _radial_grid(cnt, ft, dev)
    terms = (u * r_h * _lerp(p22, uu)) / (cos_h * cos_h)
    cdf = torch.cumsum(terms, -1) * _f(math.pi / cnt * 2.0 * math.pi, ft)
    cdf = torch.cat([cdf, torch.ones_like(cdf[..., :1])], -1)
    n_inv = cnt * 8
    uq = torch.arange(n_inv, dtype=ft, device=dev) / n_inv
    r = torch.tan(uq * _f(math.pi * 0.5, ft))
    cvals = _lerp(cdf, torch.sqrt(torch.clamp(torch.arctan(r) * 2.0
                                              / math.pi, min=0.0)))
    goal = (torch.arange(1, cnt, dtype=ft, device=dev) / cnt).expand(
        cvals.shape[:-1] + (cnt - 1,))
    idx = torch.searchsorted(cvals.float().contiguous(),
                             goal.float().contiguous(), side="left")
    mid = torch.where(idx >= n_inv, 1.0, uq[idx.clamp(max=n_inv - 1)])
    qf = torch.cat([torch.zeros_like(mid[..., :1]), mid,
                    torch.ones_like(mid[..., :1])], -1)

    # slope moments: Beckmann alpha = sqrt(2 E[x^2]), GGX alpha = E|x|
    u, cos_h, r_h, _ = _radial_grid(128, ft, dev)
    rr = torch.sqrt(torch.clamp(r_h * r_h, min=1e-24))
    p22_r = _lerp(p22, torch.sqrt(torch.clamp(2.0 * torch.arctan(rr)
                                              / math.pi, min=1e-24)))
    beck = ((u * r_h ** 3 * p22_r) / (cos_h * cos_h)).sum(-1) * (
        math.pi / 128) * math.pi
    ggx = ((u * r_h ** 2 * p22_r) / (cos_h * cos_h)).sum(-1) * (
        math.pi / 128) * 4.0
    return {"p22": p22, "sigma": sigma, "cdf": cdf, "qf": qf,
            "fresnel": fresnel, "alpha_beckmann": torch.sqrt(2.0 * beck),
            "alpha_ggx": ggx}
