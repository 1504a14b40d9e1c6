"""Plain reference of the ``preview512`` configuration: the material
preview path-traced under a delta light or a lat-long environment map.

Plain PyTorch and NumPy, written for the benchmark from the published
formulas: the sphere-over-plane scene and pinhole camera of the
reference's material preview, the microfacet BRDF of ``djb::microfacet``
(elliptic, height-correlated Smith, visible-normal sampling: GGX's
closed-form quantiles, Beckmann's Halley-refined quantile), Schlick's
Fresnel, next-event estimation toward the delta light, and for the
environment map the Walker/Vose alias table over texel masses weighted
by sin(theta), one emitter sample and one BSDF sample a bounce combined
by the power heuristic. Every path is traced the "generic" way: both
materials evaluated on (N, 3) tensors and selected per ray. It imports
nothing of the program and builds every table again from the inputs the
benchmark makes (the uniforms ``u`` and ``u_env`` and the map's image).

``dtype`` selects the precision: float64 for the reference, bfloat16
for the control (one precision below the configuration's float32).
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPS = 1e-3
FOV_SCALE = 0.62
SQRT_PI_INV = 0.5641895835477563


# -- vectors -------------------------------------------------------------

def dot(a, b):
    return (a * b).sum(-1)


def normalize(v, eps: float = 0.0):
    m = dot(v, v)
    if eps:
        m = torch.clamp(m, min=eps)
    return v * torch.rsqrt(m)[..., None]


def vec3(x, y, z):
    return torch.stack(torch.broadcast_tensors(x, y, z), -1)


def frame(n):
    """A tangent frame of each normal (Duff et al.'s branchless form)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = vec3(1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0])
    bt = vec3(b, s + n[..., 1] * n[..., 1] * a, -n[..., 1])
    return t, bt


def to_local(n, v):
    t, b = frame(n)
    return vec3(dot(v, t), dot(v, b), dot(v, n))


def to_world(n, v):
    t, b = frame(n)
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


# -- special functions (the reference library's polynomials) -------------

def erf(x):
    """Abramowitz & Stegun 7.1.26."""
    a1, a2, a3 = 0.254829592, -0.284496736, 1.421413741
    a4, a5, p = -1.453152027, 1.061405429, 0.3275911
    t = 1.0 / (1.0 + p * x.abs())
    y = 1.0 - (((((a5 * t + a4) * t) + a3) * t + a2) * t + a1) * t \
        * torch.exp(-x * x)
    return torch.sign(x) * y


def erfinv(u):
    """Giles' single-precision branch-split polynomial."""
    w = -torch.log(torch.clamp((1.0 - u) * (1.0 + u),
                               min=torch.finfo(torch.float32).tiny))
    wc = w - 2.5
    pc = 2.81022636e-08
    for c in (3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
              1.50140941):
        pc = c + pc * wc
    wt = torch.sqrt(torch.clamp(w, min=0.0)) - 3.0
    pt = -0.000200214257
    for c in (0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
              -0.0076224613, 0.00943887047, 1.00167406, 2.83297682):
        pt = c + pt * wt
    return torch.where(w < 5.0, pc, pt) * u


# -- distributions ----------------------------------------------------------

class Params:
    """Slope-space parameters (ax, ay, rho, txn, tyn) of an elliptic
    distribution given by its principal roughnesses and angle."""

    def __init__(self, a1, a2, phi, dtype, device):
        c, s = math.cos(phi), math.sin(phi)
        c2 = 2.0 * c * c - 1.0
        t1, t2 = a1 * a1 + a2 * a2, a1 * a1 - a2 * a2
        ax = math.sqrt(0.5 * (t1 + t2 * c2))
        ay = math.sqrt(0.5 * (t1 - t2 * c2))
        rho = (a2 * a2 - a1 * a1) * c * s / (ax * ay)

        def t(x):
            return torch.tensor(x, dtype=dtype, device=device)
        self.ax, self.ay, self.rho = t(ax), t(ay), t(rho)
        self.txn, self.tyn = t(0.0), t(0.0)
        self.s = torch.sqrt(torch.clamp(1.0 - self.rho * self.rho,
                                        min=1e-24))
        self.mean_normal = normalize(vec3(-self.txn, -self.tyn,
                                          torch.ones_like(self.txn)))


class GGX:
    def p22(self, x, y):
        tmp = 1.0 + x * x + y * y
        return 1.0 / (math.pi * tmp * tmp)

    def sigma_std(self, cz):
        return (1.0 + cz) / 2.0

    def qf2(self, u, cos_k, sin_k):
        sin_t = u * (1.0 + cos_k) - 1.0
        cos_t = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=1e-24))
        tan_t = sin_t / torch.clamp(cos_t, min=1e-12)
        cot_t = cos_t / torch.where(sin_t == 0.0, 1e-12, sin_t)
        tan_k = sin_k / torch.clamp(cos_k, min=1e-12)
        cot_k = cos_k / torch.clamp(sin_k, min=1e-12)
        s = 0.707107
        r_tt = -(tan_t + tan_k) / (1.0 - tan_t * tan_k)
        r_tc = (1.0 + tan_t * cot_k) / (tan_t - cot_k)
        r_ct = (1.0 + tan_k * cot_t) / (tan_k - cot_t)
        r_cc = (cot_t + cot_k) / (1.0 - cot_t * cot_k)
        return torch.where(cos_t > s, torch.where(sin_k < s, r_tt, r_tc),
                           torch.where(sin_k < s, r_ct, r_cc))

    def qf3(self, u, qf2):
        alpha = torch.sqrt(1.0 + qf2 * qf2)
        sgn = torch.where(u < 0.5, -1.0, 1.0)
        t = torch.where(u < 0.5, 2.0 * (0.5 - u), 2.0 * (u - 0.5))
        p = t * (t * (t * (-0.365728915865723) + 0.790235037209296)
                 - 0.424965825137544) + 0.000152998850436920
        q = t * (t * (t * (t * 0.169507819808272 - 0.397203533833404)
                      - 0.232500544458471) + 1.0) - 0.539825872510702
        return sgn * alpha * (p / q)


class Beckmann:
    def p22(self, x, y):
        return torch.exp(-(x * x + y * y)) / math.pi

    def sigma_std(self, c):
        sin_k = torch.sqrt(torch.clamp(1.0 - c * c, min=1e-24))
        nu = c / torch.clamp(sin_k, min=1e-12)
        sig = (c * (1.0 + erf(nu)) + sin_k * torch.exp(-nu * nu)
               * SQRT_PI_INV) / 2.0
        return torch.where(c >= 1.0, 1.0, sig)

    def qf2(self, u, cos_k, sin_k):
        """The visible x-slope quantile by 4 safeguarded Halley steps in
        slope space from the power-law start."""
        cot = torch.clamp(cos_k, min=1e-12) * (1.0 / torch.clamp(sin_k,
                                                                 min=1e-12))
        tan = sin_k * (1.0 / torch.clamp(cos_k, min=1e-12))
        c0 = erf(cot)
        e_cot2 = torch.exp(-cot * cot)
        u = torch.clamp(u, min=1e-6)
        fit = 1.0 + cos_k * (-0.876 + cos_k * (0.4265 - 0.0594 * cos_k))
        b0 = c0 - (1.0 + c0) * torch.pow(1.0 - u, fit)
        norm = 1.0 / torch.clamp(1.0 + c0 + SQRT_PI_INV * tan * e_cot2,
                                 min=1e-12)
        t = erfinv(torch.clamp(b0, min=-0.9999))
        hi = torch.clamp(cot, max=4.0)
        a1, a2, a3 = 0.254829592, -0.284496736, 1.421413741
        a4, a5, p = -1.453152027, 1.061405429, 0.3275911
        lo = -3.5
        for _ in range(4):
            t = torch.minimum(torch.clamp(t, min=lo), hi)
            e = torch.exp(-t * t)
            k = 1.0 / (1.0 + p * t.abs())
            erf_t = torch.sign(t) * (1.0 - (((((a5 * k + a4) * k) + a3) * k
                                             + a2) * k + a1) * k * e)
            value = norm * (1.0 + erf_t + SQRT_PI_INV * tan * e) - u
            dfac = 1.0 - t * tan
            fp = norm * (2.0 * SQRT_PI_INV) * e * dfac
            ok_fp = fp.abs() > 1e-20
            r = value * (1.0 / torch.where(ok_fp, fp, 1.0))
            h = (-2.0 * t * dfac - tan) * (1.0 / (
                2.0 * torch.where(dfac.abs() > 1e-12, dfac, 1.0)))
            den = 1.0 - r * h
            ok_h = ok_fp & (den > 0.5) & (dfac.abs() > 1e-12)
            step = r * torch.where(ok_h, 1.0 / torch.where(ok_h, den, 1.0),
                                   1.0)
            t = t - torch.where(ok_fp, step, 0.0)
        return torch.minimum(torch.clamp(t, min=lo), hi)

    def qf3(self, u, qf2):
        return erfinv(2.0 * u - 1.0)


# -- the microfacet BRDF ------------------------------------------------------

def _safe_div(num, den):
    small = den.abs() < 1e-12
    return torch.where(small, 0.0, num / torch.where(small, 1.0, den))


class Material:
    """dist + Schlick(f0) + params, all evaluated in the local frame."""

    def __init__(self, dist, f0, params: Params):
        self.dist, self.f0, self.p = dist, f0, params

    def fresnel(self, cosd):
        c1 = 1.0 - cosd[..., None]
        return self.f0 + c1 * c1 * c1 * c1 * c1 * (1.0 - self.f0)

    def ndf(self, h):
        p = self.p
        hz = h[..., 2]
        valid = hz > 1e-4
        shz = torch.where(valid, hz, 1.0)
        x = -h[..., 0] / shz - p.txn
        y = -h[..., 1] / shz - p.tyn
        x_ = x / p.ax
        y_ = (p.ax * y - p.rho * p.ay * x) / (p.ax * p.ay * p.s)
        c2 = shz * shz
        return torch.where(valid, self.dist.p22(x_, y_) / (p.ax * p.ay * p.s)
                           / (c2 * c2), 0.0)

    def sigma(self, k):
        p = self.p
        a = k[..., 0] * p.ax + k[..., 1] * p.ay * p.rho
        b = k[..., 1] * p.ay * p.s
        c = k[..., 2] - k[..., 0] * p.txn - k[..., 1] * p.tyn
        nrm = torch.sqrt(a * a + b * b + c * c)
        return nrm * self.dist.sigma_std(c / torch.clamp(nrm, min=1e-20))

    def g1(self, k):
        return torch.where(dot(k, self.p.mean_normal) > 0.0,
                           _safe_div(k[..., 2], self.sigma(k)), 0.0)

    def gaf(self, i, o):
        gi, go = self.g1(i), self.g1(o)
        tmp = gi * go
        return torch.where(tmp > 0.0, _safe_div(tmp, gi + go - tmp), 0.0)

    def vndf(self, h, k):
        kh = dot(k, h)
        return torch.where(kh > 0.0, _safe_div(kh * self.ndf(h),
                                               self.sigma(k)), 0.0)

    def evalp(self, i, o):
        h = normalize(i + o, eps=1e-24)
        g = self.gaf(i, o)
        f = self.fresnel(torch.clamp(dot(o, h), 0.0, 1.0))
        val = f * _safe_div(self.ndf(h) * g, 4.0 * o[..., 2])[..., None]
        return torch.where((g > 0.0)[..., None], val, 0.0)

    def pdf(self, i, o):
        h = normalize(i + o, eps=1e-24)
        g = self.gaf(i, o)
        val = _safe_div(self.vndf(h, o), 4.0 * dot(i, h))
        return torch.where(g > 0.0, val, 0.0)

    def sample(self, u1, u2, o):
        p = self.p
        u1 = torch.clamp(u1, 0.0, 1.0) * 0.99998 + 0.00001
        u2 = torch.clamp(u2, 0.0, 1.0) * 0.99998 + 0.00001
        a = o[..., 0] * p.ax + o[..., 1] * p.ay * p.rho
        b = o[..., 1] * p.ay * p.s
        c = o[..., 2] - o[..., 0] * p.txn - o[..., 1] * p.tyn
        k = normalize(vec3(a, b, c), eps=1e-24)
        cos_k = k[..., 2]
        sin_k = torch.sqrt(torch.clamp(1.0 - cos_k * cos_k, min=1e-24))
        tx = self.dist.qf2(u1, cos_k, sin_k)
        ty = self.dist.qf3(u2, tx)
        normal = sin_k <= 1e-9
        nrm = torch.rsqrt(torch.clamp(k[..., 0] ** 2 + k[..., 1] ** 2,
                                      min=1e-24))
        cph = torch.where(normal, 1.0, k[..., 0] * nrm)
        sph = torch.where(normal, 0.0, k[..., 1] * nrm)
        tx_m, ty_m = cph * tx - sph * ty, sph * tx + cph * ty
        tx_h = p.ax * tx_m + p.txn
        ty_h = p.ay * (p.rho * tx_m + p.s * ty_m) + p.tyn
        h = normalize(vec3(-tx_h, -ty_h, torch.ones_like(tx_h)))
        i = 2.0 * dot(o, h)[..., None] * h - o
        up = torch.zeros_like(i)
        up[..., 2] = 1.0
        return torch.where((k[..., 2] > 0.0)[..., None], i, up)

    def evalp_is(self, u1, u2, o):
        """(weight F G / G1(o), sampled i, pdf); weight and pdf are 0 for
        receivers below the mean-normal horizon."""
        p = self.p
        i = self.sample(u1, u2, o)
        up = torch.zeros_like(i)
        up[..., 2] = 1.0
        valid = dot(o, p.mean_normal) > 0.0
        i = torch.where(valid[..., None], i, up)
        h = normalize(i + o, eps=1e-24)
        ok_h = h[..., 2] > 1e-6
        h = torch.where(ok_h[..., None], h, up)
        g = self.gaf(i, o)
        cosd = torch.clamp(dot(o, h), 0.0, 1.0)
        ok = (g > 0.0) & valid & ok_h
        pdf = _safe_div(self.vndf(h, o), 4.0 * cosd)
        w = self.fresnel(cosd) * _safe_div(g, self.g1(o))[..., None]
        bad = (o[..., 2] - o[..., 0] * p.txn - o[..., 1] * p.tyn) <= 0.0
        ok = ok & ~bad
        return (torch.where(ok[..., None], w, 0.0), i,
                torch.where(ok, pdf, 0.0))


# -- the scene -----------------------------------------------------------

def materials(cfg, dtype, device):
    """(sphere, floor) of the configuration."""
    def make(m):
        dist = {"ggx": GGX, "beckmann": Beckmann}[m["dist"]]()
        a1, a2, phi = m["alpha"]
        return Material(dist, torch.tensor(m["f0"], dtype=dtype,
                                           device=device),
                        Params(a1, a2, phi, dtype, device))
    return make(cfg["sphere"]), make(cfg["floor"])


def camera_rays(res, spp, pixels, dtype, device):
    """(ro, rd) of the camera's rays through ``pixels`` (B,), for every
    one of the spp samples, sample-major: (spp * B, 3)."""
    cam = torch.tensor([0.0, 3.2, 0.6], dtype=dtype, device=device)
    look = normalize(-cam)
    right = normalize(torch.linalg.cross(look, torch.tensor(
        [0.0, 0.0, 1.0], dtype=dtype, device=device)))
    up = torch.linalg.cross(right, look)
    xs = (torch.arange(res, dtype=dtype, device=device) + 0.5) / res \
        * 2.0 - 1.0
    px = xs[pixels % res].repeat(spp)
    py = (-xs)[pixels // res].repeat(spp)
    rd = normalize(look + FOV_SCALE * (px[..., None] * right
                                       + py[..., None] * up))
    return cam.expand(rd.shape), rd


def intersect(ro, rd):
    """The unit sphere at the origin and the plane z = -1: (hit, t,
    normal, is_sphere)."""
    b = dot(ro, rd)
    c = dot(ro, ro) - 1.0
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_s = torch.where(disc > 0.0, -b - sq, math.inf)
    t_s = torch.where(t_s > EPS, t_s, math.inf)
    dz = rd[..., 2]
    t_p = (-1.0 - ro[..., 2]) / torch.where(dz.abs() < 1e-9, 1e-9, dz)
    t_p = torch.where((t_p > EPS) & (dz.abs() > 1e-9), t_p, math.inf)
    is_sphere = t_s < t_p
    t = torch.minimum(t_s, t_p)
    hit = torch.isfinite(t)
    pos = ro + t[..., None] * rd
    n_s = normalize(pos, eps=1e-12)
    n_p = torch.zeros_like(ro)
    n_p[..., 2] = 1.0
    return hit, t, torch.where(is_sphere[..., None], n_s, n_p), is_sphere


def _both(mats, is_sphere, name, *args):
    a = getattr(mats[0], name)(*args)
    b = getattr(mats[1], name)(*args)

    def sel(x, y):
        m = is_sphere
        while m.dim() < x.dim():
            m = m[..., None]
        return torch.where(m, x, y)
    if isinstance(a, tuple):
        return tuple(sel(x, y) for x, y in zip(a, b))
    return sel(a, b)


def trace_delta(mats, light_dir, light_rad, sky, ro, rd, u):
    """Per-ray radiance under the delta light and the constant sky, with
    next-event estimation toward the light and BSDF sampling."""
    thr = torch.ones_like(rd)
    rad = torch.zeros_like(rd)
    alive = torch.ones(rd.shape[0], dtype=torch.bool, device=rd.device)
    light = light_dir.expand(rd.shape)
    for u_b in u:
        hit, t, n, is_s = intersect(ro, rd)
        rad = rad + torch.where((alive & ~hit)[..., None], thr * sky, 0.0)
        alive = alive & hit
        pos = ro + t[..., None] * rd
        o_loc = to_local(n, -rd)
        i_loc = to_local(n, light)
        shadow_o = pos + n * EPS * 3.0
        lit = ~intersect(shadow_o, light)[0]
        f = _both(mats, is_s, "evalp", i_loc, o_loc)
        w, i_s, pdf = _both(mats, is_s, "evalp_is", u_b[:, 0], u_b[:, 1],
                            o_loc)
        ok = alive & lit & (i_loc[..., 2] > 0.0) & (o_loc[..., 2] > 0.0)
        rad = rad + torch.where(ok[..., None], thr * light_rad * f, 0.0)
        thr = thr * torch.where(alive[..., None], w, 1.0)
        alive = alive & (pdf > 0.0) & (i_s[..., 2] > 0.0)
        rd_new = normalize(to_world(n, i_s), eps=1e-12)
        ro = torch.where(alive[..., None], shadow_o, ro)
        rd = torch.where(alive[..., None], rd_new, rd)
    hit = intersect(ro, rd)[0]
    return rad + torch.where((alive & ~hit)[..., None], thr * sky, 0.0)


# -- the environment map ---------------------------------------------------

def env_image(h, w, rng):
    """A lat-long radiance image: |N(1, 0.5)| texels with one bright
    patch (60x) a tenth of the height by a twelfth of the width."""
    img = np.abs(rng.normal(1.0, 0.5, (h, w, 3))).astype(np.float32)
    img[h // 5:h // 5 + max(1, h // 10),
        w // 3:w // 3 + max(1, w // 12)] *= 60.0
    return img


def alias_table(mass):
    """Walker/Vose alias table of a probability vector (float64): the
    mass scaled by n over its sequential sum, small and large worklists
    used as stacks; leftovers accept with certainty. Returns (prob
    float32, alias int64)."""
    n = mass.size
    total = float(np.cumsum(mass)[-1])
    p = (mass * (float(n) / total)).tolist()
    prob = [0.0] * n
    alias = list(range(n))
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        s = small.pop()
        lg = large.pop()
        prob[s] = p[s]
        alias[s] = lg
        p[lg] -= 1.0 - p[s]
        (small if p[lg] < 1.0 else large).append(lg)
    for i in large + small:
        prob[i] = 1.0
    return np.asarray(prob, np.float32), np.asarray(alias, np.int64)


class EnvMap:
    """Nearest-texel lookups and alias sampling of a lat-long map."""

    def __init__(self, img, dtype, device):
        h, w = img.shape[:2]
        lum = np.maximum(img, 0.0).mean(-1) + 1e-12
        mass = lum * np.sin((np.arange(h) + 0.5) * (np.pi / h))[:, None]
        mass = mass / mass.sum()
        pb = (mass / ((np.pi / h) * (2.0 * np.pi / w))).astype(np.float32)
        prob, alias = alias_table(mass.reshape(-1))
        self.h, self.w = h, w
        self.rgb = torch.as_tensor(img.reshape(-1, 3), device=device).to(dtype)
        self.pb = torch.as_tensor(pb.reshape(-1), device=device).to(dtype)
        self.prob = torch.as_tensor(prob, device=device).to(dtype)
        self.alias = torch.as_tensor(alias, device=device)

    def eval_with_pdf(self, d):
        """Radiance and sampling density toward world directions."""
        h, w = self.h, self.w
        lz = d[..., 2]
        theta = torch.arccos(torch.clamp(lz, -1.0, 1.0))
        phi = torch.atan2(d[..., 1], d[..., 0])
        phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
        j = torch.floor(theta * (h / math.pi)).long().clamp(0, h - 1)
        i = torch.remainder(torch.floor(phi * (w / (2.0 * math.pi))).long(),
                            w)
        idx = j * w + i
        sin_t = torch.clamp(torch.sqrt(torch.clamp(1.0 - lz * lz, min=0.0)),
                            min=1e-6)
        return self.rgb[idx], self.pb[idx] / sin_t

    def sample(self, u1, u2, u3):
        """A direction drawn from the map's density and that density: a
        row from u1 (its fraction the accept test), a column from u2 (its
        fraction the phi offset), u3 the theta offset."""
        h, w = self.h, self.w
        xr = torch.clamp(u1, 0.0, 1.0) * h
        j = xr.long().clamp(max=h - 1)
        frac = xr - j
        xc = torch.clamp(u2, 0.0, 1.0) * w
        i = xc.long().clamp(max=w - 1)
        fc = xc - i
        idx = j * w + i
        take = frac < self.prob[idx]
        bin_ = torch.where(take, idx, self.alias[idx])
        pb = self.pb[bin_]
        jj = torch.div(bin_, w, rounding_mode="floor")
        ii = bin_ - jj * w
        tg = jj + torch.clamp(u3, 0.0, 0.999999)
        pg = ii + torch.clamp(fc, 0.0, 0.999999)
        theta = tg * (math.pi / h)
        phi = pg * (2.0 * math.pi / w)
        st = torch.sin(theta)
        d = vec3(st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta))
        return d, pb / torch.clamp(st, min=1e-6)


def power(a, b):
    a2 = a * a
    den = a2 + b * b
    return torch.where(den > 0.0, a2 / torch.where(den > 0.0, den, 1.0), 0.0)


def trace_envmap(mats, em, ro, rd, u, u_env):
    """Per-ray radiance under the environment map: per bounce one
    emitter sample and one BSDF sample, each weighted against the other
    strategy's density by the power heuristic; the camera ray's own
    hit of the map carries weight 1."""
    thr = torch.ones_like(rd)
    rad = torch.zeros_like(rd)
    alive = torch.ones(rd.shape[0], dtype=torch.bool, device=rd.device)
    prev = torch.full((rd.shape[0],), -1.0, dtype=rd.dtype, device=rd.device)
    for u_b, u_e in zip(u, u_env):
        hit, t, n, is_s = intersect(ro, rd)
        le, pdf_e = em.eval_with_pdf(rd)
        w_mis = torch.where(prev < 0.0, 1.0, power(prev, pdf_e))
        miss = alive & ~hit
        rad = rad + torch.where(miss[..., None], thr * le * w_mis[..., None],
                                0.0)
        alive = alive & hit
        pos = ro + t[..., None] * rd
        o_loc = to_local(n, -rd)
        l_world, pdf_l = em.sample(u_e[:, 0], u_e[:, 1], u_e[:, 2])
        l_loc = to_local(n, l_world)
        shadow_o = pos + n * EPS * 3.0
        lit = ~intersect(shadow_o, l_world)[0]
        f = _both(mats, is_s, "evalp", l_loc, o_loc)
        pdf_b = _both(mats, is_s, "pdf", l_loc, o_loc)
        le_l, _ = em.eval_with_pdf(l_world)
        w_nee = power(pdf_l, torch.clamp(pdf_b, min=0.0))
        contrib = thr * le_l * f * (w_nee / torch.clamp(pdf_l, min=1e-12)
                                    )[..., None]
        ok = alive & lit & (l_loc[..., 2] > 0.0) & (o_loc[..., 2] > 0.0)
        rad = rad + torch.where(ok[..., None], contrib, 0.0)
        w, i_s, pdf = _both(mats, is_s, "evalp_is", u_b[:, 0], u_b[:, 1],
                            o_loc)
        thr = thr * torch.where(alive[..., None], w, 1.0)
        alive = alive & (pdf > 0.0) & (i_s[..., 2] > 0.0)
        rd_new = normalize(to_world(n, i_s), eps=1e-12)
        ro = torch.where(alive[..., None], shadow_o, ro)
        rd = torch.where(alive[..., None], rd_new, rd)
        prev = torch.where(alive, pdf, prev)
    hit = intersect(ro, rd)[0]
    miss = alive & ~hit
    le, pdf_e = em.eval_with_pdf(rd)
    w_mis = torch.where(prev < 0.0, 1.0, power(prev, pdf_e))
    return rad + torch.where(miss[..., None], thr * le * w_mis[..., None],
                             0.0)


def render(cfg, u, u_env=None, env=None, dtype=torch.float64,
           block: int = 1 << 16):
    """The (res, res, 3) image of the configuration's scene from the
    uniforms ``u`` (bounces, res * res * spp, 2), sample-major, under the
    delta light, or under ``env`` (an :class:`EnvMap`) with ``u_env``
    (bounces, N, 3). Traced ``block`` pixels at a time; each pixel is the
    sum of its spp samples, added in order, over spp."""
    res, spp = cfg["res"], cfg["spp"]
    dev = u.device
    mats = materials(cfg, dtype, dev)
    light = cfg["light"]
    ldir = normalize(torch.tensor(light["dir"], dtype=dtype, device=dev))
    lrad = torch.tensor(light["radiance"], dtype=dtype, device=dev)
    sky = torch.tensor(light["sky"], dtype=dtype, device=dev)
    n_pix = res * res
    out = torch.empty((n_pix, 3), dtype=torch.float64, device=dev)
    for p0 in range(0, n_pix, block):
        pix = torch.arange(p0, min(p0 + block, n_pix), device=dev)
        rays = (torch.arange(spp, device=dev)[:, None] * n_pix
                + pix[None, :]).reshape(-1)
        ro, rd = camera_rays(res, spp, pix, dtype, dev)
        ub = u[:, rays].to(dtype)
        if env is None:
            r = trace_delta(mats, ldir, lrad, sky, ro, rd, ub)
        else:
            r = trace_envmap(mats, env, ro, rd, ub, u_env[:, rays].to(dtype))
        r = r.reshape(spp, -1, 3)
        total = r[0]
        for k in range(1, spp):
            total = total + r[k]
        out[p0:p0 + pix.numel()] = (total / spp).double()
    return out.reshape(res, res, 3)
