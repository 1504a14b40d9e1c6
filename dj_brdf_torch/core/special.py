"""Special functions.

The reference uses two specific polynomial approximations — erf via
Abramowitz & Stegun 7.1.26 (dj_brdf.h:667-688, after John D. Cook) and
erfinv via Mike Giles' single-precision polynomial (dj_brdf.h:691-721).
Both are written out here exactly as in the JAX package, so the port
keeps the reference's numerics (``torch.erf`` would not).

``torch.erf``/``torch.erfinv`` are exposed as ``erf_exact`` /
``erfinv_exact`` for users who prefer higher accuracy over bit parity.
"""

from __future__ import annotations

import torch

erf_exact = torch.erf
erfinv_exact = torch.erfinv


def erf(x):
    """Abramowitz & Stegun 7.1.26 polynomial erf (max abs error 1.5e-7),
    matching the reference's erf (dj_brdf.h:667-688)."""
    a1, a2, a3 = 0.254829592, -0.284496736, 1.421413741
    a4, a5, p = -1.453152027, 1.061405429, 0.3275911
    sign = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + p * ax)
    y = 1.0 - (((((a5 * t + a4) * t) + a3) * t + a2) * t + a1) * t * torch.exp(-x * x)
    return sign * y


def erfinv(u):
    """Mike Giles' branch-split polynomial approximation of erfinv,
    matching the reference's erfinv (dj_brdf.h:691-721)."""
    # log1p-free form mirrors the reference: w = -log((1-u)(1+u))
    w = -torch.log(torch.clamp((1.0 - u) * (1.0 + u),
                               min=torch.finfo(torch.float32).tiny))

    # central branch (w < 5)
    wc = w - 2.5
    pc = 2.81022636e-08
    for c in (3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
              -0.00125372503, -0.00417768164, 0.246640727, 1.50140941):
        pc = c + pc * wc
    # tail branch (w >= 5)
    wt = torch.sqrt(torch.clamp(w, min=0.0)) - 3.0
    pt = -0.000200214257
    for c in (0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
              -0.0076224613, 0.00943887047, 1.00167406, 2.83297682):
        pt = c + pt * wt

    return torch.where(w < 5.0, pc, pt) * u
