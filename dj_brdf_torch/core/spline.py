"""Piecewise-linear table lookup ("spline" in the reference).

Port of the reference's spline namespace (dj_brdf.h:1179-1249): a
table of N points is sampled at parameter ``u`` with index
``u * (N-1)``; the two neighbours are wrapped by either edge-clamp or
periodic repeat and lerped. Implemented as gathers (advanced indexing
on the leading axis), differentiable w.r.t. both ``u`` and the table.

Wrap modes are strings ("edge" | "repeat"), mirroring uwrap_edge
(dj_brdf.h:1191) / uwrap_repeat (dj_brdf.h:1183).
"""

from __future__ import annotations

import torch


def _wrap(i, n: int, mode: str):
    if mode == "edge":
        return torch.clamp(i, 0, n - 1)
    if mode == "repeat":
        return torch.remainder(i, n)
    raise ValueError(f"unknown wrap mode: {mode}")


def eval1d(points, u, wrap: str = "edge"):
    """Lerp lookup into ``points`` of shape (N, ...) at parameter u
    (reference spline::eval, dj_brdf.h:1208-1218)."""
    n = points.shape[0]
    t = u * (n - 1)
    i0 = torch.floor(t).to(torch.int64)
    frac = t - i0
    p0 = points[_wrap(i0, n, wrap)]
    p1 = points[_wrap(i0 + 1, n, wrap)]
    if points.dim() > 1:
        frac = frac[..., None]
    return p0 + frac * (p1 - p0)


def eval1d_stack(points, u):
    """:func:`eval1d` with ``wrap="edge"`` for a stack of tables:
    ``points`` (*B, N) looked up along its last axis at ``u`` (*Q) ->
    (*B, *Q). For a single (N,) table this is ``eval1d``, lerp for
    lerp."""
    n = points.shape[-1]
    t = u * (n - 1)
    i0 = torch.floor(t).to(torch.int64)
    frac = t - i0
    p0 = points[..., _wrap(i0, n, "edge")]
    p1 = points[..., _wrap(i0 + 1, n, "edge")]
    return p0 + frac * (p1 - p0)


def eval2d(points, u1, u2, wrap1: str = "edge", wrap2: str = "edge"):
    """Bilinear lookup into ``points`` of shape (H, W): u1 indexes the
    fast axis (W entries), u2 the slow axis (H entries) — matching the
    reference's flat ``points[i + w*j]`` layout (dj_brdf.h:1221-1247)."""
    h, w = points.shape[:2]
    t1 = u1 * (w - 1)
    t2 = u2 * (h - 1)
    i0 = torch.floor(t1).to(torch.int64)
    j0 = torch.floor(t2).to(torch.int64)
    f1 = t1 - i0
    f2 = t2 - j0
    i0w, i1w = _wrap(i0, w, wrap1), _wrap(i0 + 1, w, wrap1)
    j0w, j1w = _wrap(j0, h, wrap2), _wrap(j0 + 1, h, wrap2)
    flat = points.reshape(h * w, *points.shape[2:])
    p00 = flat[j0w * w + i0w]
    p10 = flat[j0w * w + i1w]
    p01 = flat[j1w * w + i0w]
    p11 = flat[j1w * w + i1w]
    if points.dim() > 2:
        f1 = f1[..., None]
        f2 = f2[..., None]
    a = p00 + f1 * (p10 - p00)
    b = p01 + f1 * (p11 - p01)
    return a + f2 * (b - a)
