"""Differentiable sphere shading — the renderer integration layer.

A directly lit sphere (the classic BRDF "matpreview" ball) rendered as
one batch of eager torch ops, differentiable end-to-end so pixel
gradients flow into BRDF parameters. Directions follow the
local-shading-frame convention of the library: per pixel the tangent
frame of the sphere normal expresses the world light/view directions,
mirroring how Mitsuba's ``its.toLocal`` feeds the reference's plugins
(mitsuba/dj_brdf.cpp:342-367).

Counterpart of ``dj_brdf_tpu/render/sphere.py``.
"""

from __future__ import annotations

import math

import torch

from dj_brdf_torch.core.math import dot, normalize, vec3


def sphere_normals(res: int, dtype=torch.float32, device=None):
    """Orthographic unit-sphere normals on a res x res pixel grid.
    Returns (normals (res,res,3), mask (res,res))."""
    xs = (torch.arange(res, dtype=dtype, device=device) + 0.5) / res \
        * 2.0 - 1.0
    X, Y = torch.meshgrid(xs, -xs, indexing="xy")  # image-space y down
    r2 = X * X + Y * Y
    inside = r2 < 1.0
    Z = torch.sqrt(torch.clamp(1.0 - r2, min=0.0))
    n = torch.stack([X, Y, torch.where(inside, Z, 1.0)], dim=-1)
    return normalize(n), inside


def _build_frame(n):
    """Tangent frame per normal (branchless Duff et al. style)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = vec3(1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0])
    bt = vec3(b, s + n[..., 1] * n[..., 1] * a, -n[..., 1])
    return t, bt


def world_to_local(n, v):
    """Express world direction v in the tangent frame of n."""
    t, bt = _build_frame(n)
    return vec3(dot(v, t), dot(v, bt), dot(v, n))


def sphere_uv(n):
    """Spherical UVs of unit normals: u = phi/2pi in [0,1), v = theta/pi
    (the role Mitsuba's uv footprints play for textured plugins,
    mitsuba/dj_beckmannconductor.cpp:285-297)."""
    theta = torch.arccos(torch.clamp(n[..., 2], -1.0, 1.0))
    phi = torch.atan2(n[..., 1], n[..., 0])
    u = torch.remainder(phi / (2.0 * math.pi), 1.0)
    return u, theta / math.pi


def sample_texture(tex, u, v):
    """Nearest-texel lookup of an (H, W, ...) texture at normalized uv
    (differentiable w.r.t. the texels)."""
    h, w = tex.shape[0], tex.shape[1]
    yi = torch.clamp((v * h).to(torch.int32), 0, h - 1).long()
    xi = torch.clamp((u * w).to(torch.int32), 0, w - 1).long()
    return tex[yi, xi]


def render_sphere(evalp_fn, light_dir, res: int = 256,
                  light_radiance=(1.0, 1.0, 1.0), view_dir=(0.0, 0.0, 1.0),
                  device=None):
    """Shade a directly lit sphere.

    ``evalp_fn(i, o) -> (..., 3)`` is any BRDF's f_r*cos in the local
    frame (e.g. ``partial(brdf.evalp, dist, fres, params)`` or
    ``Merl(...).evalp``). Returns an (res, res, 3) HDR image on
    ``device`` (default: ``light_dir``'s device if it is a tensor, else
    the card; pass ``"cpu"`` for the CPU). Differentiable w.r.t.
    anything captured by ``evalp_fn`` and the light direction."""
    if device is None:
        device = (light_dir.device if isinstance(light_dir, torch.Tensor)
                  else torch.device("cuda"))
    n, mask = sphere_normals(res, device=device)
    light = normalize(torch.as_tensor(light_dir, dtype=torch.float32,
                                      device=device))
    view = normalize(torch.as_tensor(view_dir, dtype=torch.float32,
                                     device=device))
    i = world_to_local(n, torch.broadcast_to(light, n.shape))
    o = world_to_local(n, torch.broadcast_to(view, n.shape))
    img = evalp_fn(i, o) * torch.as_tensor(light_radiance,
                                           dtype=torch.float32,
                                           device=device)
    visible = mask & (i[..., 2] > 0.0) & (o[..., 2] > 0.0)
    return torch.where(visible[..., None], img, 0.0)
