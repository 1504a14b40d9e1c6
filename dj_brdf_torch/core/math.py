"""Vector math on ``(..., 3)`` tensors.

Port of the reference's scalar ``vec3`` utilities (dj_brdf.h:570-766):
everything here is branchless, broadcasts over leading batch
dimensions, and is differentiable. There is no vector class — a
direction is just the last axis of a tensor.
"""

from __future__ import annotations

import math

import torch

# Rec.709 luma weights (reference vec3::intensity, dj_brdf.h:69).
_LUMA = (0.2126, 0.7152, 0.0722)


def as_float(*xs):
    """Tensors of one floating dtype and device from tensors or Python
    numbers (the counterpart of ``jnp.asarray(x, result_type(float,
    ...))``): floating tensors set the dtype and device, plain numbers
    take the default float type."""
    tensors = [x for x in xs if isinstance(x, torch.Tensor)]
    floats = [t.dtype for t in tensors if t.dtype.is_floating_point]
    dtype = floats[0] if floats else torch.get_default_dtype()
    for d in floats[1:]:
        dtype = torch.promote_types(dtype, d)
    device = tensors[0].device if tensors else None
    return tuple(torch.as_tensor(x, dtype=dtype, device=device) for x in xs)


def vec3(x, y, z):
    """Stack components into a (..., 3) tensor."""
    return torch.stack(torch.broadcast_tensors(*as_float(x, y, z)), dim=-1)


def from_spherical(theta, phi):
    """Direction from spherical angles (reference vec3(theta,phi) ctor,
    dj_brdf.h:589-595)."""
    theta, phi = as_float(theta, phi)
    s = torch.sin(theta)
    return vec3(s * torch.cos(phi), s * torch.sin(phi),
                torch.cos(theta) * torch.ones_like(phi))


def to_spherical(p):
    """(theta, phi) from a direction, with pole clamps matching
    xyz_to_theta_phi (dj_brdf.h:650-661)."""
    z = p[..., 2]
    near_np = z > 0.99999
    near_sp = z < -0.99999
    theta = torch.where(near_np, 0.0, torch.where(
        near_sp, math.pi, torch.arccos(torch.clamp(z, -1.0, 1.0))))
    phi = torch.where(near_np | near_sp, 0.0,
                      torch.atan2(p[..., 1], p[..., 0]))
    return theta, phi


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def normalize(v, eps: float = 0.0):
    """Unit vector; safe under autograd (no 0/0 when eps>0)."""
    mag_sqr = dot(v, v)
    if eps:
        mag_sqr = torch.clamp(mag_sqr, min=eps)
    return v * torch.rsqrt(mag_sqr)[..., None]


def intensity(rgb):
    """Rec.709 luma (reference vec3::intensity, dj_brdf.h:69)."""
    w = torch.as_tensor(_LUMA, dtype=rgb.dtype, device=rgb.device)
    return torch.sum(rgb * w, dim=-1)


def sat(x):
    """Saturate to [0, 1] (reference sat, dj_brdf.h:576)."""
    return torch.clamp(x, 0.0, 1.0)


def rotate_vector(x, axis, angle):
    """Rodrigues axis-angle rotation (reference rotate_vector,
    dj_brdf.h:754-765). ``axis`` must be unit length."""
    angle = torch.as_tensor(angle, dtype=x.dtype, device=x.device)
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    return x * c + axis * (dot(axis, x) * (1.0 - c.squeeze(-1)))[..., None] \
        + cross(axis, x) * s


def _axis(like, k: int):
    e = torch.zeros(3, dtype=like.dtype, device=like.device)
    e[k] = 1.0
    return e.expand(like.shape)


def io_to_hd(i, o):
    """(i, o) -> (h, d) Rusinkiewicz transform (reference brdf::io_to_hd,
    dj_brdf.h:771-781): h = normalize(i+o); d = i rotated into the frame
    where h is the pole."""
    h = normalize(i + o)
    theta_h, phi_h = to_spherical(h)
    tmp = rotate_vector(i, _axis(i, 2), -phi_h)
    d = normalize(rotate_vector(tmp, _axis(i, 1), -theta_h))
    return h, d


def hd_to_io(h, d):
    """(h, d) -> (i, o) inverse Rusinkiewicz transform (reference
    brdf::hd_to_io, dj_brdf.h:783-793)."""
    theta_h, phi_h = to_spherical(h)
    tmp = rotate_vector(d, _axis(h, 1), theta_h)
    i = normalize(rotate_vector(tmp, _axis(h, 2), phi_h))
    o = normalize(2.0 * dot(i, h)[..., None] * h - i)
    return i, o


def reflect(o, h):
    """Mirror o about h."""
    return 2.0 * dot(o, h)[..., None] * h - o


def uniform_to_concentric(u1, u2):
    """Square -> disk concentric map, branchless (reference
    uniform_to_concentric, dj_brdf.h:726-747, after Dave Cline)."""
    r1 = 2.0 * u1 - 1.0
    r2 = 2.0 * u2 - 1.0
    use_r1 = r1 * r1 > r2 * r2
    r = torch.where(use_r1, r1, r2)
    # guard divisions at the origin
    safe_r1 = torch.where(r1 == 0.0, 1.0, r1)
    safe_r2 = torch.where(r2 == 0.0, 1.0, r2)
    phi = torch.where(use_r1,
                      (math.pi / 4.0) * (r2 / safe_r1),
                      (math.pi / 2.0) - (r1 / safe_r2) * (math.pi / 4.0))
    degenerate = (r1 == 0.0) & (r2 == 0.0)
    r = torch.where(degenerate, 0.0, r)
    phi = torch.where(degenerate, 0.0, phi)
    return r * torch.cos(phi), r * torch.sin(phi)


def cosine_hemisphere_sample(u1, u2):
    """Cosine-weighted hemisphere direction via the concentric map
    (reference brdf::sample default, dj_brdf.h:830-840)."""
    x, y = uniform_to_concentric(u1, u2)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return vec3(x, y, z)
