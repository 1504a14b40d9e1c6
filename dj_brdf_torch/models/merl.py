"""MERL measured-BRDF evaluation.

Port of ``djb::merl`` (dj_brdf.h:870-1024): the 90x90x180x3 table
lives on the device as one f32 tensor (~17.5 MB); evaluation is the
angle transform (Rusinkiewicz io->hd in closed component form, no
Rodrigues rotations), the three MERL index warps (non-linear sqrt
theta_h bin, reciprocity-folded phi_d), and one gather of the three
channels per sample. The index maths is torch ops; the gather is
:func:`dj_brdf_torch.ops.merl_gather.merl_lookup` (the hand-written
CUDA kernel on the GPU, its plain version on the CPU).

A :class:`Merl` may hold a stack of tables, ``(*B, 3, 90, 90, 180)``:
all tables are then looked up at the same directions in one lookup
call (one kernel launch, or at large N a pack and a lookup launch per
pair of tables: ``merl_gather.lookup_packs``), and the result carries
the stack's axes first,
``(*B, *dirs, 3)`` — the written-out form of the JAX package's
``vmap`` over tables.

Lookup is nearest-neighbour, exactly like the reference. Binary file
I/O lives in :mod:`dj_brdf_torch.io.merl_io`.

Counterpart of ``dj_brdf_tpu/models/merl.py``.
"""

from __future__ import annotations

import logging
import math

import torch

from dj_brdf_torch import config
from dj_brdf_torch.config import logger
from dj_brdf_torch.core.pytree import pytree_dataclass
from dj_brdf_torch.ops import merl_gather
from dj_brdf_torch.utils.profiling import span

RES_THETA_H = 90
RES_THETA_D = 90
RES_PHI_D = 360  # table stores RES_PHI_D / 2 = 180 bins (reciprocity)
TABLE_SHAPE = (3, RES_THETA_H, RES_THETA_D, RES_PHI_D // 2)
PLANE = RES_THETA_H * RES_THETA_D * (RES_PHI_D // 2)  # entries a channel

#: Per-channel radiometric scales (dj_brdf.h:897-899).
RED_SCALE = 1.00 / 1500.0
GREEN_SCALE = 1.15 / 1500.0
BLUE_SCALE = 1.66 / 1500.0
SCALES = (RED_SCALE, GREEN_SCALE, BLUE_SCALE)


def theta_half_index(theta_half):
    """Non-linear sqrt-warped theta_h bin (dj_brdf.h:906-920)."""
    theta_half_deg = theta_half / (math.pi / 2.0) * RES_THETA_H
    temp = torch.sqrt(torch.clamp(theta_half_deg * RES_THETA_H, min=0.0))
    idx = torch.clamp(torch.floor(temp).to(torch.int32), 0, RES_THETA_H - 1)
    return torch.where(theta_half <= 0.0, 0, idx)


def theta_diff_index(theta_diff):
    """(dj_brdf.h:926-936)."""
    idx = torch.floor(theta_diff / (math.pi * 0.5) * RES_THETA_D)
    return torch.clamp(idx.to(torch.int32), 0, RES_THETA_D - 1)


def phi_diff_index(phi_diff):
    """Reciprocity fold phi_d -> phi_d + pi for negative phi_d
    (dj_brdf.h:940-957)."""
    phi_diff = torch.where(phi_diff < 0.0, phi_diff + math.pi, phi_diff)
    idx = torch.floor(phi_diff / math.pi * (RES_PHI_D // 2))
    return torch.clamp(idx.to(torch.int32), 0, RES_PHI_D // 2 - 1)


def hd_angles(i, o):
    """(theta_h, theta_d, phi_d) of the Rusinkiewicz transform in closed
    component form: the two axis rotations of brdf::io_to_hd
    (dj_brdf.h:771-781) collapse to arithmetic on the components of h
    (cos(phi_h) = h.x/rho etc.), so only the three output angles cost a
    transcendental. Matches to_spherical's pole clamps
    (dj_brdf.h:650-661)."""
    h = i + o
    h = h * torch.rsqrt(torch.clamp(torch.sum(h * h, dim=-1),
                                    min=1e-24))[..., None]
    hx, hy, hz = h[..., 0], h[..., 1], h[..., 2]
    rho = torch.sqrt(torch.clamp(hx * hx + hy * hy, min=0.0))
    # at the pole the reference uses phi_h = 0 (to_spherical clamp)
    at_pole = hz > 0.99999
    inv_rho = torch.where(rho > 0.0, 1.0 / torch.clamp(rho, min=1e-24), 1.0)
    cos_ph = torch.where(at_pole, 1.0, hx * inv_rho)
    sin_ph = torch.where(at_pole, 0.0, hy * inv_rho)
    sin_th = torch.where(at_pole, 0.0, rho)
    cos_th = torch.where(at_pole, 1.0, hz)

    ix, iy, iz = i[..., 0], i[..., 1], i[..., 2]
    t = cos_ph * ix + sin_ph * iy
    dx = cos_th * t - sin_th * iz
    dy = -sin_ph * ix + cos_ph * iy
    dz = sin_th * t + cos_th * iz
    # io_to_hd normalizes d (rotation of a unit vector: renormalize only
    # against rounding drift)
    dn = torch.rsqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-24))
    dx, dy, dz = dx * dn, dy * dn, dz * dn

    theta_h = torch.where(at_pole, 0.0,
                          torch.arccos(torch.clamp(hz, -1.0, 1.0)))
    d_pole = dz > 0.99999
    theta_d = torch.where(d_pole, 0.0,
                          torch.arccos(torch.clamp(dz, -1.0, 1.0)))
    phi_d = torch.where(d_pole, 0.0, torch.atan2(dy, dx))
    return theta_h, theta_d, phi_d


def merl_flat_index(i, o):
    """Angle transform + the three MERL bin warps -> int32 flat index
    into a (90*90*180,) channel plane (dj_brdf.h:906-957, 987-1006)."""
    theta_h, theta_d, phi_d = hd_angles(i, o)
    ih = theta_half_index(theta_h)
    id_ = theta_diff_index(theta_d)
    ip = phi_diff_index(phi_d)
    return (ih * RES_THETA_D + id_) * (RES_PHI_D // 2) + ip


def _debug_below_horizon(tables, idx) -> None:
    """The reference's per-eval "below horizon" warning
    (dj_brdf.h:1016-1021), as one count per eval batch. Computed only
    when the logger is at DEBUG, so the default path adds no device
    work and no host sync."""
    if not logger.isEnabledFor(logging.DEBUG):
        return
    s = torch.tensor(SCALES, dtype=tables.dtype, device=tables.device)
    raw = tables[:, :, idx.clamp(0, PLANE - 1).long()]      # (M, 3, N)
    count = int(torch.any(raw * s[:, None] < 0.0, dim=1).sum())
    if count > 0:
        logger.debug("merl eval: %d below-horizon lookups set to 0", count)


@pytree_dataclass
class Merl:
    """MERL table BRDF. ``table``: (3, 90, 90, 180) raw (unscaled)
    samples, channel-major like the binary file, or a stack
    (*B, 3, 90, 90, 180) of such tables.

    The table takes :func:`~dj_brdf_torch.config.default_float` where it
    enters, once (the JAX package's ``Merl`` does the same when its
    numpy table becomes a ``jnp`` array): a float64 ``bake_merl`` or
    file table is looked up in float32, and evaluates to float32.
    Under :func:`~dj_brdf_torch.config.use_x64` it stays float64: on the
    CPU the lookup then runs in float64, as the JAX package's does under
    x64; on the card it raises a ``TypeError`` that names ``use_x64``,
    since the lookup kernels are float32 only.

    Gradients w.r.t. the table and, through ``evalp``'s ``i.z``, w.r.t.
    ``i``, as JAX's ``jnp.take`` gives them: on CPU tensors by autograd of
    the plain lookup, on the card by the lookup's backward
    (:class:`~dj_brdf_torch.ops.merl_gather.MerlLookupGrad`)."""

    table: torch.Tensor

    def __post_init__(self):
        table = torch.as_tensor(self.table)
        object.__setattr__(self, "table", table.to(config.default_float()))

    def _lookup(self, i, o, iz_of=None):
        if tuple(self.table.shape[-4:]) != TABLE_SHAPE:
            raise ValueError(f"MERL table must be (*B, 3, 90, 90, 180), got "
                             f"{tuple(self.table.shape)}")
        batch = self.table.shape[:-4]
        with span("dj.merl.lookup"):
            tables = self.table.reshape(-1, 3, PLANE)
            idx = merl_flat_index(i, o)
            flat = idx.reshape(-1).contiguous()
            iz = None
            if iz_of is not None:
                iz = torch.broadcast_to(iz_of[..., 2], idx.shape).reshape(-1)
                iz = iz.to(tables.dtype).contiguous()
            _debug_below_horizon(tables, flat)
            rgb = merl_gather.merl_lookup(tables, flat, SCALES, iz)
            return rgb.reshape(*batch, *idx.shape, 3)

    def eval(self, i, o):
        """f_r lookup (reference merl::eval, dj_brdf.h:987-1024).
        Returns (*B, ..., 3); negative raw entries (below-horizon) map
        to 0."""
        return self._lookup(i, o)

    def evalp(self, i, o):
        """f_r * cos(theta_i): the lookup times ``i.z``, in the same
        kernels."""
        return self._lookup(i, o, iz_of=i)
