"""UTIA measured-BRDF evaluation.

Port of ``djb::utia`` (dj_brdf.h:1026-1177, after Jiri Filip's
implementation): a (3, 6, 48, 6, 48) table evaluated with quadrilinear
interpolation in *degree* space over (theta_i, phi_i, theta_v, phi_v),
followed by the per-channel sRGB-like decode and the x100 radiometric
scale. Differentiable w.r.t. both the directions and the table.

The table is pre-expanded into a *corner-packed* layout
``packed[(ti, pi, tv, pv), 16*3]`` holding each cell's full 2x2x2x2
interpolation neighbourhood contiguously (11 MB; phi axes wrapped, theta
axes need no clamp since i0 <= n-2): an evaluation is one 192-byte row
gather per sample and a 16-tap weighted sum. The gather is plain torch
(the JAX package's was XLA, not Pallas, on the TPU).

The load-time clamp of negatives and the 1/140 scale
(dj_brdf.h:1162-1177) are the loader's (:mod:`dj_brdf_torch.io.utia_io`),
as in ``utia::normalize``.

Counterpart of ``dj_brdf_tpu/models/utia.py``.
"""

from __future__ import annotations

import math

import torch

from dj_brdf_torch import config
from dj_brdf_torch.core.pytree import pytree_dataclass

STEP_T = 15.0
STEP_P = 7.5
NTI = 6
NPI = 48
NTV = 6
NPV = 48
TABLE_SHAPE = (3, NTI, NPI, NTV, NPV)
ROWS = (NTI - 1) * NPI * (NTV - 1) * NPV     # rows of the packed layout


def _axis_theta(theta_deg, n):
    """Edge-clamped linear bin + extrapolating weights (dj_brdf.h:1082-1111)."""
    i0 = torch.clamp(torch.floor(theta_deg / STEP_T).to(torch.int64),
                     max=n - 2)
    i1 = i0 + 1
    w1 = theta_deg - STEP_T * i0
    w0 = STEP_T * i1 - theta_deg
    s = w0 + w1
    return i0, i1, w0 / s, w1 / s


def _axis_phi(phi_deg, n):
    """Periodic azimuth bin: weights use the unwrapped upper index
    (dj_brdf.h:1095-1127)."""
    i0 = torch.floor(phi_deg / STEP_P).to(torch.int64)
    i1 = i0 + 1
    w1 = phi_deg - STEP_P * i0
    w0 = STEP_P * i1 - phi_deg
    s = w0 + w1
    i1 = torch.where(i1 == n, 0, i1)
    i0 = torch.clamp(i0, 0, n - 1)
    return i0, i1, w0 / s, w1 / s


def pack_corners(table):
    """(3, 6, 48, 6, 48) -> corner-packed (5*48*5*48, 16*3).

    Row r = ((ti0*48 + pi0)*5 + tv0)*48 + pv0 holds the 2x2x2x2 tap
    neighbourhood of base cell (ti0, pi0, tv0, pv0): tap
    k = ((dti*2 + dpi)*2 + dtv)*2 + dpv at channels [3k, 3k+3). Phi
    axes wrap (i1 = 0 after the last bin, dj_brdf.h:1123); theta axes
    need no wrap because the bin clamp keeps i0 <= n-2."""
    x = torch.movedim(torch.as_tensor(table), 0, -1)         # (6,48,6,48,3)
    x = torch.stack([x, torch.roll(x, -1, dims=3)], -1)      # ... dpv
    x = torch.stack([x[:, :, :NTV - 1], x[:, :, 1:NTV]], -1)  # ... dtv
    x = torch.stack([x, torch.roll(x, -1, dims=1)], -1)      # ... dpi
    x = torch.stack([x[:NTI - 1], x[1:NTI]], -1)             # ... dti
    # (5,48,5,48, 3, dpv, dtv, dpi, dti) -> (5,48,5,48, dti,dpi,dtv,dpv, 3)
    x = x.permute(0, 1, 2, 3, 8, 7, 6, 5, 4)
    return x.reshape(ROWS, 16 * 3)


def _angles_deg(i, o):
    r2d = 180.0 / math.pi
    theta_i = r2d * torch.arccos(torch.clamp(i[..., 2], -1.0, 1.0))
    theta_o = r2d * torch.arccos(torch.clamp(o[..., 2], -1.0, 1.0))
    phi_i = torch.remainder(r2d * torch.atan2(i[..., 1], i[..., 0]), 360.0)
    phi_o = torch.remainder(r2d * torch.atan2(o[..., 1], o[..., 0]), 360.0)
    return theta_i, theta_o, phi_i, phi_o


def _decode(rgb, below):
    """Per-channel sRGB-like decode + x100 scale (dj_brdf.h:1146-1150)."""
    decoded = torch.where(
        rgb > 0.0375,
        torch.pow(torch.clamp(rgb + 0.055, min=0.0) / 1.055, 2.4),
        rgb / 12.92) * 100.0
    decoded = torch.clamp(decoded, min=0.0)
    return torch.where(below[..., None], 0.0, decoded)


def gather_rows(packed, row):
    """``packed[row]``: the (..., 48) corner rows of each sample, read
    as one flat ``torch.take`` (``chip_smoke.py`` phase 17 times the
    three plain forms of this gather, ``take``, ``index_select`` and
    indexing, on the card)."""
    lane = torch.arange(packed.shape[-1], device=row.device)
    return torch.take(packed, row[..., None] * packed.shape[-1] + lane)


def corner_taps(i, o):
    """The packed row of each sample's base cell (..., int64), its 16 tap
    weights (..., 16) in :func:`pack_corners`' order, and the
    below-horizon mask (reference utia::eval, dj_brdf.h:1063-1145)."""
    theta_i, theta_o, phi_i, phi_o = _angles_deg(i, o)

    below = (theta_i >= 90.0) | (theta_o >= 90.0)
    # clamp angles fed to the interpolator so gathers stay in range;
    # the result is masked out anyway when below the horizon
    theta_i = torch.clamp(theta_i, max=90.0)
    theta_o = torch.clamp(theta_o, max=90.0)

    iti0, _, wti0, wti1 = _axis_theta(theta_i, NTI)
    itv0, _, wtv0, wtv1 = _axis_theta(theta_o, NTV)
    ipi0, _, wpi0, wpi1 = _axis_phi(phi_i, NPI)
    ipv0, _, wpv0, wpv1 = _axis_phi(phi_o, NPV)
    row = ((iti0 * NPI + ipi0) * (NTV - 1) + itv0) * NPV + ipv0

    # weight order matches pack_corners: k = ((dti*2+dpi)*2+dtv)*2+dpv
    wt = torch.stack([wti0, wti1], -1)                     # (..., 2)
    wp = torch.stack([wpi0, wpi1], -1)
    wv = torch.stack([wtv0, wtv1], -1)
    wq = torch.stack([wpv0, wpv1], -1)
    w = (wt[..., :, None, None, None] * wp[..., None, :, None, None]
         * wv[..., None, None, :, None] * wq[..., None, None, None, :])
    return torch.clamp(row, 0, ROWS - 1), w.reshape(*w.shape[:-4], 16), below


@pytree_dataclass
class Utia:
    """UTIA table BRDF. ``table``: (3, NTI, NPI, NTV, NPV) after the
    loader's clamp + 1/140 normalization. ``packed``: optional
    corner-packed layout from :func:`pack_corners`; built on the fly
    when absent (construct via :meth:`build` to amortize it).

    The tables take :func:`~dj_brdf_torch.config.default_float` where
    they enter (float32 unless ``config.use_x64()``), on the device they
    come on; evaluation runs there."""

    table: torch.Tensor
    packed: torch.Tensor | None = None

    def __post_init__(self):
        ft = config.default_float()
        object.__setattr__(self, "table", torch.as_tensor(self.table).to(ft))
        if self.packed is not None:
            object.__setattr__(self, "packed",
                               torch.as_tensor(self.packed).to(ft))

    @classmethod
    def build(cls, table):
        """Construct with the packed fast-eval layout precomputed."""
        table = torch.as_tensor(table).to(config.default_float())
        return cls(table=table, packed=pack_corners(table))

    def eval(self, i, o):
        """f_r (reference utia::eval, dj_brdf.h:1063-1157). Returns (..., 3)."""
        row, w, below = corner_taps(i, o)
        packed = self.packed if self.packed is not None \
            else pack_corners(self.table)
        taps = gather_rows(packed, row)
        taps = taps.reshape(*taps.shape[:-1], 16, 3)
        rgb = torch.sum(w[..., None] * taps, dim=-2)
        return _decode(rgb, below)

    def evalp(self, i, o):
        return self.eval(i, o) * i[..., 2:3]
