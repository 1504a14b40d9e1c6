"""Synthetic measured-dataset baking.

Bakes any analytic BRDF into the MERL 90x90x180 half/diff binary
layout or the UTIA 6x48x6x48 layout. Used for tests and for driving the
measured-data paths (no measured datasets ship with the repo). The
bin-center angle conventions invert the reference's index warps
(dj_brdf.h:906-957 for MERL, 1082-1127 for UTIA).

Counterpart of ``dj_brdf_tpu/io/synth.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from dj_brdf_torch.core.math import from_spherical, hd_to_io
from dj_brdf_torch.models import merl as merl_mod
from dj_brdf_torch.models import utia as utia_mod


def bake_merl(eval_fn, device="cuda") -> torch.Tensor:
    """Evaluate ``eval_fn(i, o) -> (..., 3)`` at MERL bin centers, on
    ``device``: the card unless the caller asks for ``"cpu"`` (without a
    card the default raises). Returns a raw (3, 90, 90, 180)
    float64 table on that device (inverse channel scales applied;
    below-horizon bins set to -1 like real MERL files)."""
    nh, nd, npd = (merl_mod.RES_THETA_H, merl_mod.RES_THETA_D,
                   merl_mod.RES_PHI_D // 2)
    ih = np.arange(nh)
    theta_h = ((ih + 0.5) ** 2 / nh) * (np.pi / 2) / nh
    theta_d = (np.arange(nd) + 0.5) / nd * (np.pi / 2)
    phi_d = (np.arange(npd) + 0.5) / npd * np.pi
    TH, TD, PD = (torch.as_tensor(a, dtype=torch.float32, device=device)
                  for a in np.meshgrid(theta_h, theta_d, phi_d,
                                       indexing="ij"))

    h = from_spherical(TH, torch.zeros_like(TH))
    d = from_spherical(TD, PD)
    i, o = hd_to_io(h, d)
    vals = eval_fn(i, o).to(torch.float64)              # (nh, nd, npd, 3)
    below = (i[..., 2] <= 0.0) | (o[..., 2] <= 0.0)
    inv_scales = torch.tensor([1.0 / s for s in merl_mod.SCALES],
                              dtype=torch.float64, device=vals.device)
    table = torch.where(below[..., None], -1.0, vals * inv_scales)
    return torch.movedim(table, -1, 0).contiguous()    # (3, nh, nd, npd)


def bake_utia(eval_fn, device="cuda") -> torch.Tensor:
    """Evaluate ``eval_fn(i, o) -> (..., 3)`` at UTIA bin centers, on
    ``device``: the card unless the caller asks for ``"cpu"`` (without a
    card the default raises). Returns the raw (3, 6, 48, 6, 48) float64
    table in file units (the inverse of the sRGB-like decode and scales
    applied) on that device."""
    theta = np.arange(utia_mod.NTI) * utia_mod.STEP_T * np.pi / 180.0
    phi = np.arange(utia_mod.NPI) * utia_mod.STEP_P * np.pi / 180.0
    TI, PI, TV, PV = np.meshgrid(theta, phi, theta, phi, indexing="ij")
    # clamp the last elevation ring just above the horizon
    TI = np.minimum(TI, np.radians(89.0))
    TV = np.minimum(TV, np.radians(89.0))
    TI, PI, TV, PV = (torch.as_tensor(a, dtype=torch.float32, device=device)
                      for a in (TI, PI, TV, PV))
    vals = eval_fn(from_spherical(TI, PI), from_spherical(TV, PV))
    vals = torch.movedim(vals.to(torch.float64), -1, 0)  # (3, 6, 48, 6, 48)
    # invert eval's decode chain (dj_brdf.h:1146-1150): the table value t
    # satisfies eval = decode(t) * 100 with decode(t) = ((t+.055)/1.055)^2.4
    # for t > 0.0375 else t/12.92; the stored file value is t * 140
    decoded = vals / 100.0
    thr = 0.0375 / 12.92  # decoded-domain switch point
    t = torch.where(decoded > thr,
                    1.055 * torch.pow(torch.clamp(decoded, min=0.0),
                                      1.0 / 2.4) - 0.055,
                    decoded * 12.92)
    return (t * 140.0).contiguous()
