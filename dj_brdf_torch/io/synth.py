"""Synthetic measured-dataset baking.

Bakes any analytic BRDF into the MERL 90x90x180 half/diff binary
layout. Used for tests and for driving the measured-data path (no
measured datasets ship with the repo). The bin-center angle
conventions invert the reference's index warps (dj_brdf.h:906-957).

Counterpart of ``dj_brdf_tpu/io/synth.py``; ``bake_utia`` is not
ported yet (it needs ``models/utia``).
"""

from __future__ import annotations

import numpy as np
import torch

from dj_brdf_torch.core.math import from_spherical, hd_to_io
from dj_brdf_torch.models import merl as merl_mod


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
