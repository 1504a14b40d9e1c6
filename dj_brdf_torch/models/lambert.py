"""Lambertian BRDF (reference djb::lambert, dj_brdf.h:111-123, 847-868).

Counterpart of ``dj_brdf_tpu/models/lambert.py``.
"""

from __future__ import annotations

import math

import torch

from dj_brdf_torch.core.pytree import pytree_dataclass


@pytree_dataclass
class Lambert:
    """Constant-albedo BRDF: f_r = reflectance / pi."""

    reflectance: torch.Tensor  # (..., 3)

    def eval(self, i, o):
        shape = torch.broadcast_shapes(i[..., 2].shape, o[..., 2].shape)
        return torch.broadcast_to(self.reflectance / math.pi, shape + (3,))

    def evalp(self, i, o):
        return self.eval(i, o) * i[..., 2:3]
