"""ABC analytic BRDF fits.

Port of ``djb::abc`` (dj_brdf.h:513-535, 3502-3668):
D(h) = A / (1 + B (1 - cos theta_h))^C with a V-cavity min-style GAF
and exact unpolarized Fresnel from a scalar ior, fitted per MERL
material (parameters provided to the reference by Joel Kronander; the
table ships with the port in ``models/data/material_tables.npz``).

Counterpart of ``dj_brdf_tpu/models/abc_model.py``.
"""

from __future__ import annotations

import math

import torch

from dj_brdf_torch.core.math import dot, normalize, sat
from dj_brdf_torch.core.pytree import pytree_dataclass
from dj_brdf_torch.fresnel import Unpolarized
from dj_brdf_torch.models.sgd import load_tables

_COLUMNS = ("kd", "a", "b", "c", "ior")


def material_names() -> list[str]:
    return [str(n) for n in load_tables()["abc_names"]]


@pytree_dataclass
class ABC:
    """ABC BRDF for one material (or a broadcast stack)."""

    kd: torch.Tensor   # (..., 3)
    a: torch.Tensor    # (..., 3)
    b: torch.Tensor    # (...,)
    c: torch.Tensor    # (...,)
    ior: torch.Tensor  # (...,)

    @staticmethod
    def _rows(rows, device) -> "ABC":
        t = load_tables()
        return ABC(**{k: torch.as_tensor(t[f"abc_{k}"][rows],
                                         dtype=torch.float32, device=device)
                      for k in _COLUMNS})

    @staticmethod
    def from_name(name: str, device="cuda") -> "ABC":
        """(reference abc::abc, dj_brdf.h:3617-3629). The parameters go
        to ``device``, the card unless the caller asks for ``"cpu"``."""
        names = material_names()
        if name not in names:
            raise KeyError(f"no ABC parameters for {name!r}")
        return ABC._rows(names.index(name), device)

    @staticmethod
    def all_materials(device="cuda") -> "ABC":
        """All 100 materials stacked on a leading axis, on ``device``."""
        return ABC._rows(slice(None), device)

    @property
    def fresnel(self):
        ior3 = torch.broadcast_to(self.ior[..., None], self.ior.shape + (3,))
        return Unpolarized(ior=ior3)

    def ndf(self, h):
        """(reference abc__ndf, dj_brdf.h:3608-3613), as
        exp(-C log1p(B (1 - cos))): accurate in f32 even for the extreme
        B values of the chrome/obsidian fits, and cheaper than pow."""
        tmp = 1.0 - h[..., 2:3]
        return self.a * torch.exp(-self.c[..., None]
                                  * torch.log1p(self.b[..., None] * tmp))

    def gaf(self, h, i, o):
        """V-cavity-style min GAF (reference abc::gaf, dj_brdf.h:3649-3655)."""
        hi = torch.where(dot(h, i) == 0.0, 1e-12, dot(h, i))
        ho = torch.where(dot(h, o) == 0.0, 1e-12, dot(h, o))
        g1_i = torch.clamp(2.0 * (h[..., 2] * i[..., 2] / hi), max=1.0)
        g1_o = torch.clamp(2.0 * (h[..., 2] * o[..., 2] / ho), max=1.0)
        return torch.minimum(g1_i, g1_o)

    def eval(self, i, o):
        """(reference abc::eval, dj_brdf.h:3633-3645)."""
        h = normalize(i + o, eps=1e-24)
        f = self.fresnel(sat(dot(i, h)))
        g = self.gaf(h, i, o)[..., None]
        d = self.ndf(h)
        iz = i[..., 2:3]
        oz = o[..., 2:3]
        above = (iz > 0.0) & (oz > 0.0)
        denom = torch.where(above, math.pi * iz * oz, 1.0)
        val = self.kd / math.pi + (f * d * g) / denom
        return torch.where(above, val, 0.0)

    def evalp(self, i, o):
        return self.eval(i, o) * i[..., 2:3]
