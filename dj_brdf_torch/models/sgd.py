"""Shifted-Gamma-Distribution analytic BRDF fits.

Port of ``djb::sgd`` (dj_brdf.h:480-511, 3309-3500): an analytic
microfacet-style model with a per-channel SGD NDF and exponential-form
shadowing, fitted to each of the 100 MERL materials (parameters after
Bagher, Soler, Holzschuch, EGSR 2012). The fit table ships with the
port as ``models/data/material_tables.npz``, a copy of the JAX
package's file.

All 100 materials fit in one (100, 12, 3) tensor: a stack of materials
evaluates at once, its leading axes broadcast against the directions'.

Counterpart of ``dj_brdf_tpu/models/sgd.py``.
"""

from __future__ import annotations

import functools
import importlib.resources
import math

import numpy as np
import torch

from dj_brdf_torch.core.math import dot, normalize, sat
from dj_brdf_torch.core.pytree import pytree_dataclass
from dj_brdf_torch.fresnel import SGDFresnel

_FIELDS = {name: idx for idx, name in enumerate(
    ["rhoD", "rhoS", "alpha", "p", "f0", "f1", "kap", "lambda_",
     "c", "k", "theta0", "error"])}


@functools.lru_cache(maxsize=None)
def load_tables() -> dict:
    """The SGD and ABC fit tables (numpy arrays by name), read once."""
    path = (importlib.resources.files("dj_brdf_torch.models")
            / "data/material_tables.npz")
    with path.open("rb") as f:
        z = np.load(f)
        return {k: z[k] for k in z.files}


def material_names() -> list[str]:
    return [str(n) for n in load_tables()["sgd_names"]]


@pytree_dataclass
class SGD:
    """SGD BRDF for one material (or a stack: leading axes broadcast).
    ``params``: (..., 12, 3) rows of the fit table."""

    params: torch.Tensor

    @staticmethod
    def from_name(name: str, device="cuda") -> "SGD":
        """Name->row lookup on the host (reference sgd::sgd,
        dj_brdf.h:3435-3450); accepts either the MERL name or the
        alternate name column. The parameters go to ``device``, the card
        unless the caller asks for ``"cpu"``."""
        t = load_tables()
        names = [str(n) for n in t["sgd_names"]]
        other = [str(n) for n in t["sgd_other_names"]]
        if name in names:
            row = names.index(name)
        elif name in other:
            row = other.index(name)
        else:
            raise KeyError(f"no SGD parameters for {name!r}")
        return SGD(params=torch.as_tensor(t["sgd_params"][row],
                                          dtype=torch.float32, device=device))

    @staticmethod
    def all_materials(device="cuda") -> "SGD":
        """All 100 materials stacked on a leading axis, on ``device``."""
        return SGD(params=torch.as_tensor(load_tables()["sgd_params"],
                                          dtype=torch.float32, device=device))

    def _p(self, field):
        return self.params[..., _FIELDS[field], :]

    @property
    def fresnel(self):
        return SGDFresnel(f0=self._p("f0"), f1=self._p("f1"))

    def ndf(self, h):
        """Per-channel SGD NDF (reference sgd__ndf, dj_brdf.h:3424-3431)."""
        c2 = torch.clamp(h[..., 2:3] ** 2, min=1e-12)
        t2 = (1.0 - c2) / c2
        alpha = self._p("alpha")
        ax = alpha + t2 / alpha
        kap, p = self._p("kap"), self._p("p")
        return kap * torch.exp(-ax) / (math.pi * torch.pow(ax, p) * c2 * c2)

    def g1(self, k):
        """Exponential-form monodirectional shadowing (reference
        sgd__g1, dj_brdf.h:3415-3421)."""
        theta = torch.arccos(torch.clamp(k[..., 2:3], -1.0, 1.0))
        tmp1 = torch.clamp(theta - self._p("theta0"), min=0.0)
        tmp2 = 1.0 - torch.exp(self._p("c") * torch.pow(tmp1, self._p("k")))
        tmp3 = 1.0 + self._p("lambda_") * tmp2
        return torch.clamp(tmp3, 0.0, 1.0)

    def gaf(self, h, i, o):
        return self.g1(i) * self.g1(o)

    def eval(self, i, o):
        """(reference sgd::eval, dj_brdf.h:3454-3468)."""
        h = normalize(i + o, eps=1e-24)
        ks = self._p("rhoS")
        kd = self._p("rhoD")
        f = self.fresnel(sat(dot(i, h)))
        g = self.gaf(h, i, o)
        d = self.ndf(h)
        iz = i[..., 2:3]
        oz = o[..., 2:3]
        above = (iz > 0.0) & (oz > 0.0)
        denom = torch.where(above, iz * oz, 1.0)
        val = (kd + ks * (f * d * g) / denom) / math.pi
        return torch.where(above, val, 0.0)

    def evalp(self, i, o):
        return self.eval(i, o) * i[..., 2:3]
