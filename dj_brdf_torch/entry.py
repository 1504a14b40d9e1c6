"""The flagship forward: a differentiable sphere render of an
anisotropic GGX with Schlick Fresnel at res 256.

    forward, args = entry()         # on the card; entry("cpu") on the CPU
    img = forward(*args)            # (256, 256, 3)

Counterpart of ``__graft_entry__.py::entry()``; the JAX package jits
the forward, here it runs eagerly on the device of its arguments.
"""

from __future__ import annotations

import torch

from dj_brdf_torch import fresnel
from dj_brdf_torch.microfacet import brdf
from dj_brdf_torch.microfacet.ndf import GGX
from dj_brdf_torch.microfacet.params import MicrofacetParams
from dj_brdf_torch.render.sphere import render_sphere


def entry(device="cuda"):
    """``(forward, example_args)``: ``forward(params, f0, light_dir)``
    renders the sphere; the example arguments live on ``device``, the
    card unless the caller asks for ``"cpu"`` (without a card the default
    raises)."""
    dist = GGX()

    def forward(params, f0, light_dir):
        fres = fresnel.Schlick(f0=f0)
        return render_sphere(
            lambda i, o: brdf.evalp(dist, fres, params, i, o),
            light_dir, res=256)

    def scalar(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    example_args = (
        MicrofacetParams.elliptic(scalar(0.3), scalar(0.1), scalar(0.5)),
        torch.tensor([0.95, 0.64, 0.54], dtype=torch.float32, device=device),
        torch.tensor([0.3, 0.4, 0.8], dtype=torch.float32, device=device),
    )
    return forward, example_args
