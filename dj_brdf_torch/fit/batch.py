"""Batch fitting of many materials at once.

The reference loops over MERL files one at a time
(examples/merl_params.cpp:53-68); here the whole material set is
fitted in one loop: the M materials share one direction set, their
RawFit leaves carry a leading material axis, and each step is one
launch of the fused fit kernel over all M materials (its plain version
on the CPU). MERL tables stack on a leading axis in the same way:
``merl_targets`` looks all M up at the shared directions in one call
of the lookup kernels, and ``tabulate_merl_batch`` runs the tabulation
pipeline on the whole stack at once.

Counterpart of ``dj_brdf_tpu/fit/batch.py``. Sharding the material
axis over several devices (``mesh``) is not ported yet.
"""

from __future__ import annotations

import math

import torch

from dj_brdf_torch.core.math import from_spherical
from dj_brdf_torch.fit import lsq
from dj_brdf_torch.microfacet import brdf as mf
from dj_brdf_torch.microfacet.ndf import GGX
from dj_brdf_torch.models.merl import Merl
from dj_brdf_torch.ops import soa
from dj_brdf_torch.ops.fused_fit import fused_fit_loss


def sample_direction_set(n: int, generator: torch.Generator,
                         device="cuda"):
    """A shared random direction set for fitting targets: i and o with
    theta uniform in [0.03, 1.5) and phi uniform in [0, 2 pi), each
    (n, 3) float32 on ``device``, the card unless the caller asks for
    ``"cpu"`` (``generator`` must live there; without a card the default
    raises)."""
    def uniform(lo, hi):
        u = torch.rand(n, generator=generator, device=device,
                       dtype=torch.float32)
        return lo + (hi - lo) * u

    i = from_spherical(uniform(0.03, 1.5), uniform(0.0, 2 * math.pi))
    o = from_spherical(uniform(0.03, 1.5), uniform(0.0, 2 * math.pi))
    return i, o


def merl_targets(tables, i, o):
    """Evaluate a stack of MERL tables at the direction set:
    (M, 3, 90, 90, 180) -> (M, N, 3) of f_r cos(theta_i), for
    :func:`fit_materials`."""
    return Merl(table=tables).evalp(i, o)


def tabulate_merl_batch(tables, res: int = 90, shadow: bool = True,
                        mesh=None):
    """Run the full tabulation pipeline (dj_brdf.h:2215-2236) on a
    *stack* of MERL tables at once, on the tables' device: the batched
    form of the reference's per-file loop in examples/merl_params.cpp:
    53-68. Returns ``(Tabular stack, fresnel points stack (M, res, 3),
    beckmann alphas (M,), ggx alphas (M,))``.

    This is :func:`~dj_brdf_torch.fit.tabular.build_tabular` on a
    :class:`Merl` holding the whole stack: every stage carries the
    material axis, each MERL lookup is one kernel launch for all M
    tables, and the 4-step power iteration is one batched (M, 89, 89)
    float64 matvec on the same device, like the reference's
    double-precision ``matrix`` class."""
    from dj_brdf_torch.fit import moments
    from dj_brdf_torch.fit.tabular import build_tabular

    if mesh is not None:
        raise NotImplementedError(
            "tabulate_merl_batch: sharding over a device mesh is not "
            "ported yet")
    dists, fres = build_tabular(Merl(table=torch.as_tensor(tables)), res,
                                shadow)
    ab = moments.fit_beckmann_parameters(dists).ax
    ag = moments.fit_ggx_parameters(dists).ax
    return dists, fres.points, ab, ag


def fit_materials(targets, i, o, steps: int = 300, lr: float = 5e-2,
                  mesh=None, dist=GGX(), fused: str = "auto"):
    """Fit per-material (MicrofacetParams, Schlick) to ``targets``
    (M, N, 3) at the shared directions ``i``, ``o`` (N, 3).

    ``fused="auto"`` routes GGX-family and Beckmann fits through the
    fused fit step (one kernel launch per step for all M materials on
    the GPU); "never" keeps the layered autograd path. The optimizer
    minimises the mean loss over materials, whose gradient separates
    per material.

    Returns ``(params, fresnel, losses)`` with (M,)-leaved params, (M, 3)
    f0 and the (M,) per-material losses of the last step."""
    if fused not in ("auto", "never"):
        raise ValueError(f"fused must be 'auto' or 'never', got {fused!r}")
    if mesh is not None:
        raise NotImplementedError(
            "fit_materials: sharding over a device mesh is not ported yet")

    m = targets.shape[0]
    raw0 = lsq.RawFit(*(leaf.expand((m,) + leaf.shape).clone()
                        for leaf in lsq.raw_init(device=targets.device)))
    family = lsq.fused_eligible(dist)

    if fused == "auto" and family is not None:
        comp = tuple(c.contiguous() for c in soa.split_dirs(i, o))
        data = (*comp, *lsq.target_planes(targets))   # planes (M, N)

        def per_material(raw, *data):
            return fused_fit_loss(soa.raw_to_pvec(raw), *data, family=family)
    else:
        data = (i, o, targets)

        def per_material(raw, i, o, targets):
            # material axis first, broadcast against the (N,) samples
            params, fres = lsq.raw_to_model(
                lsq.RawFit(*(leaf[:, None] for leaf in raw)))
            pred = mf.evalp(dist, fres, params, i, o)
            return (((pred - targets) / (targets + 1e-2)) ** 2).mean((-2, -1))

    def vg(raw, *data):
        raw = lsq.RawFit(*(t.detach().requires_grad_(True) for t in raw))
        per_mat = per_material(raw, *data)
        grads = torch.autograd.grad(per_mat.mean(), raw)
        return per_mat.detach(), lsq.RawFit(*grads)

    raw, per_mat = lsq.adam_loop(vg, raw0, data, steps, lr)
    params, fres = lsq.raw_to_model(raw)
    return params, fres, per_mat[-1]
