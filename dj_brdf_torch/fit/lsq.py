"""Autodiff nonlinear least-squares BRDF fitting.

Fits microfacet parameters + Schlick Fresnel directly to measured data
by gradient descent (Adam) on a differentiable loss. GGX-family and
Beckmann fits go through the fused fit step
(:mod:`dj_brdf_torch.ops.fused_fit`: the CUDA kernel on the GPU, its
plain version on the CPU); other distributions, and ``fused="never"``,
use torch autograd over the layered :func:`make_loss`.

Counterpart of ``dj_brdf_tpu/fit/lsq.py``: ``optax.adam`` becomes
``torch.optim.Adam`` with the same formulas (eps added after the
square root of the bias-corrected second moment), and the
``lax.scan`` over steps a Python loop.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from dj_brdf_torch import fresnel as fresnel_mod
from dj_brdf_torch.microfacet import brdf as mf
from dj_brdf_torch.microfacet.ndf import GGX, Beckmann
from dj_brdf_torch.microfacet.params import MicrofacetParams
from dj_brdf_torch.ops import soa
from dj_brdf_torch.ops.fused_fit import fused_fit_loss


class RawFit(NamedTuple):
    """Unconstrained parameterization of (MicrofacetParams, Schlick f0)."""
    log_ax: torch.Tensor
    log_ay: torch.Tensor
    raw_rho: torch.Tensor
    txn: torch.Tensor
    tyn: torch.Tensor
    logit_f0: torch.Tensor  # (3,)


def raw_init(alpha: float = 0.3, f0: float = 0.5, device=None) -> RawFit:
    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    a = math.log(alpha)
    return RawFit(log_ax=full((), a), log_ay=full((), a),
                  raw_rho=full((), 0.0), txn=full((), 0.0),
                  tyn=full((), 0.0),
                  logit_f0=full((3,), math.log(f0 / (1 - f0))))


def raw_to_model(raw: RawFit):
    """Map unconstrained leaves to valid microfacet + fresnel params."""
    params = MicrofacetParams(
        ax=torch.exp(raw.log_ax) + 1e-4,
        ay=torch.exp(raw.log_ay) + 1e-4,
        rho=0.99 * torch.tanh(raw.raw_rho),
        txn=raw.txn, tyn=raw.tyn)
    fres = fresnel_mod.Schlick(f0=torch.sigmoid(raw.logit_f0))
    return params, fres


def relative_l2(pred, target, eps: float = 1e-2):
    """Relative squared error — standard for HDR BRDF fitting (keeps
    highlights from drowning out the falloff)."""
    return torch.mean(((pred - target) / (target + eps)) ** 2)


def make_loss(dist, shadow: bool = True,
              loss_fn: Callable = relative_l2):
    def loss(raw: RawFit, i, o, target):
        params, fres = raw_to_model(raw)
        pred = mf.evalp(dist, fres, params, i, o, shadow)
        return loss_fn(pred, target)
    return loss


def fused_eligible(dist, shadow: bool = True):
    """The fused-kernel family ("ggx" or "beck") when the fit shape
    matches the hand-adjoint kernel (ops/fused_fit.py): GGX-family or
    Beckmann distribution, height-correlated Smith shadowing, the
    standard RawFit parameterization — the reference's co-equal fit
    pair (dj_brdf.h:3133-3184). None otherwise."""
    if not shadow:
        return None
    if isinstance(dist, GGX):
        return "ggx"
    if type(dist) is Beckmann:
        return "beck"
    return None


def target_planes(target):
    """(..., N, 3) targets -> three contiguous (..., N) channel planes.
    Done once per fit, outside the step loop: the kernel takes no
    strided view."""
    return tuple(target[..., c].contiguous() for c in range(3))


def make_fused_value_and_grad(i, o, target, family: str = "ggx"):
    """Build the GGX/Beckmann + Schlick fit step through the hand-written
    adjoint (the CUDA kernel for CUDA tensors, its plain version for CPU
    tensors). The 8-scalar chain through ``raw_to_pvec`` is pulled back
    by torch autograd.

    Returns ``(value_and_grad, data)`` where
    ``value_and_grad(raw, *data) -> (loss, grad_raw)`` and ``data`` is
    the 9-tuple of contiguous component tensors."""
    comp = tuple(c.contiguous() for c in soa.split_dirs(i, o))
    data = (*comp, *target_planes(target))

    def loss(raw: RawFit, ix, iy, iz, ox, oy, oz, tr, tg, tb):
        return fused_fit_loss(soa.raw_to_pvec(raw)[None], ix, iy, iz, ox, oy,
                              oz, tr[None], tg[None], tb[None],
                              family=family)[0]

    return layered_value_and_grad(loss), data


def layered_value_and_grad(loss):
    """``value_and_grad`` of a ``loss(raw, *data)`` by torch autograd —
    the counterpart of ``jax.value_and_grad``."""
    def value_and_grad(raw: RawFit, *data):
        raw = RawFit(*(t.detach().requires_grad_(True) for t in raw))
        val = loss(raw, *data)
        return val.detach(), RawFit(*torch.autograd.grad(val, raw))
    return value_and_grad


def adam_loop(vg, raw: RawFit, data, steps: int, lr: float):
    """Run ``steps`` Adam steps of ``vg(raw, *data) -> (value,
    grad_raw)`` from ``raw``; returns the final RawFit and the
    ``(steps, ...)`` values, each taken before its step's update (as
    the reference's ``lax.scan`` records them). Nothing here waits for
    the device."""
    leaves = [t.detach().clone() for t in raw]
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    values = []
    for _ in range(steps):
        val, grads = vg(RawFit(*leaves), *data)
        for leaf, g in zip(leaves, grads):
            leaf.grad = g
        opt.step()
        values.append(val)
    return RawFit(*leaves), torch.stack(values)


def fit_lsq(dist, i, o, target, steps: int = 200, lr: float = 5e-2,
            init: RawFit | None = None, shadow: bool = True,
            fused: str = "auto"):
    """Fit (MicrofacetParams, Schlick) to ``target = evalp(i, o)``.

    ``fused``: "auto" routes GGX-family and Beckmann fits through the
    fused fit step (:func:`make_fused_value_and_grad`); "never" forces
    the layered autograd path (other distributions always use it).
    Runs on the device of ``i``.

    Returns (params, fresnel, losses) with ``losses`` of shape
    ``(steps,)``."""
    if fused not in ("auto", "never"):
        raise ValueError(f"fused must be auto|never, got {fused!r}")
    raw = init if init is not None else raw_init(device=i.device)

    family = fused_eligible(dist, shadow)
    if fused == "auto" and family:
        vg, data = make_fused_value_and_grad(i, o, target, family=family)
    else:
        vg = layered_value_and_grad(make_loss(dist, shadow))
        data = (i, o, target)

    raw, losses = adam_loop(vg, raw, data, steps, lr)
    params, fres = raw_to_model(raw)
    return params, fres, losses
