"""The fused fit step: loss and gradient in one pass over the samples.

On CUDA tensors this runs the hand-written Hopper kernel
``csrc/fused_fit.cu`` (built on first use, see :mod:`._build`); on CPU
tensors it runs the kernel's plain version,
:func:`~dj_brdf_torch.ops.soa.ggx_lsq_fwdbwd_soa` or
:func:`~dj_brdf_torch.ops.soa.beckmann_lsq_fwdbwd_soa`. A CUDA tensor
never reaches the plain version: the kernel runs, or the call raises.

Gradients are w.r.t. the 8 constrained parameters
[ax, ay, rho, txn, tyn, f0r, f0g, f0b]; the chain through
``fit.lsq.raw_to_model`` comes from torch autograd around
:class:`FusedFitLoss`.

``ggx_lsq_value_and_grad(..., adjoint="ad")`` is the cross-check of
that hand adjoint: the same GGX loss with its gradient derived a second
way, by the forward-mode dual numbers of ``csrc/fused_fit_ad.cu`` on
CUDA tensors, and by ``torch.autograd`` of the eager
:func:`~dj_brdf_torch.ops.soa.ggx_lsq_loss_soa` (its plain version) on
CPU tensors.

Counterpart of ``dj_brdf_tpu/ops/fused_fit.py``. The TPU knobs
``block_rows``, ``interpret`` and ``pad_to_block`` have no counterpart:
the CUDA kernels mask their own ragged tail.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from dj_brdf_torch.ops import soa
from dj_brdf_torch.utils.profiling import span

#: launches of the CUDA kernel in this process (plain-version
#: calls on CPU tensors do not count)
LAUNCHES = 0
#: launches of the autodiff cross-check kernel (``adjoint="ad"``), counted
#: apart from the hand-adjoint kernel's
LAUNCHES_AD = 0

FAMILIES = {"ggx": 0, "beck": 1}
ADJOINTS = ("hand", "ad")
_PLAIN = {"ggx": soa.ggx_lsq_fwdbwd_soa, "beck": soa.beckmann_lsq_fwdbwd_soa}
_LIB = "fused_fit"
_LIB_AD = "fused_fit_ad"


@functools.cache
def _lib():
    """The built kernel library with its C signatures declared; built on
    first use."""
    from dj_brdf_torch.ops import _build

    lib = _build.load(_LIB)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.djbt_fused_fit.argtypes = ([i32, i32] + [ptr] * 10
                                   + [ctypes.c_longlong] + [i32] * 4
                                   + [ptr] * 4)
    lib.djbt_fused_fit.restype = i32
    lib.djbt_fused_fit_tile.argtypes = []
    lib.djbt_fused_fit_tile.restype = i32
    lib.djbt_fused_fit_occupancy.argtypes = ([i32] * 3
                                             + [ctypes.POINTER(i32)] * 2)
    lib.djbt_fused_fit_occupancy.restype = i32
    lib.djbt_error_string.argtypes = [i32]
    lib.djbt_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"fused fit kernel {what} failed: "
                           f"{_lib().djbt_error_string(err).decode()} ({err})")


@functools.cache
def occupancy(device_index, family, m):
    """Resident CTAs per SM of the kernel of ``family`` on the device for
    ``m`` materials: ``(with the running sums in global memory, with them
    in shared memory)``, 0 where they do not fit (the query also sets the
    kernel's shared-memory limit there)."""
    ctas, ctas_smem = ctypes.c_int(), ctypes.c_int()
    _raise_on(_lib().djbt_fused_fit_occupancy(
        device_index, FAMILIES[family], m, ctypes.byref(ctas),
        ctypes.byref(ctas_smem)), "occupancy query")
    return ctas.value, ctas_smem.value


class Schedule(NamedTuple):
    """One launch of the persistent kernel: ``ntiles`` direction tiles;
    the CTAs' running sums in shared memory where ``acc_in_smem``, else
    in their rows of partials; ``ctas_per_sm`` CTAs resident per SM;
    ``grid`` CTAs, each a contiguous slice of the ``ntiles * m`` (tile,
    material) units; the epilogue sums the CTAs' partial rows in
    ``groups`` groups of ``group`` CTAs."""
    ntiles: int
    acc_in_smem: bool
    ctas_per_sm: int
    grid: int
    group: int
    groups: int


def launch_schedule(n, m, tile, sms, ctas_per_sm, ctas_sums_in_smem):
    """The launch of the fused fit kernel for ``m`` materials and ``n``
    samples, ``tile`` samples per tile, on a card of ``sms`` SMs that
    holds ``ctas_per_sm`` CTAs of the kernel each, or
    ``ctas_sums_in_smem`` with the running sums in shared memory.

    The running sums go to shared memory unless that leaves fewer CTAs
    resident. The grid fills the card once (no more CTAs than units),
    and the epilogue groups are ceil(sqrt(grid)) CTAs, so that neither
    level sums more than ~sqrt of the grid's rows."""
    ntiles = -(-n // tile)
    if ntiles * m > 2**31 - 1:
        raise ValueError(f"N = {n}, M = {m}: too many (tile, material) "
                         "units for one launch")
    if ctas_per_sm < 1:
        raise RuntimeError("fused fit kernel: no CTA of it fits on an SM")
    grid = max(1, min(sms * ctas_per_sm, ntiles * m))
    group = math.isqrt(grid - 1) + 1
    return Schedule(ntiles, ctas_sums_in_smem >= ctas_per_sm, ctas_per_sm,
                    grid, group, -(-grid // group))


def schedule_for(device, n, m, family):
    """The :class:`Schedule` of a launch on ``device``."""
    return launch_schedule(
        n, m, _lib().djbt_fused_fit_tile(),
        torch.cuda.get_device_properties(device).multi_processor_count,
        *occupancy(device.index, family, m))


#: per (device, stream): the epilogue's tickets, zero between launches
_TICKETS: dict = {}


def _tickets(device, stream, count):
    key = (device.index, stream)
    if key not in _TICKETS or _TICKETS[key].numel() < count:
        _TICKETS[key] = torch.zeros(max(count, 64), dtype=torch.int32,
                                    device=device)
    return _TICKETS[key]


@functools.cache
def _lib_ad():
    """The built autodiff cross-check library, signatures declared."""
    from dj_brdf_torch.ops import _build

    lib = _build.load(_LIB_AD)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.djbt_fused_fit_ad.argtypes = ([i32] + [ptr] * 10
                                      + [ctypes.c_longlong, i32]
                                      + [ptr] * 4)
    lib.djbt_fused_fit_ad.restype = i32
    lib.djbt_fused_fit_ad_unit.argtypes = []
    lib.djbt_fused_fit_ad_unit.restype = i32
    lib.djbt_fused_fit_ad_occupancy.argtypes = [i32, ctypes.POINTER(i32)]
    lib.djbt_fused_fit_ad_occupancy.restype = i32
    lib.djbt_fused_fit_ad_error_string.argtypes = [i32]
    lib.djbt_fused_fit_ad_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on_ad(err, what):
    if err != 0:
        raise RuntimeError(
            f"autodiff fit kernel {what} failed: "
            f"{_lib_ad().djbt_fused_fit_ad_error_string(err).decode()} "
            f"({err})")


@functools.cache
def occupancy_ad(device_index):
    """Resident CTAs per SM of the autodiff cross-check kernel."""
    ctas = ctypes.c_int()
    _raise_on_ad(_lib_ad().djbt_fused_fit_ad_occupancy(
        device_index, ctypes.byref(ctas)), "occupancy query")
    return ctas.value


class AdSchedule(NamedTuple):
    """One launch of the autodiff cross-check kernel: ``units`` runs of
    ``unit`` samples; ``grid`` CTAs, CTA b taking the units
    ``[units * b // grid, units * (b + 1) // grid)``."""
    units: int
    grid: int


def ad_schedule(n, unit, sms, ctas_per_sm):
    """The persistent launch of K4 for ``n`` samples: as many CTAs as the
    card holds (``sms`` SMs of ``ctas_per_sm``), no more than units."""
    units = -(-n // unit)
    if ctas_per_sm < 1:
        raise RuntimeError("autodiff fit kernel: no CTA of it fits on an SM")
    return AdSchedule(units, max(1, min(sms * ctas_per_sm, units)))


def ad_schedule_for(device, n):
    """The :class:`AdSchedule` of a launch on ``device``."""
    return ad_schedule(
        n, _lib_ad().djbt_fused_fit_ad_unit(),
        torch.cuda.get_device_properties(device).multi_processor_count,
        occupancy_ad(device.index))


def _check(pvecs, dirs, tgts, family):
    if family not in FAMILIES:
        raise ValueError(f"family must be 'ggx' or 'beck', got {family!r}")
    tensors = (pvecs, *dirs, *tgts)
    device = pvecs.device
    if any(t.device != device for t in tensors):
        raise ValueError("fused fit: all tensors must be on one device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(
            "fused fit: all tensors must be float32, got "
            f"{sorted({str(t.dtype) for t in tensors})}; the fit takes "
            "config.default_float(), which config.use_x64() makes float64 "
            "(the JAX package's fit fails under x64 as well)")
    m = pvecs.shape[0]
    n = dirs[0].shape[-1]
    if pvecs.shape != (m, 8) or m == 0:
        raise ValueError(f"pvecs must be (M, 8) with M > 0, got "
                         f"{tuple(pvecs.shape)}")
    if n == 0 or any(d.shape != (n,) for d in dirs):
        raise ValueError("directions must be six (N,) tensors with N > 0, "
                         f"got {[tuple(d.shape) for d in dirs]}")
    if any(t.shape != (m, n) for t in tgts):
        raise ValueError(f"targets must be three (M, N) = ({m}, {n}) "
                         f"tensors, got {[tuple(t.shape) for t in tgts]}")
    return m, n


def plain_fwdbwd_sums(pvecs, dirs, tgts, family="ggx", chunk=8):
    """The kernel's plain version for M materials: ``(loss_sum (M,),
    grad_sum (M, 8))``, summed (not averaged) over samples. Runs on any
    device, ``chunk`` materials at a time so that the intermediates of
    a large (M, N) batch fit in memory."""
    m, _ = _check(pvecs, dirs, tgts, family)
    losses, grads = [], []
    for k in range(0, m, chunk):
        pv = pvecs[k:k + chunk].T[:, :, None]       # (8, C, 1)
        ls, gs = _PLAIN[family](pv, *dirs, *(t[k:k + chunk] for t in tgts))
        losses.append(ls)
        grads.append(gs)
    return torch.cat(losses), torch.cat(grads)


def kernel_fwdbwd_sums(pvecs, dirs, tgts, family="ggx"):
    """Launch the CUDA kernel: ``(loss_sum (M,), grad_sum (M, 8))``.
    Raises on anything the kernel does not take (CPU or strided
    tensors included) and on a failed launch."""
    global LAUNCHES
    m, n = _check(pvecs, dirs, tgts, family)
    tensors = (pvecs, *dirs, *tgts)
    if pvecs.device.type != "cuda":
        raise ValueError(f"the fused fit kernel needs CUDA tensors, got "
                         f"{pvecs.device}")
    if not all(t.is_contiguous() for t in tensors):
        # a strided view (e.g. targets[..., c]) would be read wrongly:
        # make the planes contiguous once, outside the step loop
        raise ValueError("fused fit kernel: every tensor must be contiguous")
    device = pvecs.device
    sched = schedule_for(device, n, m, family)
    partials = torch.empty((sched.grid + sched.groups, m * 9),
                           dtype=torch.float64, device=device)
    out = torch.empty((m, 9), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    tickets = _tickets(device, stream, sched.groups + 1)
    _raise_on(_lib().djbt_fused_fit(
        device.index, FAMILIES[family],
        *(t.data_ptr() for t in tensors), n, m, sched.grid,
        int(sched.acc_in_smem), sched.group,
        partials.data_ptr(), tickets.data_ptr(), out.data_ptr(), stream),
        "launch")
    LAUNCHES += 1
    return out[:, 0], out[:, 1:]


def fwdbwd_sums(pvecs, dirs, tgts, family="ggx"):
    """Dispatch on the tensors' device: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    with span("dj.fit.kernel"):
        if pvecs.device.type == "cpu":
            return plain_fwdbwd_sums(pvecs, dirs, tgts, family)
        return kernel_fwdbwd_sums(pvecs, dirs, tgts, family)


def plain_ad_sums(pvec, dirs, tgts):
    """K4's plain version: ``(loss_sum, grad_sum (8,))`` of the GGX loss
    of one material, summed (not averaged) over samples, the gradient
    from ``torch.autograd`` of the eager
    :func:`~dj_brdf_torch.ops.soa.ggx_lsq_loss_soa` (the JAX kernel's
    ``jax.vjp``, scaled to a sum as ``_kernel_ad`` does). Runs on any
    device."""
    _, n = _check(pvec[None], dirs, tuple(t[None] for t in tgts), "ggx")
    with torch.enable_grad():
        pv = pvec.detach().requires_grad_(True)
        loss = soa.ggx_lsq_loss_soa(pv, *dirs, *tgts) * n
        (grad,) = torch.autograd.grad(loss, pv)
    return loss.detach(), grad


def kernel_ad_sums(pvec, dirs, tgts):
    """Launch the autodiff cross-check kernel: ``(loss_sum, grad_sum
    (8,))``. Raises on anything the kernel does not take (CPU or strided
    tensors included) and on a failed launch."""
    global LAUNCHES_AD
    _, n = _check(pvec[None], dirs, tuple(t[None] for t in tgts), "ggx")
    tensors = (pvec, *dirs, *tgts)
    if pvec.device.type != "cuda":
        raise ValueError(f"the autodiff fit kernel needs CUDA tensors, got "
                         f"{pvec.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("autodiff fit kernel: every tensor must be "
                         "contiguous")
    device = pvec.device
    sched = ad_schedule_for(device, n)
    partials = torch.empty((sched.grid, 9), dtype=torch.float64,
                           device=device)
    out = torch.empty(9, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    _raise_on_ad(_lib_ad().djbt_fused_fit_ad(
        device.index, *(t.data_ptr() for t in tensors), n, sched.grid,
        partials.data_ptr(), _tickets(device, stream, 1).data_ptr(),
        out.data_ptr(), stream), "launch")
    LAUNCHES_AD += 1
    return out[0], out[1:]


class FusedFitLoss(torch.autograd.Function):
    """Per-material fit loss ``(M,)`` with the kernel's gradient.

    Forward runs the fused step once and keeps its (M, 8) gradient sum
    divided by ``n_valid``; backward scales it by the incoming
    per-material gradient, so ``loss.mean().backward()`` yields the
    gradient of the mean over materials."""

    @staticmethod
    def forward(ctx, pvecs, ix, iy, iz, ox, oy, oz, tr, tg, tb, n_valid,
                family):
        loss_sum, grad_sum = fwdbwd_sums(
            pvecs.detach(), (ix, iy, iz, ox, oy, oz), (tr, tg, tb), family)
        ctx.save_for_backward(grad_sum / n_valid)
        return loss_sum / n_valid

    @staticmethod
    def backward(ctx, grad_out):
        (grad,) = ctx.saved_tensors
        return (grad_out[:, None] * grad,) + (None,) * 11


def fused_fit_loss(pvecs, ix, iy, iz, ox, oy, oz, tr, tg, tb,
                   n_valid=None, family="ggx"):
    """Differentiable per-material loss ``(M,)`` of the fused step."""
    n = ix.shape[-1] if n_valid is None else n_valid
    return FusedFitLoss.apply(pvecs, ix, iy, iz, ox, oy, oz, tr, tg, tb,
                              float(n), family)


def ggx_lsq_value_and_grad(pvec, ix, iy, iz, ox, oy, oz, tr, tg, tb,
                           n_valid: int | None = None, family: str = "ggx",
                           adjoint: str = "hand"):
    """Returns (loss, grad(8,)) for the relative-L2 microfacet+Schlick
    fit of one material (``family``: "ggx" or "beck" — the reference's
    co-equal fit pair, dj_brdf.h:3133-3184). Inputs are flat f32
    tensors of any length N; ``n_valid`` (default N) divides the sums.
    ``adjoint`` selects how the gradient is derived: "hand" (the
    analytic adjoint, default) or "ad" (automatic differentiation, the
    cross-check; GGX only)."""
    if adjoint not in ADJOINTS:
        raise ValueError(f"adjoint must be 'hand' or 'ad', got {adjoint!r}")
    if adjoint == "ad":
        if family != "ggx":
            raise ValueError("adjoint='ad' cross-check exists for the GGX "
                             f"loss only, got family={family!r}")
        dirs, tgts = (ix, iy, iz, ox, oy, oz), (tr, tg, tb)
        sums = plain_ad_sums if pvec.device.type == "cpu" else kernel_ad_sums
        loss_sum, grad_sum = sums(pvec, dirs, tgts)
        n = ix.shape[-1] if n_valid is None else n_valid
        return loss_sum / n, grad_sum / n
    loss, grad = ggx_lsq_value_and_grad_batched(
        pvec[None], ix, iy, iz, ox, oy, oz, tr[None], tg[None], tb[None],
        n_valid=n_valid, family=family)
    return loss[0], grad[0]


def ggx_lsq_value_and_grad_batched(pvecs, ix, iy, iz, ox, oy, oz,
                                   tr, tg, tb, n_valid: int | None = None,
                                   mean_over_materials: bool = False,
                                   family: str = "ggx"):
    """Batched fused fit step: M materials against a SHARED direction
    set — the device form of the reference's per-file loop
    (examples/merl_params.cpp:53-68).

    ``pvecs``: (M, 8) constrained parameter rows. Directions ix..oz:
    flat (N,) shared across materials; targets tr/tg/tb: (M, N) per
    material, contiguous. Returns ``(loss (M,), grad (M, 8))``; with
    ``mean_over_materials`` the grads are additionally divided by M
    (the gradient of the mean loss, what a joint optimizer wants)."""
    loss_sum, grad_sum = fwdbwd_sums(pvecs, (ix, iy, iz, ox, oy, oz),
                                     (tr, tg, tb), family)
    n = ix.shape[-1] if n_valid is None else n_valid
    loss, grad = loss_sum / n, grad_sum / n
    if mean_over_materials:
        grad = grad / pvecs.shape[0]
    return loss, grad
