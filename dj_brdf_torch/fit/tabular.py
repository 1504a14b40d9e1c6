"""Isotropic tabulation pipeline: extract a microfacet NDF + Fresnel
from any BRDF by power iteration.

Port of the ``djb::tabular`` constructor pipeline (dj_brdf.h:2215-2236):

    compute_p22_smith -> normalize_p22 -> compute_sigma ->
    compute_fresnel -> compute_cdf -> compute_qf

The reference's serial scalar loops become batched tensor expressions.
Its quadrature grids, weights, float_t accumulation of the phi loop,
the unnormalized 4-step power iteration in float64 and the 1e-2 scale
are replicated exactly, as in the JAX package.

BRDF inputs are either *eval functions* ``eval_fn(i, o) -> (..., 3)``
or model objects with an ``.eval(i, o)`` method (``Merl``, ...). A
model's tables set the device the pipeline runs on; a bare eval
function (or a model without tensors) runs on ``device``, the card
unless the caller asks for ``"cpu"``. Every stage also takes a *stack* of models
or tables: a :class:`~dj_brdf_torch.models.merl.Merl` holding
(M, 3, 90, 90, 180) tables yields (M, ...) tables at every stage, all
M looked up in one kernel launch per stage (the written-out form of
the JAX package's ``vmap``).

Precision follows ``config.default_float()`` (the reference's
DJB_USE_DOUBLE_PRECISION switch, dj_brdf.h:44-48); the power iteration
is always float64, like the reference's ``matrix`` class.

Counterpart of ``dj_brdf_tpu/fit/tabular.py``.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from dj_brdf_torch import config
from dj_brdf_torch import fresnel as fresnel_mod
from dj_brdf_torch.core import spline
from dj_brdf_torch.core.math import from_spherical, hd_to_io, intensity
from dj_brdf_torch.core.pytree import tensor_fields
from dj_brdf_torch.microfacet import brdf as mf
from dj_brdf_torch.microfacet.ndf import Tabular
from dj_brdf_torch.microfacet.params import MicrofacetParams
from dj_brdf_torch.utils.profiling import span

_NP_FLOAT = {torch.float32: np.float32, torch.float64: np.float64}
_f = config.round_to


def as_model_eval(brdf):
    """Normalize a BRDF argument to ``(eval(model, i, o), model)``.

    ``brdf`` may be a bare callable (model=None) or an object with
    ``.eval``."""
    if callable(brdf) and not hasattr(brdf, "eval"):
        return (lambda _model, i, o: brdf(i, o)), None
    return (lambda model, i, o: model.eval(i, o)), brdf


def _device(model, device):
    """The device of a model's first tensor field; ``device`` for a
    bare eval function or a model without tensors."""
    for name in tensor_fields(model) if model is not None else ():
        value = getattr(model, name)
        if isinstance(value, torch.Tensor):
            return value.device
    return torch.device(device)


def _phi_grid(dtype) -> np.ndarray:
    """The reference's inner phi loop accumulates a float_t step
    (dj_brdf.h:2499, 2508): replicate the accumulation in the active
    precision so the step count and node positions match bit for bit."""
    ft = _NP_FLOAT[dtype]
    step = ft(np.pi / 180.0)
    two_pi = ft(2.0 * np.pi)
    vals = []
    phi = ft(0.0)
    while phi < two_pi:
        vals.append(phi)
        phi = ft(phi + step)
    return np.asarray(vals, ft)


def _kernel_matrix(eval_fn, model, res: int,
                   device="cuda") -> torch.Tensor:
    """The (*B, cnt, cnt) retro-reflective kernel matrix A with
    A[i, j] = K(j, i) so that one power-iteration step is ``A @ v``
    (reference tabular::compute_p22_smith kernel build,
    dj_brdf.h:2482-2515 + the matrix layout of 2442-2465)."""
    ft = config.default_float()
    dev = _device(model, device)
    cnt = res - 1
    dtheta = np.sqrt(np.pi * 0.5) / cnt

    t = (torch.arange(cnt, dtype=ft, device=dev) / cnt) \
        * _f(np.sqrt(np.pi * 0.5), ft)
    theta = t * t  # angles in [0, pi/2)
    cos_theta = torch.cos(theta)
    tan_theta = torch.tan(theta)

    # column terms: retro-reflective BRDF slice fr(theta_o, theta_o)
    d = from_spherical(theta, torch.zeros_like(theta))
    fr_i = intensity(eval_fn(model, d, d).to(ft))            # (*B, cnt)
    kji_tmp = (_f(dtheta, ft) * cos_theta ** 6) * (8.0 * fr_i)

    # inner phi integral: nint[j, i] = sum_phi max(1, tan_j tan_i cos(phi)) dphi
    phis = torch.as_tensor(_phi_grid(ft), device=dev)
    tan_prod = tan_theta[:, None] * tan_theta[None, :]  # (j, i)
    nint = torch.sum(torch.clamp(tan_prod[..., None] * torch.cos(phis),
                                 min=1.0), dim=-1) * _f(np.pi / 180.0, ft)

    # K[j, i] = theta_j * kji_tmp_i * nint_ji * tan_j / cos_j^2;
    # matrix::transform computes out[i] = sum_j K(j, i) v[j], so return
    # the transpose A[i, j] = K(j, i)
    K = (t[:, None] * kji_tmp[..., None, :] * nint
         * (tan_theta / cos_theta ** 2)[:, None])
    return K.transpose(-1, -2)


def _power_iteration(A, iterations: int = 4) -> torch.Tensor:
    """Unnormalized power iteration from an all-ones start in float64
    (reference matrix::eigenvector, dj_brdf.h:2467-2480: the matrix
    class is always double whatever float_t is), then the 1e-2 scale and
    trailing zero of compute_p22_smith (:2517-2521). ``A`` (*B, n, n);
    runs on A's device and returns (*B, n + 1) in the default float
    type."""
    A = A.to(torch.float64)
    v = torch.ones(A.shape[:-1], dtype=torch.float64, device=A.device)
    for _ in range(iterations):
        v = torch.matmul(A, v[..., None])[..., 0]
    zero = torch.zeros(A.shape[:-2] + (1,), dtype=torch.float64,
                       device=A.device)
    return torch.cat([1e-2 * v, zero], dim=-1).to(config.default_float())


def compute_p22_smith(brdf, res: int, iterations: int = 4,
                      device="cuda") -> torch.Tensor:
    """Kernel build + power iteration (reference
    tabular::compute_p22_smith, dj_brdf.h:2482-2522). Returns the
    (*B, res) unnormalized p22 table. ``device`` as in
    :func:`build_tabular`."""
    eval_fn, model = as_model_eval(brdf)
    return _power_iteration(_kernel_matrix(eval_fn, model, res, device),
                            iterations)


def _radial_grid(n, ft, device):
    """u = k/n, theta_h = u^2 pi/2, its cos and tan, and the spline
    parameter sqrt(2 atan(tan theta_h)/pi) of p22_radial."""
    u = torch.arange(n, dtype=ft, device=device) / n
    theta_h = u * u * _f(np.pi * 0.5, ft)
    cos_h = torch.cos(theta_h)
    r_h = torch.tan(theta_h)
    uu = torch.sqrt(2.0 * torch.arctan(r_h) / math.pi)
    return u, theta_h, cos_h, r_h, uu


def normalize_p22(p22: torch.Tensor, return_nint: bool = False):
    """128-pt u^2-warped quadrature normalization (reference
    tabular::normalize_p22, dj_brdf.h:2277-2304)."""
    ft = p22.dtype
    ntheta = 128
    u, _, cos_theta_h, r_h, uu = _radial_grid(ntheta, ft, p22.device)
    p22_r = spline.eval1d_stack(p22, uu)
    nint = torch.sum((u * p22_r * r_h) / (cos_theta_h * cos_theta_h), dim=-1)
    nint = nint * _f(np.pi / ntheta, ft) * _f(2.0 * np.pi, ft)
    if return_nint:
        return p22 / nint[..., None], nint
    return p22 / nint[..., None]


def compute_sigma(p22: torch.Tensor) -> torch.Tensor:
    """Projected-area table via a (res x 90 x 180) contraction
    (reference tabular::compute_sigma, dj_brdf.h:2348-2386)."""
    ft = p22.dtype
    dev = p22.device
    cnt = p22.shape[-1] - 1
    ntheta, nphi = 90, 180

    theta_k = (torch.arange(cnt, dtype=ft, device=dev) / cnt) \
        * _f(0.5 * np.pi, ft)
    cos_k = torch.cos(theta_k)
    sin_k = torch.sin(theta_k)

    u_i, theta_h, cos_h, _, uu = _radial_grid(ntheta, ft, dev)
    sin_h = torch.sin(theta_h)
    phi_h = (torch.arange(nphi, dtype=ft, device=dev) / nphi) \
        * _f(2.0 * np.pi, ft)

    # ndf at standard params: p22_radial(tan^2) / cos^4 (dj_brdf.h:1559-1587)
    ndf_h = spline.eval1d_stack(p22, uu) / cos_h ** 4

    # kh[k, j2, j1]; the table-independent clamp is summed over phi
    # first, then weighted per theta_h by each table's ndf
    kh = (sin_k[:, None, None] * (sin_h * torch.cos(phi_h)[:, None])[None]
          + (cos_k[:, None] * cos_h[None, :])[:, None, :])
    kh_phi = torch.sum(torch.clamp(kh, min=0.0), dim=1)      # (cnt, ntheta)
    weight = ndf_h * u_i * sin_h                             # (*B, ntheta)
    nint = torch.sum(kh_phi * weight[..., None, :], dim=-1)
    nint = nint * _f(np.pi / ntheta, ft) * _f(2.0 * np.pi / nphi, ft)
    sigma = torch.maximum(cos_k, nint)
    return torch.cat([sigma, sigma[..., -1:]], dim=-1)


def compute_fresnel(brdf, p22: torch.Tensor, sigma: torch.Tensor,
                    res: int, shadow: bool = True) -> torch.Tensor:
    """Average measured/microfacet ratio per theta_d with i pinned to
    the normal (reference tabular::compute_fresnel, dj_brdf.h:2583-2641
    including the 'XXX hack' at :2609). Returns (*B, res, 3) spline
    points."""
    eval_fn, model = as_model_eval(brdf)
    return _fresnel_points(eval_fn, model, p22, sigma, res, shadow)


def _fresnel_points(eval_fn, model, p22, sigma, res, shadow):
    dist = Tabular(p22=p22, sigma=sigma, cdf=torch.zeros_like(p22),
                   qf=torch.zeros_like(p22))
    return fresnel_ratio_points(eval_fn, model, dist, res, shadow, p22.dtype)


def fresnel_ratio_points(eval_fn, model, dist, res, shadow, dtype):
    """Shared Fresnel-extraction core (reference compute_fresnel,
    dj_brdf.h:2583-2641): per-theta_d average of measured/microfacet
    ratios with i pinned to the normal (the reference's "XXX hack",
    :2609), ratios capped at 1. ``dist`` is the microfacet proxy the
    ratio divides by."""
    ft = dtype
    dev = dist.p22.device
    cnt = res - 1
    # MicrofacetParams.standard(), on the tables' device
    params = MicrofacetParams.isotropic(torch.tensor(1.0, dtype=ft,
                                                     device=dev))
    ideal = fresnel_mod.Ideal()
    half_pi = _f(np.pi * 0.5, ft)

    theta_d = (torch.arange(cnt, dtype=ft, device=dev) / cnt) * half_pi

    # the reference's j-loop runs while theta_h(j-1) < pi/2 - theta_d,
    # recomputing theta_h(j) in the body; so j participates iff
    # theta_h(j-1) < pi/2 - theta_d (and theta_h(j) <= pi/2)
    nj = 2 * cnt
    j = torch.arange(nj, dtype=ft, device=dev)
    theta_h = (j / cnt) ** 2 * half_pi                       # (nj,)
    theta_h_prev = torch.cat([torch.zeros(1, dtype=ft, device=dev),
                              theta_h[:-1]])
    active = (theta_h_prev[None, :] < (half_pi - theta_d[:, None])) \
        & (theta_h[None, :] <= half_pi)                      # (cnt, nj)

    # (cnt, nj) direction pairs via hd -> io, then i := z (the hack)
    TH = torch.broadcast_to(theta_h[None, :], (cnt, nj))
    TD = torch.broadcast_to(theta_d[:, None], (cnt, nj))
    dir_h = from_spherical(TH, torch.zeros_like(TH))
    dir_d = from_spherical(TD, torch.full_like(TD, half_pi))
    _, dir_o = hd_to_io(dir_h, dir_d)
    dir_i = torch.broadcast_to(
        torch.tensor([0.0, 0.0, 1.0], dtype=ft, device=dev), dir_o.shape)

    fr1 = eval_fn(model, dir_i, dir_o).to(ft)                # (*B, cnt, nj, 3)
    fr2 = mf.eval(dist, ideal, params, dir_i, dir_o, shadow)

    ok = active[..., None] & (fr2 > 1e-4)
    ratio = torch.where(ok, fr1 / torch.where(ok, fr2, 1.0), 0.0)
    count = torch.sum(ok, dim=-2)                            # (*B, cnt, 3)
    total = torch.sum(ratio, dim=-2)
    avg = torch.where(count == 0, 1.0,
                      torch.clamp(total / torch.clamp(count, min=1), max=1.0))
    return torch.cat([avg, avg[..., -1:, :]], dim=-2)        # copy last row


def compute_cdf(p22: torch.Tensor) -> torch.Tensor:
    """Cumulative radial slope CDF (reference tabular::compute_cdf,
    dj_brdf.h:2705-2727)."""
    ft = p22.dtype
    cnt = p22.shape[-1] - 1
    u, _, cos_h, r_h, uu = _radial_grid(cnt, ft, p22.device)
    p22_r = spline.eval1d_stack(p22, uu)
    terms = (u * r_h * p22_r) / (cos_h * cos_h)
    cdf = torch.cumsum(terms, dim=-1) * _f(np.pi / cnt * 2.0 * np.pi, ft)
    return torch.cat([cdf, torch.ones_like(cdf[..., :1])], dim=-1)


def compute_qf(cdf: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF scan at 8x resolution (reference tabular::compute_qf,
    dj_brdf.h:2731-2762)."""
    ft = cdf.dtype
    dev = cdf.device
    cnt = cdf.shape[-1] - 1
    res_inv = cnt * 8
    u = torch.arange(res_inv, dtype=ft, device=dev) / res_inv
    r = torch.tan(u * _f(np.pi * 0.5, ft))
    # cdf_radial lookup (dj_brdf.h:2164-2169)
    uu = torch.clamp(torch.arctan(r) * 2.0 / math.pi, min=0.0)
    cdf_vals = spline.eval1d_stack(cdf, torch.sqrt(uu))

    targets = torch.arange(1, cnt, dtype=ft, device=dev) / cnt
    targets = targets.expand(cdf_vals.shape[:-1] + targets.shape)
    idx = torch.searchsorted(cdf_vals.contiguous(), targets.contiguous(),
                             side="left")
    qf_mid = torch.where(idx >= res_inv, 1.0,
                         u[torch.clamp(idx, max=res_inv - 1)])
    return torch.cat([torch.zeros_like(qf_mid[..., :1]), qf_mid,
                      torch.ones_like(qf_mid[..., :1])], dim=-1)


def build_tabular(brdf, res: int, shadow: bool = True, device="cuda"):
    """Full pipeline (reference tabular::tabular ctor,
    dj_brdf.h:2215-2236). ``brdf``: a model with ``.eval`` (its tables
    set the device) or a bare ``eval_fn(i, o)``, which runs on
    ``device``: the card unless the caller asks for ``"cpu"`` (without a
    card the default raises). Only the 4-step power
    iteration runs in float64 (an 89x89 matvec, matching the
    reference's double-precision ``matrix`` class).

    Returns ``(Tabular, SplineFresnel)``."""
    eval_fn, model = as_model_eval(brdf)
    with span("dj.tab.kernel_matrix"):
        K = _kernel_matrix(eval_fn, model, res, device)
    with span("dj.tab.power"):
        p22 = _power_iteration(K)
    with span("dj.tab.sigma"):
        p22, nint = normalize_p22(p22, return_nint=True)
        sigma = compute_sigma(p22)
    with span("dj.tab.fresnel"):
        fres_pts = _fresnel_points(eval_fn, model, p22, sigma, res, shadow)
    with span("dj.tab.cdf"):
        cdf = compute_cdf(p22)
        qf = compute_qf(cdf)
    # the reference logs the normalization constant (dj_brdf.h:2302);
    # here at debug level, read back only when that level is on
    if config.logger.isEnabledFor(logging.DEBUG):
        config.logger.debug("tabular: normalize_p22 nint = %s",
                            nint.tolist())
    dist = Tabular(p22=p22, sigma=sigma, cdf=cdf, qf=qf)
    return dist, fresnel_mod.SplineFresnel(points=fres_pts)


def microfacet_eval_fn(dist, fres, params, shadow: bool = True):
    """Adapter: a microfacet distribution as a plain eval_fn (the
    harness' fixed_params_brdf equivalent)."""
    def eval_fn(i, o):
        return mf.eval(dist, fres, params, i, o, shadow)
    return eval_fn
