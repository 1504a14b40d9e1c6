"""Anisotropic (elevation x azimuth) tabulation pipeline.

Port of the ``djb::tabular_anisotropic`` constructor
(dj_brdf.h:2238-2273) and its precomputations: the (w*h)^2 kernel
matrix + power iteration (2525-2579), the 2D normalization (2306-2338),
the 2D projected-area table (2388-2432), and the marginal-azimuth /
conditional-elevation sampling tables pdf1/cdf1/qf1/pdf2/cdf2/qf2
(2848-3103).

The kernel matrix (8010^2 at the reference's 90x90 resolution, 257 MB
in float32) is one batched tensor expression on the device of the
model's tables, or on ``device`` for a bare eval function. Small
problems (n <= :data:`HOST_F64_MAX_N`) power-iterate in float64, like
the reference's always-double ``matrix`` class; larger ones iterate in
the working precision (``torch.matmul``), where the normalization that
follows removes the scale anyway. Both run on the matrix's device.

Table layout is (azimuthal_res, elevation_res) with the elevation axis
fast, matching the reference's flat ``m_p22[i + w*j]``. Precision
follows ``config.default_float()`` (DJB_USE_DOUBLE_PRECISION parity).

Counterpart of ``dj_brdf_tpu/fit/tabular_aniso.py``. With ``mesh=``
stage 1 is :func:`~dj_brdf_torch.parallel.power.aniso_p22_sharded` (each
rank builds a block of kernel columns) and stage 2 runs on the gathered
table.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from dj_brdf_torch import config
from dj_brdf_torch import fresnel as fresnel_mod
from dj_brdf_torch.core import spline
from dj_brdf_torch.core.math import from_spherical, intensity
from dj_brdf_torch.fit.tabular import _device, as_model_eval, \
    fresnel_ratio_points
from dj_brdf_torch.microfacet.ndf import TabularAnisotropic, p22_theta_phi

#: n = (elevation_res-1) * azimuthal_res above which the power
#: iteration runs in the working precision instead of float64.
HOST_F64_MAX_N = 4096

_f = config.round_to


def _arange(n, ft, device, start=0):
    """k / n for k in [start, n), in ``ft``."""
    return torch.arange(start, n, dtype=ft, device=device) / n


def kernel_matrix(brdf, elevation_res: int, azimuthal_res: int,
                  dtype=None, device="cuda") -> torch.Tensor:
    """The (w*h, w*h) matrix A with A[col, row] = K(row, col) so a
    power step is ``A @ v`` (reference compute_p22_smith aniso,
    dj_brdf.h:2525-2566; matrix layout 2442-2465). Flat index is
    i2 * w + i1 (azimuth-major). A model's tables set the device; a bare
    eval function runs on ``device``, the card unless the caller asks
    for ``"cpu"``."""
    eval_fn, model = as_model_eval(brdf)
    return _kernel_matrix(eval_fn, model, elevation_res, azimuthal_res,
                          dtype, device)


def _kernel_matrix(eval_fn, model, elevation_res: int, azimuthal_res: int,
                   dtype=None, device="cuda") -> torch.Tensor:
    ft = dtype or config.default_float()
    dev = _device(model, device)
    cols = col_terms(eval_fn, model, elevation_res, azimuthal_res, ft, dev)
    return kernel_block(row_terms(elevation_res, azimuthal_res, ft, dev),
                        *cols)


def _angles(elevation_res, azimuthal_res, ft, dev):
    """(theta, phi) of the (h, w) grid of kernel rows and columns, each
    flattened azimuth-major (i2 * w + i1)."""
    w = elevation_res - 1
    theta = _arange(w, ft, dev) * _f(0.5 * np.pi, ft)       # (w,)
    phi = _arange(azimuthal_res, ft, dev) * _f(2.0 * np.pi, ft)  # (h,)
    return torch.meshgrid(theta, phi, indexing="xy")         # (h, w)


def col_terms(eval_fn, model, elevation_res: int, azimuthal_res: int, ft,
              dev):
    """Per-column factors of the kernel (dj_brdf.h:2536-2548): the
    direction components ``xo, yo, zo`` at each column's (theta, phi) and
    ``kji_tmp1``, the retro-reflective intensity weight, each (w*h,)."""
    w = elevation_res - 1
    dtheta = np.sqrt(np.pi * 0.5) / w
    dphi = 2.0 * np.pi / azimuthal_res
    T, P = _angles(elevation_res, azimuthal_res, ft, dev)
    sin_t = torch.sin(T)
    zo = torch.cos(T)
    xo = sin_t * torch.cos(P)
    yo = sin_t * torch.sin(P)
    d = from_spherical(T, P)
    fr_i = intensity(eval_fn(model, d, d).to(ft))
    kji_tmp1 = _f(dtheta * dphi, ft) * (4.0 * fr_i * zo ** 5)
    return (xo.reshape(-1), yo.reshape(-1), zo.reshape(-1),
            kji_tmp1.reshape(-1))


def row_terms(elevation_res: int, azimuthal_res: int, ft, dev):
    """Per-row factors (dj_brdf.h:2550-2565): the slopes and the
    tan/cos^2 weight at each row's (theta, phi), each (w*h,)."""
    T, P = _angles(elevation_res, azimuthal_res, ft, dev)
    tan_t = torch.tan(T)
    cos_t = torch.cos(T)
    slope1 = -tan_t * torch.cos(P)
    slope2 = -tan_t * torch.sin(P)
    weight = tan_t / (cos_t * cos_t)
    return slope1.reshape(-1), slope2.reshape(-1), weight.reshape(-1)


def kernel_block(rows, xo, yo, zo, kji_tmp1) -> torch.Tensor:
    """Rows ``A[col, :]`` of the power-step matrix for the columns whose
    factors are given (all columns: the whole A), from
    :func:`row_terms`' ``rows``: ``A[col, row] = K(row, col)``."""
    s1_f, s2_f, weight = rows
    # m_dot_o[row, col] = zo_col - xo_col*slope1_row - yo_col*slope2_row
    m_dot_o = (zo[None, :] - s1_f[:, None] * xo[None, :]
               - s2_f[:, None] * yo[None, :])
    kji_tmp2 = weight[:, None] * torch.clamp(m_dot_o, min=0.0)
    del m_dot_o
    K = kji_tmp1[None, :] * kji_tmp2                         # K[row, col]
    return K.T                                                # A[col, row]


def _table(v, azimuthal_res, w):
    """The iterate as an (H, W) table with the zero elevation-edge
    column (dj_brdf.h:2568-2578)."""
    grid = v.reshape(azimuthal_res, w)
    return torch.cat([grid, torch.zeros_like(grid[:, :1])], dim=1)


def power_iteration_p22(A, elevation_res: int, azimuthal_res: int,
                        iterations: int = 4) -> torch.Tensor:
    """Unnormalized float64 power iteration from an all-ones start (the
    reference's ``matrix`` class is always double, dj_brdf.h:2467-2480)
    + table assembly with the zero elevation-edge column
    (dj_brdf.h:2568-2578), on A's device. Returns (H, W) in the default
    float type."""
    A = A.to(torch.float64)
    v = torch.ones(A.shape[0], dtype=torch.float64, device=A.device)
    for _ in range(iterations):
        v = A @ v
    return _table(v, azimuthal_res, elevation_res - 1).to(
        config.default_float())


def _device_power_table(A, elevation_res: int, azimuthal_res: int,
                        iterations: int = 4) -> torch.Tensor:
    """The power iteration (dj_brdf.h:2467-2480) in A's precision on A's
    device (``torch.matmul``). The relative f32 matvec error at n ~ 8000
    is ~1e-5, and the normalization that follows removes the scale."""
    v = torch.ones(A.shape[0], dtype=A.dtype, device=A.device)
    for _ in range(iterations):
        v = A @ v
    return _table(v, azimuthal_res, elevation_res - 1)


def normalize_p22(p22: torch.Tensor, return_nint: bool = False):
    """(dj_brdf.h:2306-2338)."""
    ft, dev = p22.dtype, p22.device
    ntheta, nphi = 128, 256
    dtheta = np.sqrt(0.5 * np.pi) / ntheta
    dphi = 2.0 * np.pi / nphi
    theta = _arange(ntheta, ft, dev) * _f(np.sqrt(np.pi * 0.5), ft)
    phi = _arange(nphi, ft, dev) * _f(2.0 * np.pi, ft)
    T2, P = torch.meshgrid(theta * theta, phi, indexing="xy")
    Tw = torch.meshgrid(theta, phi, indexing="xy")[0]
    c = torch.cos(T2)
    pdf = p22_theta_phi(p22, T2, P)
    weight = (Tw * torch.tan(T2)) / (c * c)
    k = torch.sum(weight * pdf) * _f(2.0 * dtheta * dphi, ft)
    if return_nint:
        return p22 / k, k
    return p22 / k


def compute_sigma(p22: torch.Tensor) -> torch.Tensor:
    """(dj_brdf.h:2388-2432). Returns (H, W)."""
    ft, dev = p22.dtype, p22.device
    H, W = p22.shape
    w = W - 1
    ntheta, nphi = 45, 90
    dtheta = np.sqrt(np.pi * 0.5) / ntheta
    dphi = 2.0 * np.pi / nphi

    phi_k = _arange(H, ft, dev) * _f(2.0 * np.pi, ft)       # (H,)
    theta_k = _arange(w, ft, dev) * _f(0.5 * np.pi, ft)     # (w,)
    theta_w = _arange(ntheta, ft, dev) * _f(np.sqrt(np.pi * 0.5), ft)
    phi = _arange(nphi, ft, dev) * _f(2.0 * np.pi, ft)      # (nphi,)

    # ndf at standard params: p22_std(theta, phi) / cos^4 via slope angles
    T2, P = torch.meshgrid(theta_w * theta_w, phi, indexing="xy")
    sin_t = torch.sin(T2)                                     # (nphi, ntheta)
    cos_t = torch.cos(T2)
    ndf_h = p22_theta_phi(p22, T2, P) / cos_t ** 4
    weight = torch.meshgrid(theta_w, phi, indexing="xy")[0] * sin_t

    # m_dot_k[k_elev, k_azim, j_phi, j_theta]
    sin_tk = torch.sin(theta_k)
    cos_tk = torch.cos(theta_k)
    cos_dphi = torch.cos(phi[None, :] - phi_k[:, None])      # (H, nphi)
    term1 = (sin_tk[:, None, None, None] * sin_t[None, None, :, :]
             * cos_dphi[None, :, :, None])
    term2 = cos_tk[:, None, None, None] * cos_t[None, None, :, :]
    masking = torch.clamp(term1 + term2, min=0.0) * ndf_h[None, None, :, :]
    nint = torch.sum(weight[None, None] * masking, dim=(2, 3)) \
        * _f(2.0 * dtheta * dphi, ft)                        # (w, H)
    sigma = torch.maximum(cos_tk[:, None], nint).T           # (H, w)
    return torch.cat([sigma, sigma[:, -1:]], dim=1)


def compute_pdf1(p22: torch.Tensor) -> torch.Tensor:
    """Marginal azimuth PDF + its normalization (dj_brdf.h:2848-2875,
    3046-3067). Returns (H,)."""
    ft, dev = p22.dtype, p22.device
    H = p22.shape[0]
    ntheta = 256
    dtheta = 0.5 * np.pi / ntheta
    phi = _arange(H, ft, dev) * _f(2.0 * np.pi, ft)
    theta = _arange(ntheta, ft, dev) * _f(0.5 * np.pi, ft)
    T, P = torch.meshgrid(theta, phi, indexing="xy")
    c = torch.cos(T)
    pdf = p22_theta_phi(p22, T, P)
    nint = torch.sum(pdf * torch.tan(T) / (c * c), dim=1) * _f(dtheta, ft)

    # normalize_pdf1: 512-pt quadrature of the *spline* of pdf1
    cnt = 512
    vals = spline.eval1d(nint, _arange(cnt, ft, dev), wrap="repeat")
    total = torch.sum(vals) * _f(2.0 * np.pi / cnt, ft)
    return nint / total


def compute_cdf1(pdf1: torch.Tensor) -> torch.Tensor:
    """(dj_brdf.h:2879-2901). Returns (H,)."""
    ft, dev = pdf1.dtype, pdf1.device
    cnt = pdf1.shape[0] - 1
    dphi = 2.0 * np.pi / cnt
    vals = spline.eval1d(pdf1, _arange(cnt, ft, dev, start=1), wrap="repeat")
    inner = torch.cumsum(vals, dim=0) * _f(dphi, ft)
    one = torch.ones(1, dtype=ft, device=dev)
    return torch.cat([torch.zeros_like(one), inner, one])


def _inverse(cdf_vals, u, cnt):
    """The reference's inverse-CDF scan (dj_brdf.h:2905-2936): for each
    target k/cnt, k in [1, cnt), the first grid point u whose CDF value
    reaches it (1 where none does), between a leading 0 and a trailing
    1. ``cdf_vals`` (*B, res) at the grid ``u`` (res,)."""
    res = u.shape[0]
    targets = _arange(cnt, u.dtype, u.device, start=1)
    targets = targets.expand(cdf_vals.shape[:-1] + targets.shape)
    idx = torch.searchsorted(cdf_vals.contiguous(), targets.contiguous(),
                             side="left")
    mid = torch.where(idx >= res, 1.0, u[torch.clamp(idx, max=res - 1)])
    return torch.cat([torch.zeros_like(mid[..., :1]), mid,
                      torch.ones_like(mid[..., :1])], dim=-1)


def compute_qf1(cdf1: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF scan (dj_brdf.h:2905-2936). Returns (H,)."""
    cnt = cdf1.shape[0] - 1
    u = _arange(cnt * 8, cdf1.dtype, cdf1.device)
    return _inverse(spline.eval1d(cdf1, u, wrap="repeat"), u, cnt)


def compute_pdf2(p22: torch.Tensor, pdf1: torch.Tensor) -> torch.Tensor:
    """Conditional elevation PDF + per-azimuth normalization
    (dj_brdf.h:2945-2970, 3071-3103). Returns (H, W)."""
    ft, dev = p22.dtype, p22.device
    H, W = p22.shape
    ntheta = W - 1
    u_p = _arange(H, ft, dev)
    phi = u_p * _f(2.0 * np.pi, ft)
    theta = _arange(ntheta, ft, dev) * _f(0.5 * np.pi, ft)
    T, P = torch.meshgrid(theta, phi, indexing="xy")
    p22_v = p22_theta_phi(p22, T, P)
    p1 = spline.eval1d(pdf1, u_p, wrap="repeat")[:, None]
    pdf2 = torch.cat([p22_v / p1, torch.zeros_like(p22_v[:, :1])], dim=1)

    # normalize_pdf2: 256-pt theta quadrature of the 2D spline per phi
    nq = 256
    theta_q = _arange(nq, ft, dev) * _f(0.5 * np.pi, ft)
    TQ, PQ = torch.meshgrid(theta_q, phi, indexing="xy")
    vals = spline.eval2d(pdf2, TQ * 2.0 / math.pi, PQ * 0.5 / math.pi,
                         wrap1="edge", wrap2="repeat")
    cq = torch.cos(TQ)
    nint = torch.sum(vals * torch.tan(TQ) / (cq * cq), dim=1) \
        * _f(0.5 * np.pi / nq, ft)
    return pdf2 / nint[:, None]


def compute_cdf2(pdf2: torch.Tensor) -> torch.Tensor:
    """(dj_brdf.h:2974-3001). Returns (H, W)."""
    ft, dev = pdf2.dtype, pdf2.device
    H, W = pdf2.shape
    ntheta = W - 1
    dtheta = 0.5 * np.pi / ntheta
    phi = _arange(H, ft, dev) * _f(2.0 * np.pi, ft)
    theta = _arange(ntheta, ft, dev) * _f(0.5 * np.pi, ft)
    T, P = torch.meshgrid(theta, phi, indexing="xy")
    vals = spline.eval2d(pdf2, T * 2.0 / math.pi, P * 0.5 / math.pi,
                         wrap1="edge", wrap2="repeat")
    c = torch.cos(T)
    inner = torch.cumsum(vals * torch.tan(T) / (c * c), dim=1) \
        * _f(dtheta, ft)
    return torch.cat([inner, torch.ones_like(inner[:, :1])], dim=1)


def compute_qf2(cdf2: torch.Tensor) -> torch.Tensor:
    """Per-azimuth inverse-CDF scan (dj_brdf.h:3005-3042). Returns (H, W)."""
    ft, dev = cdf2.dtype, cdf2.device
    H, W = cdf2.shape
    ntheta = W - 1
    phi = _arange(H, ft, dev) * _f(2.0 * np.pi, ft)
    u = _arange(ntheta * 8, ft, dev)
    theta = u * _f(0.5 * np.pi, ft)
    T, P = torch.meshgrid(theta, phi, indexing="xy")
    cdf_vals = spline.eval2d(cdf2, T * 2.0 / math.pi, P * 0.5 / math.pi,
                             wrap1="edge", wrap2="repeat")   # (H, res)
    return _inverse(cdf_vals, u, ntheta)


def build_tabular_anisotropic(brdf, elevation_res: int, azimuthal_res: int,
                              shadow: bool = True, power: str = "auto",
                              mesh=None, device="cuda"):
    """Full pipeline (reference ctor dj_brdf.h:2238-2273).

    ``brdf``: a model with ``.eval`` (its tables set the device) or a
    bare ``eval_fn(i, o)``, which runs on ``device``: the card unless the
    caller asks for ``"cpu"`` (without a card the default raises).
    ``power`` selects the stage-1 extraction: "auto" iterates small
    kernels (n <= :data:`HOST_F64_MAX_N`) in float64, the reference's
    precision, and production sizes (the 8010^2 matrix of the 90x90 UTIA
    fit) in the working precision; "host" (float64) / "device" (working
    precision) force one path. Both run on the matrix's device.
    ``mesh``: a :class:`~dj_brdf_torch.parallel.mesh.Mesh`; stage 1 then
    never builds more than n/D kernel columns a rank
    (:func:`~dj_brdf_torch.parallel.power.aniso_p22_sharded`, float32) and
    stage 2 runs on the gathered table, on the mesh's device for a bare
    eval function.

    Returns (TabularAnisotropic, SplineFresnel)."""
    eval_fn, model = as_model_eval(brdf)
    if power not in ("auto", "host", "device"):
        raise ValueError(f"power must be auto|host|device, got {power!r}")
    if mesh is not None and power != "auto":
        raise ValueError(
            "mesh= always runs the sharded f32 power stage; an explicit "
            f"power={power!r} selection would be ignored: pass power='auto'")
    n = (elevation_res - 1) * azimuthal_res
    in_f64 = (n <= HOST_F64_MAX_N) if power == "auto" else (power == "host")

    if mesh is not None:
        from dj_brdf_torch.parallel.power import aniso_p22_sharded
        p22_raw = aniso_p22_sharded(brdf, elevation_res, azimuthal_res,
                                    mesh).to(config.default_float())
    else:
        A = _kernel_matrix(eval_fn, model, elevation_res, azimuthal_res,
                           device=device)
        iterate = power_iteration_p22 if in_f64 else _device_power_table
        p22_raw = iterate(A, elevation_res, azimuthal_res)
        del A

    p22, nint = normalize_p22(p22_raw, return_nint=True)
    sigma = compute_sigma(p22)
    pdf1 = compute_pdf1(p22)
    cdf1 = compute_cdf1(pdf1)
    qf1 = compute_qf1(cdf1)
    pdf2 = compute_pdf2(p22, pdf1)
    cdf2 = compute_cdf2(pdf2)
    qf2 = compute_qf2(cdf2)
    # the reference logs the normalization constant; here at debug
    # level, read back only when that level is on
    if config.logger.isEnabledFor(logging.DEBUG):
        config.logger.debug("tabular_anisotropic: normalize nint = %.9g",
                            float(nint))

    dist = TabularAnisotropic(p22=p22, sigma=sigma, pdf1=pdf1, cdf1=cdf1,
                              qf1_table=qf1, pdf2=pdf2, cdf2=cdf2,
                              qf2_table=qf2)
    # Fresnel: the isotropic routine at elevation_res (dj_brdf.h:
    # 2643-2701), dividing by the anisotropic table
    fres_pts = fresnel_ratio_points(eval_fn, model, dist, elevation_res,
                                    shadow, p22.dtype)
    return dist, fresnel_mod.SplineFresnel(points=fres_pts)
