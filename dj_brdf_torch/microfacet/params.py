"""Microfacet slope-distribution parameters.

Port of ``djb::microfacet::params`` (dj_brdf.h:212-243, impl
1348-1506). The canonical storage is the PDF parameterization
(alpha_x, alpha_y, rho, tx_n, ty_n): Gaussian-slope scales, slope
correlation, and the non-central mean-normal slope offset. The
elliptic (a1, a2, phi_a) parameterization converts to/from it with
pure functions, so gradients flow through either view.

All fields are tensors broadcastable against sample batch shapes, so a
single `MicrofacetParams` can hold per-pixel textured roughness
(the reference's textured alpha1/alpha2/alphaAngle path,
mitsuba/dj_brdf.cpp:353-357) with no code change.
"""

from __future__ import annotations

import torch

from dj_brdf_torch.core.math import as_float, normalize, vec3
from dj_brdf_torch.core.pytree import pytree_dataclass


def ellipse_to_pdfparams(a1, a2, phi_a):
    """(a1, a2, phi_a) ellipse -> (ax, ay, rho) PDF parameters
    (reference ellipse_to_pdfparams, dj_brdf.h:1355-1371)."""
    cos_phi_a = torch.cos(phi_a)
    sin_phi_a = torch.sin(phi_a)
    cos_2phi_a = 2.0 * cos_phi_a * cos_phi_a - 1.0
    a1_sqr = a1 * a1
    a2_sqr = a2 * a2
    tmp1 = a1_sqr + a2_sqr
    tmp2 = a1_sqr - a2_sqr
    ax = torch.sqrt(0.5 * (tmp1 + tmp2 * cos_2phi_a))
    ay = torch.sqrt(0.5 * (tmp1 - tmp2 * cos_2phi_a))
    rho = (a2_sqr - a1_sqr) * cos_phi_a * sin_phi_a / (ax * ay)
    return ax, ay, rho


def pdfparams_to_ellipse(ax, ay, rho):
    """(ax, ay, rho) -> (a1, a2, phi_a) principal-axes form
    (reference pdfparams_to_ellipse, dj_brdf.h:1378-1393)."""
    ax_sqr = ax * ax
    ay_sqr = ay * ay
    cov = rho * ax * ay * 2.0
    tmp1 = ax_sqr + ay_sqr
    tmp2 = ax_sqr - ay_sqr
    tmp3 = torch.sqrt(tmp2 * tmp2 + cov * cov)
    a1 = torch.sqrt(0.5 * (tmp1 + tmp3))
    a2 = torch.sqrt(torch.clamp(0.5 * (tmp1 - tmp3), min=0.0))
    safe_cov = torch.where(cov == 0.0, 1.0, cov)
    phi_a = torch.where(cov == 0.0, 0.0,
                        torch.arctan((ax_sqr - ay_sqr - tmp3) / safe_cov))
    return a1, a2, phi_a


@pytree_dataclass
class MicrofacetParams:
    """PDF parameters of an elliptic, possibly non-central slope
    distribution. Fields broadcast over batch shapes."""

    ax: torch.Tensor
    ay: torch.Tensor
    rho: torch.Tensor
    txn: torch.Tensor
    tyn: torch.Tensor

    # -- constructors -------------------------------------------------
    @staticmethod
    def standard():
        """Unit-roughness isotropic (reference params::standard,
        dj_brdf.h:1412-1415)."""
        return MicrofacetParams.isotropic(1.0)

    @staticmethod
    def isotropic(a):
        return MicrofacetParams.elliptic(a, a, 0.0)

    @staticmethod
    def elliptic(a1, a2, phi_a=0.0, txn=0.0, tyn=0.0):
        a1, a2, phi_a = as_float(a1, a2, phi_a)
        ax, ay, rho = ellipse_to_pdfparams(a1, a2, phi_a)
        return MicrofacetParams(
            ax=ax, ay=ay, rho=rho,
            txn=torch.as_tensor(txn, dtype=ax.dtype, device=ax.device),
            tyn=torch.as_tensor(tyn, dtype=ax.dtype, device=ax.device))

    @staticmethod
    def pdfparams(ax, ay, rho=0.0, txn=0.0, tyn=0.0):
        ax, ay, rho, txn, tyn = as_float(ax, ay, rho, txn, tyn)
        return MicrofacetParams(ax=ax, ay=ay, rho=rho, txn=txn, tyn=tyn)

    @staticmethod
    def from_normal(n, ax=1.0, ay=1.0, rho=0.0):
        """Set the location from a mean normal (reference
        params::set_location(vec3), dj_brdf.h:1444-1449)."""
        txn = -n[..., 0] / n[..., 2]
        tyn = -n[..., 1] / n[..., 2]
        return MicrofacetParams.pdfparams(ax, ay, rho, txn, tyn)

    # -- derived quantities -------------------------------------------
    @property
    def sqrt_one_minus_rho_sqr(self):
        return torch.sqrt(torch.clamp(1.0 - self.rho * self.rho, min=1e-24))

    @property
    def mean_normal(self):
        """Unit mean normal n = normalize(-txn, -tyn, 1) (reference
        params::set_location, dj_brdf.h:1437-1442)."""
        one = torch.ones_like(self.txn)
        return normalize(vec3(-self.txn, -self.tyn, one))

    def ellipse(self):
        """(a1, a2, phi_a) view."""
        return pdfparams_to_ellipse(self.ax, self.ay, self.rho)
