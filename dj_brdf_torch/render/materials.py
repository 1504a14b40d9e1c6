"""Renderer front-end materials — the plugin layer.

The reference exposes its models to renderers through Mitsuba BSDF
plugins (mitsuba/dj_brdf.cpp, dj_merl.cpp, dj_utia.cpp, ...). Here each
becomes a frozen dataclass with a uniform (evalp, sample, pdf,
evalp_is) surface that the path tracer and the sphere renderer consume:

* :class:`MicrofacetMaterial` — dj_brdf: analytic distribution +
  Fresnel + params (dj_brdf.cpp:342-439).
* :class:`MeasuredMaterial` — dj_merl/dj_sgd/dj_abc: measured or
  analytic eval with a fitted-GGX-proxy VNDF sampler; weight =
  evalp/pdf (dj_merl.cpp:56-101).
* :class:`CosineMaterial` — dj_utia: plain cosine-hemisphere sampling
  (dj_utia.cpp:66-99; the reference brdf base defaults,
  dj_brdf.h:830-845).
* :class:`ConductorWrap` — exact conductor Fresnel on top of any
  material (mitsuba/dj_brdf.cpp:366, 430).

Counterpart of ``dj_brdf_tpu/render/materials.py``. The textured
materials (``TextureProvider``, ``TexturedMicrofacetMaterial``,
``UVMappedMaterial``) are not ported yet.
"""

from __future__ import annotations

import math

import torch

from dj_brdf_torch import fresnel as fresnel_mod
from dj_brdf_torch.core.math import cosine_hemisphere_sample, dot, normalize
from dj_brdf_torch.core.pytree import pytree_dataclass
from dj_brdf_torch.microfacet import brdf as mf
from dj_brdf_torch.microfacet.ndf import GGX, Beckmann, GGXSphericalCaps
from dj_brdf_torch.microfacet.params import MicrofacetParams
from dj_brdf_torch.ops import soa


def _evalp_over_pdf(model_evalp, i, o, p, ok):
    safe = torch.clamp(p, min=1e-12)
    return torch.where(ok[..., None], model_evalp(i, o) / safe[..., None],
                       0.0)


@pytree_dataclass
class MicrofacetMaterial:
    """Analytic microfacet BSDF (the dj_brdf plugin): any distribution
    + Fresnel + params."""

    dist: object
    fres: object
    params: MicrofacetParams

    def evalp(self, i, o):
        return mf.evalp(self.dist, self.fres, self.params, i, o)

    def sample(self, u1, u2, o):
        return mf.sample(self.dist, self.params, u1, u2, o)

    def pdf(self, i, o):
        return mf.pdf(self.dist, self.params, i, o)

    def _fused_pvec(self):
        """(8,) pvec for the fused SoA samplers, or None when the
        material does not qualify (textured params, non-Schlick
        Fresnel, other distributions)."""
        p = self.params
        if not isinstance(self.fres, fresnel_mod.Schlick):
            return None
        if not (type(self.dist) is Beckmann or isinstance(self.dist, GGX)):
            return None
        leaves = (p.ax, p.ay, p.rho, p.txn, p.tyn)
        if any(torch.as_tensor(x).dim() != 0 for x in leaves):
            return None
        f0 = torch.as_tensor(self.fres.f0)
        if f0.shape != (3,):
            return None
        return torch.stack([torch.as_tensor(x, dtype=torch.float32,
                                            device=f0.device)
                            for x in leaves] + [f0[0], f0[1], f0[2]])

    def evalp_is(self, u1, u2, o):
        """Sample + weight. Uniform GGX/Beckmann + Schlick materials
        route through the fused SoA samplers (ops/soa.py); other shapes
        take the general path. Both zero weight and pdf for receivers
        below the mean-normal horizon (where the reference emits an
        arbitrary "up" sample, dj_brdf.h:1677-1678), so a material
        renders identically whichever path dispatches it."""
        pvec = self._fused_pvec()
        if pvec is not None:
            ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
            if type(self.dist) is Beckmann:
                out = soa.beckmann_evalp_is_soa(pvec, u1, u2, ox, oy, oz)
            else:
                out = soa.ggx_evalp_is_soa(
                    pvec, u1, u2, ox, oy, oz,
                    caps=isinstance(self.dist, GGXSphericalCaps))
            wr, wg, wb, ix, iy, iz, pdf = out
            return (torch.stack([wr, wg, wb], -1),
                    torch.stack([ix, iy, iz], -1), pdf)
        w, i, pdf = mf.evalp_is(self.dist, self.fres, self.params, u1, u2, o)
        # align the fallback with the fused samplers at the edge lanes:
        # the warped-receiver horizon check c(o) <= 0
        p = self.params
        c_o = o[..., 2] - o[..., 0] * p.txn - o[..., 1] * p.tyn
        bad = c_o <= 0.0
        return (torch.where(bad[..., None], 0.0, w), i,
                torch.where(bad, 0.0, pdf))


@pytree_dataclass
class MeasuredMaterial:
    """Measured (or analytic-fit) eval + importance sampling through a
    fitted GGX proxy — the dj_merl render pattern."""

    model: object                 # anything with .evalp(i, o)
    proxy_params: MicrofacetParams
    proxy_dist: object

    @staticmethod
    def from_merl(table, res: int = 90):
        """Scene-load-time fit, like the dj_merl constructor
        (mitsuba/dj_merl.cpp:29-33): ``tabular(merl, res,
        shadow=False)`` then ``fit_ggx_parameters``, on the table's
        device."""
        from dj_brdf_torch.fit import moments, tabular
        from dj_brdf_torch.models.merl import Merl

        m = Merl(table=table)
        tab, _ = tabular.build_tabular(m, res, shadow=False)
        return MeasuredMaterial(model=m,
                                proxy_params=moments.fit_ggx_parameters(tab),
                                proxy_dist=GGX())

    @staticmethod
    def from_model(model, res: int = 90):
        """dj_sgd/dj_abc pattern: proxy from tabular(model, res)
        (mitsuba/dj_sgd.cpp:29-31)."""
        from dj_brdf_torch.fit import moments, tabular

        tab, _ = tabular.build_tabular(model, res)
        return MeasuredMaterial(model=model,
                                proxy_params=moments.fit_ggx_parameters(tab),
                                proxy_dist=GGX())

    def evalp(self, i, o):
        return self.model.evalp(i, o)

    def sample(self, u1, u2, o):
        return mf.sample(self.proxy_dist, self.proxy_params, u1, u2, o)

    def pdf(self, i, o):
        return mf.pdf(self.proxy_dist, self.proxy_params, i, o)

    def evalp_is(self, u1, u2, o):
        """weight = evalp/pdf (dj_merl.cpp:86-99)."""
        i = self.sample(u1, u2, o)
        p = self.pdf(i, o)
        ok = (p > 0.0) & (i[..., 2] > 0.0)
        return (_evalp_over_pdf(self.evalp, i, o, p, ok), i,
                torch.where(ok, p, 0.0))


@pytree_dataclass
class CosineMaterial:
    """Cosine-hemisphere sampling around any model (dj_utia pattern;
    reference defaults dj_brdf.h:830-845)."""

    model: object

    def evalp(self, i, o):
        return self.model.evalp(i, o)

    def sample(self, u1, u2, o):
        return cosine_hemisphere_sample(u1, u2)

    def pdf(self, i, o):
        return torch.clamp(i[..., 2], min=0.0) / math.pi

    def evalp_is(self, u1, u2, o):
        i = self.sample(u1, u2, o)
        p = self.pdf(i, o)
        return _evalp_over_pdf(self.evalp, i, o, p, p > 0.0), i, p


@pytree_dataclass
class ConductorWrap:
    """Exact conductor Fresnel multiplied on top of any material — the
    dj_brdf plugin's Mitsuba-Fresnel path (mitsuba/dj_brdf.cpp:366,
    430)."""

    inner: object
    eta: torch.Tensor
    k: torch.Tensor

    def _cond(self, i, o):
        h = normalize(i + o, eps=1e-24)
        return fresnel_mod.conductor_fresnel(
            torch.clamp(dot(o, h), 0.0, 1.0), self.eta, self.k)

    def evalp(self, i, o):
        return self.inner.evalp(i, o) * self._cond(i, o)

    def sample(self, u1, u2, o):
        return self.inner.sample(u1, u2, o)

    def pdf(self, i, o):
        return self.inner.pdf(i, o)

    def evalp_is(self, u1, u2, o):
        i = self.sample(u1, u2, o)
        p = self.pdf(i, o)
        ok = (p > 0.0) & (i[..., 2] > 0.0)
        return (_evalp_over_pdf(self.evalp, i, o, p, ok), i,
                torch.where(ok, p, 0.0))


def eval_hd(model, h, d):
    """Evaluate any material in half/diff coordinates (reference
    brdf::eval_hd, dj_brdf.h:795-801)."""
    from dj_brdf_torch.core.math import hd_to_io

    i, o = hd_to_io(h, d)
    return model.evalp(i, o) / torch.clamp(i[..., 2:3], min=1e-12)
