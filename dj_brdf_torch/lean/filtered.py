"""Filtered (LEAN/LEADR) render path.

Port of the ``dj_beckmannconductor`` Mitsuba plugin's per-shading-point
parameter assembly (mitsuba/dj_beckmannconductor.cpp:280-428): fetch
the (possibly mip-filtered) LEAN moments, remove the storage bias,
optionally fall back to naive mip statistics, scale by the displacement
amplitude, combine with the base-roughness lrep, and convert back to
microfacet parameters. Everything is per-pixel batched.

Counterpart of ``dj_brdf_tpu/lean/filtered.py``.
"""

from __future__ import annotations

import torch

from dj_brdf_torch import fresnel as fresnel_mod
from dj_brdf_torch.core.math import dot, normalize
from dj_brdf_torch.core.pytree import pytree_dataclass, static_field
from dj_brdf_torch.lean.lrep import Lrep, lrep_to_params, params_to_lrep
from dj_brdf_torch.lean.maps import LEAN_BIAS, build_mip_pyramid, unbias
from dj_brdf_torch.microfacet import brdf as mf
from dj_brdf_torch.microfacet.ndf import Beckmann
from dj_brdf_torch.microfacet.params import MicrofacetParams


def filtered_params(lean: Lrep, base_params: MicrofacetParams,
                    dmap_scale=1.0, lean_filtering: bool = True,
                    biased: bool = False) -> MicrofacetParams:
    """Combine fetched LEAN moments with base roughness (reference
    eval/pdf/sample preamble, dj_beckmannconductor.cpp:291-314)."""
    if biased:
        lean = unbias(lean, LEAN_BIAS)
    if not lean_filtering:
        # naive mip: rebuild second moments from the filtered means,
        # losing the variance the footprint accumulated (:306-310)
        lean = Lrep(E1=lean.E1, E2=lean.E2, E3=lean.E1 * lean.E1,
                    E4=lean.E2 * lean.E2, E5=lean.E1 * lean.E2)
    lean = lean * dmap_scale
    base = params_to_lrep(base_params)
    return lrep_to_params(lean + base)


@pytree_dataclass
class FilteredBeckmannMaterial:
    """A Beckmann conductor with LEAN-filtered normal maps: the whole
    dj_beckmannconductor material. ``lean`` holds the per-texel (or
    per-pixel, after footprint lookup) moments."""

    lean: Lrep
    base_params: MicrofacetParams
    eta: torch.Tensor            # conductor ior (3,)
    k: torch.Tensor              # conductor extinction (3,)
    dmap_scale: torch.Tensor = None
    lean_filtering: bool = static_field(default=True)
    biased: bool = static_field(default=False)
    #: fetch from a mip pyramid selected by the path tracer's per-ray
    #: footprint (ray-cone LOD) instead of always level 0 — the LEAN
    #: minification story (the reference gets this from Mitsuba's mip
    #: machinery + its leanFiltering toggle; here the pyramid is the
    #: moment average, exact for the mixture of texel NDFs)
    mip_lod: bool = static_field(default=False)

    def params(self) -> MicrofacetParams:
        scale = 1.0 if self.dmap_scale is None else self.dmap_scale
        return filtered_params(self.lean, self.base_params, scale,
                               self.lean_filtering, self.biased)

    def pvec_provider(self):
        """Per-hit provider for the path tracer's fused loop when
        ``lean`` holds full (H, W) moment maps: the 5 LEAN moments pack
        into one (H*W, 5) table (once per render, outside the bounce
        loop), and ``assemble`` unbiases/combines/converts a fetched row
        exactly as :func:`filtered_params` — the per-shading-point LEAN
        fetch the reference runs inside any Mitsuba integrator
        (dj_beckmannconductor.cpp:280-428). Fresnel rides separately as
        the exact conductor form (the pvec f0 rows are unused)."""
        from dj_brdf_torch.render.materials import (TextureProvider,
                                                    texel_index)
        from dj_brdf_torch.render.pathtrace import _stack_pvec

        h, w = self.lean.E1.shape
        scale = 1.0 if self.dmap_scale is None else self.dmap_scale

        def pack(lrep):
            return torch.stack([lrep.E1, lrep.E2, lrep.E3, lrep.E4,
                                lrep.E5], -1).reshape(-1, 5)

        if self.mip_lod:
            # the moment pyramid flattened level-major; a lane's level
            # selects its (offset, h, w) from three (L,) tables
            levels = build_mip_pyramid(self.lean)
            packs = [pack(lv) for lv in levels]
            packed = torch.cat(packs, dim=0)
            dev = packed.device
            sizes = [p.shape[0] for p in packs]
            offs = [sum(sizes[:k]) for k in range(len(sizes))]
            off_t = torch.tensor(offs, dtype=torch.int32, device=dev)
            h_t = torch.tensor([lv.E1.shape[0] for lv in levels],
                               dtype=torch.int32, device=dev)
            w_t = torch.tensor([lv.E1.shape[1] for lv in levels],
                               dtype=torch.int32, device=dev)
            n_levels = len(levels)

            def index(uu, vv, lod=None):
                if lod is None:
                    return texel_index(h, w, uu, vv)
                # torch.round is round-half-even, as jnp.round
                lvl = torch.round(lod).to(torch.int32).clamp(0, n_levels - 1)
                h_l = h_t[lvl]
                w_l = w_t[lvl]
                yi = torch.minimum((vv * h_l).to(torch.int32).clamp(min=0),
                                   h_l - 1)
                xi = torch.minimum((uu * w_l).to(torch.int32).clamp(min=0),
                                   w_l - 1)
                return off_t[lvl] + yi * w_l + xi
        else:
            packed = pack(self.lean)

            def index(uu, vv, lod=None):
                return texel_index(h, w, uu, vv)

        def assemble(row):
            lean_px = Lrep(E1=row[..., 0], E2=row[..., 1], E3=row[..., 2],
                           E4=row[..., 3], E5=row[..., 4])
            p = filtered_params(lean_px, self.base_params, scale,
                                self.lean_filtering, self.biased)
            return _stack_pvec(p.ax, p.ay, p.rho, p.txn, p.tyn,
                               0.0, 0.0, 0.0)

        # identity-ish moments: zero mean slopes, unit second moments
        neutral = torch.tensor([0.0, 0.0, 1.0, 1.0, 0.0],
                               dtype=torch.float32, device=packed.device)
        return TextureProvider(packed=packed, h=h, w=w,
                               assemble=assemble, neutral=neutral,
                               index=index, wants_lod=self.mip_lod)

    def evalp(self, i, o):
        """f_r*cos with exact conductor Fresnel on top (reference
        :317-327; fresnelConductorExact at dot(o, h))."""
        base = mf.evalp(Beckmann(), fresnel_mod.Ideal(), self.params(), i, o)
        h = normalize(i + o, eps=1e-24)
        f = fresnel_mod.conductor_fresnel(torch.clamp(dot(o, h), 0.0, 1.0),
                                          self.eta, self.k)
        return base * f

    def sample(self, u1, u2, o):
        return mf.sample(Beckmann(), self.params(), u1, u2, o)

    def pdf(self, i, o):
        return mf.pdf(Beckmann(), self.params(), i, o)

    def evalp_is(self, u1, u2, o):
        """Sample + weight (reference evalp_is dj_brdf.h:1734-1765 with
        the plugin's conductor Fresnel, dj_beckmannconductor.cpp:
        371-428) via the fused SoA Beckmann sampler — params may be
        per-pixel (the LEAN case), they broadcast per lane."""
        from dj_brdf_torch.ops.soa import beckmann_evalp_is_soa

        p = self.params()

        def cond_f(cosd):
            f = fresnel_mod.conductor_fresnel(cosd, self.eta, self.k)
            return f[..., 0], f[..., 1], f[..., 2]

        wr, wg, wb, ix, iy, iz, pdf = beckmann_evalp_is_soa(
            (p.ax, p.ay, p.rho, p.txn, p.tyn), u1, u2,
            o[..., 0], o[..., 1], o[..., 2], fresnel_fn=cond_f)
        return (torch.stack([wr, wg, wb], -1),
                torch.stack([ix, iy, iz], -1), pdf)
