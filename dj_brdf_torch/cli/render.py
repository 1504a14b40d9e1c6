"""Render a directly lit sphere, or a path-traced sphere over a floor,
with any model of the port: the replacement for the reference's
Mitsuba matpreview scenes (mitsuba/*.cpp expose the same six material
families as BSDF plugins).

Counterpart of ``dj_brdf_tpu/cli/render.py``, with its models, options
and parse-time errors. Differences: ``--device`` is ``cuda`` by default
and is never swapped for another (without that device the program
fails); PNG output goes through the port's own codec
(:mod:`dj_brdf_torch.io.png`), so no imaging package is needed; and
``--conductor`` with a textured ``--pathtrace`` material is refused at
parse time, where the JAX program ignores it without a word.

Usage examples:
  python -m dj_brdf_torch.cli.render --model ggx --alpha1 0.3 --alpha2 0.1
  python -m dj_brdf_torch.cli.render --model merl --file brass.binary
  python -m dj_brdf_torch.cli.render --model sgd --material gold-metallic-paint
  python -m dj_brdf_torch.cli.render --model merl_fit --file brass.binary
"""

from __future__ import annotations

import argparse

from dj_brdf_torch.cli import checked_device, device_arg

MODELS = ["ggx", "beckmann", "lambert", "merl", "utia", "sgd", "abc",
          "merl_fit", "merl_tab", "utia_fit", "utia_tab", "lean"]


def parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", required=True, choices=MODELS)
    ap.add_argument("--file", help="MERL/UTIA binary "
                                   "(merl/utia/merl_fit/merl_tab/utia_fit)")
    ap.add_argument("--material", help="material name (sgd/abc)")
    ap.add_argument("--alpha1", type=float, default=0.3)
    ap.add_argument("--alpha2", type=float, default=None)
    ap.add_argument("--alpha-angle", type=float, default=0.0)
    ap.add_argument("--alpha1-map", help=".npy (H,W) texture driving "
                    "alpha1 per shading point (mitsuba/dj_brdf.cpp:353-357)")
    ap.add_argument("--alpha2-map", help=".npy (H,W) texture for alpha2")
    ap.add_argument("--alpha-angle-map",
                    help=".npy (H,W) texture for alphaAngle (radians)")
    ap.add_argument("--f0", type=float, nargs=3, default=[1.0, 1.0, 1.0])
    ap.add_argument("--fit-res", type=int, default=90,
                    help="tabulation resolution for *_fit/merl_tab "
                         "(reference uses 90)")
    ap.add_argument("--conductor", action="store_true",
                    help="multiply exact conductor Fresnel on top "
                         "(the dj_brdf plugin's Mitsuba-Fresnel path, "
                         "mitsuba/dj_brdf.cpp:366)")
    ap.add_argument("--eta", type=float, nargs=3,
                    default=[0.143, 0.375, 1.442],  # gold
                    help="conductor ior (lean/--conductor)")
    ap.add_argument("--k", type=float, nargs=3,
                    default=[3.983, 2.386, 1.603],
                    help="conductor extinction (lean/--conductor)")
    ap.add_argument("--leanmap1", help="E1,E2 map .npy (lean)")
    ap.add_argument("--leanmap2", help="E3,E4,E5 map .npy (lean)")
    ap.add_argument("--dmap-scale", type=float, default=1.0)
    ap.add_argument("--naive-mip", action="store_true",
                    help="disable LEAN filtering (leanFiltering=false)")
    ap.add_argument("--biased", action="store_true",
                    help="maps carry the +25/+625 storage bias")
    ap.add_argument("--mip", type=int, default=0,
                    help="LEAN mip level to shade with")
    ap.add_argument("--lean-lod", action="store_true",
                    help="with --pathtrace: select the LEAN mip level "
                         "per hit from the ray-cone footprint")
    ap.add_argument("--light", type=float, nargs=3, default=[0.3, 0.4, 0.8])
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--exposure", type=float, default=1.0)
    ap.add_argument("--pathtrace", action="store_true",
                    help="multi-bounce sphere-on-plane path trace "
                         "instead of the direct-light sphere")
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--bounces", type=int, default=3)
    ap.add_argument("--floor-model", default="lambert",
                    choices=["lambert", "ggx", "beckmann", "lean"],
                    help="ground-plane material for --pathtrace; 'lean' "
                         "uses --floor-leanmap1/--floor-leanmap2 (full "
                         "maps fetched per hit, the matpreview floor)")
    ap.add_argument("--floor-alpha", type=float, default=0.4,
                    help="floor roughness (ggx/beckmann) or LEAN base "
                         "roughness (lean)")
    ap.add_argument("--floor-f0", type=float, nargs=3,
                    default=[0.35, 0.35, 0.35])
    ap.add_argument("--floor-leanmap1", help="floor E1,E2 map .npy "
                    "(--floor-model lean)")
    ap.add_argument("--floor-leanmap2", help="floor E3,E4,E5 map .npy")
    ap.add_argument("--envmap", help=".npy (H,W,3) or Radiance .hdr "
                    "lat-long radiance: environment lighting with "
                    "importance sampling + MIS (replaces --light and the "
                    "constant sky; needs --pathtrace)")
    ap.add_argument("--envmap-rot-z", type=float, default=0.0,
                    help="rotate the environment emitter about +z "
                         "(degrees; the scenes' toWorld orientation)")
    ap.add_argument("-o", "--output", default="render.png")
    device_arg(ap)
    return ap


def _check_args(ap, args):
    """The parse-time errors: the JAX program's, and the refusal of
    ``--conductor`` where it would not apply (the reference's fault,
    ``dj_brdf_tpu/cli/render.py:319``)."""
    textured = args.alpha1_map or args.alpha2_map or args.alpha_angle_map
    if args.pathtrace and args.floor_model == "lambert" and (
            (textured and args.model in ("ggx", "beckmann"))
            or args.model == "lean"):
        # textured analytic / LEAN materials run only in the fused SoA
        # loop, and the default lambert floor is not fused-capable
        ap.error("textured roughness / LEAN maps under --pathtrace need "
                 "a fused-capable floor: add --floor-model "
                 "{ggx,beckmann,lean}")
    tex_models = ("ggx", "beckmann", "merl_tab", "utia_tab")
    if textured and args.pathtrace:
        if args.model not in tex_models:
            ap.error("textured roughness under --pathtrace supports "
                     "the microfacet models "
                     "(ggx/beckmann/merl_tab/utia_tab)")
        if (args.model in ("merl_tab", "utia_tab")
                and args.floor_model == "lean"):
            ap.error("textured tabular models render through the "
                     "generic loop and cannot pair with the "
                     "fused-only LEAN floor; use --floor-model "
                     "{lambert,ggx,beckmann}")
        if args.conductor:
            ap.error("--conductor does not apply to a textured --pathtrace "
                     "material (its roughness is fetched per hit inside the "
                     "bounce loop); drop --conductor or the maps")
    elif textured and args.model not in tex_models:
        ap.error(f"--alpha*-map textures apply to the microfacet "
                 f"models (ggx/beckmann/merl_tab/utia_tab), not "
                 f"{args.model}")
    if args.model == "lean" and not (args.leanmap1 and args.leanmap2):
        ap.error("--model lean requires --leanmap1 and --leanmap2")
    if args.pathtrace and args.floor_model == "lean" and not (
            args.floor_leanmap1 and args.floor_leanmap2):
        ap.error("--floor-model lean requires --floor-leanmap1 "
                 "and --floor-leanmap2")
    if args.envmap and not args.pathtrace:
        ap.error("--envmap needs --pathtrace")


def build_scene(args, device):
    """``(material, floor or None, envmap or None)`` of the parsed
    arguments, on ``device``: what :func:`main` renders."""
    import numpy as np
    import torch

    from dj_brdf_torch import fresnel
    from dj_brdf_torch.microfacet.ndf import GGX, Beckmann
    from dj_brdf_torch.microfacet.params import MicrofacetParams
    from dj_brdf_torch.models.lambert import Lambert
    from dj_brdf_torch.render.materials import (CosineMaterial,
                                                MeasuredMaterial,
                                                MicrofacetMaterial)
    from dj_brdf_torch.render.sphere import (sample_texture, sphere_normals,
                                             sphere_uv)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    def load_map(path):
        return torch.as_tensor(np.load(path), dtype=torch.float32,
                               device=device)

    a2 = args.alpha2 if args.alpha2 is not None else args.alpha1
    params = MicrofacetParams.elliptic(f32(args.alpha1), f32(a2),
                                       f32(args.alpha_angle))
    fres = fresnel.Schlick(f0=f32(args.f0))
    textured = args.alpha1_map or args.alpha2_map or args.alpha_angle_map
    uu = vv = None
    if not args.pathtrace and (textured or args.model == "lean"):
        # the sphere renderer samples maps at the preview sphere's UVs
        uu, vv = sphere_uv(sphere_normals(args.res, device=device)[0])

    def tex_or(path, const):
        """A per-pixel map at the sphere's UVs, or the constant."""
        if not path:
            return torch.full(uu.shape, const, dtype=torch.float32,
                              device=device)
        return sample_texture(load_map(path), uu, vv)

    def map_or(path, const):
        """The whole map for a per-hit fetch, or the constant."""
        return load_map(path) if path else f32(const)

    def tab_material(tab, tab_fres):
        """A tabulated-NDF material: the standard frame, per-pixel
        textures (sphere renderer) or a per-hit uv fetch (--pathtrace);
        unmapped components default to the table's unit roughness."""
        from dj_brdf_torch.render.materials import UVMappedMaterial
        if not textured:
            return MicrofacetMaterial(dist=tab, fres=tab_fres,
                                      params=MicrofacetParams.isotropic(
                                          f32(1.0)))
        if args.pathtrace:
            return UVMappedMaterial(
                dist=tab, fres=tab_fres,
                alpha1=map_or(args.alpha1_map, 1.0),
                alpha2=map_or(args.alpha2_map, 1.0),
                alpha_angle=map_or(args.alpha_angle_map, 0.0))
        return MicrofacetMaterial(dist=tab, fres=tab_fres,
                                  params=MicrofacetParams.elliptic(
                                      tex_or(args.alpha1_map, 1.0),
                                      tex_or(args.alpha2_map, 1.0),
                                      tex_or(args.alpha_angle_map, 0.0)))

    def merl():
        from dj_brdf_torch.io.merl_io import load_merl
        from dj_brdf_torch.models.merl import Merl
        return Merl(table=torch.as_tensor(load_merl(args.file),
                                          device=device))

    def utia():
        from dj_brdf_torch.io.utia_io import load_utia
        from dj_brdf_torch.models.utia import Utia
        return Utia.build(torch.as_tensor(load_utia(args.file),
                                          device=device))

    def lean_material(m1, m2, base, mip_lod, mip=0, at_pixels=False):
        from dj_brdf_torch.core.pytree import tree_map
        from dj_brdf_torch.lean.filtered import FilteredBeckmannMaterial
        from dj_brdf_torch.lean.lrep import Lrep
        from dj_brdf_torch.lean.maps import build_mip_pyramid
        m1, m2 = load_map(m1), load_map(m2)
        lean = Lrep(E1=m1[..., 0], E2=m1[..., 1], E3=m2[..., 0],
                    E4=m2[..., 1], E5=m2[..., 2])
        if mip > 0:
            pyramid = build_mip_pyramid(lean)
            lean = pyramid[min(mip, len(pyramid) - 1)]
        if at_pixels:
            lean = tree_map(lambda t: sample_texture(t, uu, vv), lean)
        return FilteredBeckmannMaterial(
            lean=lean, base_params=base, eta=f32(args.eta), k=f32(args.k),
            dmap_scale=f32(args.dmap_scale),
            lean_filtering=not args.naive_mip, biased=args.biased,
            mip_lod=mip_lod)

    if args.model in ("ggx", "beckmann"):
        dist = GGX() if args.model == "ggx" else Beckmann()
        if textured and args.pathtrace:
            from dj_brdf_torch.render.materials import \
                TexturedMicrofacetMaterial
            mat = TexturedMicrofacetMaterial(
                dist=dist, fres=fres,
                alpha1=map_or(args.alpha1_map, args.alpha1),
                alpha2=map_or(args.alpha2_map, a2),
                alpha_angle=map_or(args.alpha_angle_map, args.alpha_angle))
        else:
            if textured:
                params = MicrofacetParams.elliptic(
                    tex_or(args.alpha1_map, args.alpha1),
                    tex_or(args.alpha2_map, a2),
                    tex_or(args.alpha_angle_map, args.alpha_angle))
            mat = MicrofacetMaterial(dist=dist, fres=fres, params=params)
    elif args.model == "lambert":
        mat = CosineMaterial(model=Lambert(reflectance=f32(args.f0)))
    elif args.model == "merl":
        mat = MeasuredMaterial.from_merl(merl().table)
    elif args.model == "utia":
        mat = CosineMaterial(model=utia())
    elif args.model in ("sgd", "abc"):
        if args.model == "sgd":
            from dj_brdf_torch.models.sgd import SGD as Model
        else:
            from dj_brdf_torch.models.abc_model import ABC as Model
        mat = MeasuredMaterial.from_model(
            Model.from_name(args.material, device=device), device=device)
    elif args.model in ("merl_fit", "merl_tab"):
        # merl_fit: the dj_merl plugin path, a GGX proxy rendered with the
        # extracted Fresnel (mitsuba/dj_merl.cpp:29-33); merl_tab: the
        # dj_brdf plugin with distribution="tabular" + merl, the
        # extracted table itself (mitsuba/dj_brdf.cpp:208-233)
        from dj_brdf_torch.fit import moments, tabular
        fit = args.model == "merl_fit"
        tab, tab_fres = tabular.build_tabular(merl(), args.fit_res,
                                              shadow=not fit)
        mat = (MicrofacetMaterial(dist=GGX(), fres=tab_fres,
                                  params=moments.fit_ggx_parameters(tab))
               if fit else tab_material(tab, tab_fres))
    elif args.model in ("utia_fit", "utia_tab"):
        # the dj_brdf plugin's UTIA path: the anisotropic tabulation at
        # scene load, and either the anisotropic moment fit's Beckmann
        # (utia_fit) or the table itself (utia_tab)
        # (mitsuba/dj_brdf.cpp:234-259)
        from dj_brdf_torch.fit import moments, tabular_aniso
        tab, tab_fres = tabular_aniso.build_tabular_anisotropic(
            utia(), args.fit_res, args.fit_res)
        if args.model == "utia_fit":
            mat = MicrofacetMaterial(
                dist=Beckmann(), fres=tab_fres,
                params=moments.fit_beckmann_parameters_anisotropic(tab))
        else:
            mat = tab_material(tab, tab_fres)
    else:
        # lean: the dj_beckmannconductor plugin, LEAN maps + base
        # roughness + exact conductor Fresnel; the sphere renderer samples
        # the moments at its pixels, the path tracer fetches per hit
        mat = lean_material(args.leanmap1, args.leanmap2, params,
                            args.lean_lod and args.pathtrace, args.mip,
                            at_pixels=not args.pathtrace)

    if args.conductor and isinstance(mat, MicrofacetMaterial):
        # fresnelConductorExact multiplied on top (dj_brdf.cpp:366, 430)
        from dj_brdf_torch.render.materials import ConductorWrap
        mat = ConductorWrap(inner=mat, eta=f32(args.eta), k=f32(args.k))

    if not args.pathtrace:
        return mat, None, None
    if args.floor_model == "lambert":
        floor = CosineMaterial(model=Lambert(
            reflectance=f32([0.42, 0.42, 0.45])))
    elif args.floor_model in ("ggx", "beckmann"):
        floor = MicrofacetMaterial(
            dist=GGX() if args.floor_model == "ggx" else Beckmann(),
            fres=fresnel.Schlick(f0=f32(args.floor_f0)),
            params=MicrofacetParams.isotropic(f32(args.floor_alpha)))
    else:   # lean: the matpreview floor, full maps fetched per hit
        floor = lean_material(args.floor_leanmap1, args.floor_leanmap2,
                              MicrofacetParams.isotropic(
                                  f32(args.floor_alpha)), args.lean_lod)
    em = None
    if args.envmap:
        from dj_brdf_torch.io.hdr import load_radiance_any
        from dj_brdf_torch.render.envmap import EnvMap
        rot = (EnvMap.rotation_z(np.deg2rad(args.envmap_rot_z),
                                 device=device)
               if args.envmap_rot_z else None)
        em = EnvMap.build(torch.as_tensor(load_radiance_any(args.envmap)),
                          rotation=rot, device=device)
    return mat, floor, em


#: the path-traced scene's delta light and sky (the JAX program's)
LIGHT_RADIANCE = (3.0, 3.0, 3.0)
SKY_RADIANCE = (0.3, 0.38, 0.5)


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    _check_args(ap, args)

    import numpy as np
    import torch

    device = checked_device(args.device)
    with torch.no_grad():
        mat, floor, em = build_scene(args, device)
        if args.pathtrace:
            from dj_brdf_torch.render.pathtrace import render
            img = render(mat, floor, tuple(args.light), LIGHT_RADIANCE,
                         SKY_RADIANCE, res=args.res, spp=args.spp,
                         max_bounces=args.bounces, envmap=em,
                         generator=torch.Generator(device=device)
                         .manual_seed(0))
        else:
            from dj_brdf_torch.render.sphere import render_sphere
            img = render_sphere(mat.evalp, tuple(args.light), res=args.res,
                                device=device)
        if args.output.endswith(".npy"):
            # raw HDR radiance (before exposure and gamma) for numeric use
            np.save(args.output, img.cpu().numpy())
        else:
            from dj_brdf_torch.io import png
            arr = (torch.clamp(img * args.exposure, 0.0, 1.0)
                   ** (1 / 2.2)).cpu().numpy()
            png.write_png(args.output, (arr * 255).astype(np.uint8))
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
