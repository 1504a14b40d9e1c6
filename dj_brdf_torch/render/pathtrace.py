"""A small differentiable path tracer.

The reference delegates light transport to Mitsuba's integrators and
only supplies BSDF plugins (mitsuba/*.cpp); this renderer is the port's
equivalent: a sphere-on-ground-plane scene ("matpreview" style), a
fixed bounce count, and any two materials (sphere + floor) with their
own importance samplers, lit either by a directional (delta) light plus
a constant sky, with next-event estimation, or by a lat-long
environment map, with emitter and BSDF sampling combined by multiple
importance sampling. Differentiable end-to-end w.r.t. material
parameters, texture and LEAN maps and the envmap radiance (sampled
directions are detached).

Two loop families, chosen from the materials: when both are
fused-capable (uniform GGX or Beckmann + Schlick
:class:`~dj_brdf_torch.render.materials.MicrofacetMaterial`,
``TexturedMicrofacetMaterial``, ``FilteredBeckmannMaterial``), the flat
component-array (SoA) loops with the fused samplers of
:mod:`dj_brdf_torch.ops.soa` (one dual-family pass for a GGX/Beckmann
pair, per-hit texture fetches, a ray cone for mip-level selection, and
for the delta light an spp-deduplicated first bounce when a Beckmann
side is present); otherwise the generic loops, which evaluate both
materials on (N, 3) tensors and select.

Counterpart of ``dj_brdf_tpu/render/pathtrace.py``. ``lax.scan``
becomes a Python loop over bounces, and the random numbers come from an
explicit ``torch.Generator`` on the render's device, or are injected
(``u``, ``u_env``, ``jitter_offsets``) so a test can feed both packages
the same numbers. With ``mesh=`` the pixels are sharded over the ranks
of a ``torch.distributed`` group (each rank traces every sample of its
pixels) and the image is all-gathered.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from dj_brdf_torch.core.math import cross, dot, normalize, vec3
from dj_brdf_torch.render.sphere import _build_frame
from dj_brdf_torch.utils.profiling import span

_EPS = 1e-3


def world_to_local(n, v):
    t, b = _build_frame(n)
    return vec3(dot(v, t), dot(v, b), dot(v, n))


def local_to_world(n, v):
    t, b = _build_frame(n)
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def _intersect(ro, rd):
    """Unit sphere at origin + ground plane z = -1.
    Returns (hit, t, n_world, is_sphere)."""
    # sphere |ro + t rd|^2 = 1
    b = dot(ro, rd)
    c = dot(ro, ro) - 1.0
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_s = torch.where(disc > 0.0, -b - sq, math.inf)
    t_s = torch.where(t_s > _EPS, t_s, math.inf)

    # plane z = -1
    dz = rd[..., 2]
    t_p = (-1.0 - ro[..., 2]) / torch.where(torch.abs(dz) < 1e-9, 1e-9, dz)
    t_p = torch.where((t_p > _EPS) & (torch.abs(dz) > 1e-9), t_p, math.inf)

    is_sphere = t_s < t_p
    t = torch.minimum(t_s, t_p)
    hit = torch.isfinite(t)
    pos = ro + t[..., None] * rd
    n_sphere = normalize(pos, eps=1e-12)
    n_plane = torch.zeros_like(ro)
    n_plane[..., 2] = 1.0
    n = torch.where(is_sphere[..., None], n_sphere, n_plane)
    return hit, t, n, is_sphere


def _occluded(pos, dir_w):
    hit, _, _, _ = _intersect(pos, dir_w)
    return hit


def _material_eval(mats, is_sphere, fn_name, *args):
    """Static two-way material dispatch: evaluate both, select."""
    with span("dj.render.bsdf"):
        a = getattr(mats[0], fn_name)(*args)
        b = getattr(mats[1], fn_name)(*args)

    def sel(x, y):
        mask = is_sphere
        while mask.dim() < x.dim():
            mask = mask[..., None]
        return torch.where(mask, x, y)

    if isinstance(a, tuple):
        return tuple(sel(x, y) for x, y in zip(a, b))
    return sel(a, b)


def _mats_at_hit(mats, is_sphere, pos):
    """Per-hit material specialization for the generic loops: materials
    exposing ``at_uv`` (UVMappedMaterial, textured alphas over tabular
    or any distributions) fetch their textures at the hit's uv and
    return an ordinary per-lane-parameter material; others pass
    through. The generic-loop half of the reference's per-shading-point
    texture evaluation (dj_brdf.cpp:353-357 with
    distribution="tabular")."""
    if not any(hasattr(m, "at_uv") for m in mats):
        return mats
    uu, vv = _hit_uv(is_sphere, pos[..., 0], pos[..., 1], pos[..., 2])
    return tuple(m.at_uv(uu, vv) if hasattr(m, "at_uv") else m
                 for m in mats)


class _FusedInfo(NamedTuple):
    """Material description for the fused SoA render loops (static
    dispatch, like the reference's plugin-construction-time
    distribution resolution, mitsuba/dj_brdf.cpp:193-204)."""
    family: str            # "ggx" | "beck"
    caps: bool             # GGX spherical-caps sampler
    pvec: object           # (8,) uniform params, or None when textured
    pvec_at: object        # TextureProvider of per-hit params, or None
    conductor: object      # (eta, k) exact conductor Fresnel, or None


def _lean_leaves(mat):
    lean = mat.lean
    return (lean.E1, lean.E2, lean.E3, lean.E4, lean.E5)


def _fused_info(mat):
    """_FusedInfo when ``mat`` qualifies for the fused SoA samplers,
    else None. Covers: uniform GGX/Beckmann + Schlick
    MicrofacetMaterial, textured-alpha TexturedMicrofacetMaterial
    (per-hit roughness fetch, mitsuba/dj_brdf.cpp:353-357), and
    FilteredBeckmannMaterial with uniform or full-map LEAN moments
    (dj_beckmannconductor.cpp:280-428 fetches LEAN maps per shading
    point inside any integrator)."""
    from dj_brdf_torch.lean.filtered import FilteredBeckmannMaterial
    from dj_brdf_torch.microfacet.ndf import Beckmann, GGXSphericalCaps
    from dj_brdf_torch.render.materials import (MicrofacetMaterial,
                                                TexturedMicrofacetMaterial)

    if isinstance(mat, TexturedMicrofacetMaterial):
        fam_caps = mat._fused_family()
        if fam_caps is None:
            return None
        fam, caps = fam_caps
        return _FusedInfo(fam, caps, None, mat.pvec_provider(), None)
    if isinstance(mat, MicrofacetMaterial):
        pv = mat._fused_pvec()
        if pv is None:
            return None
        fam = "beck" if type(mat.dist) is Beckmann else "ggx"
        return _FusedInfo(fam, isinstance(mat.dist, GGXSphericalCaps), pv,
                          None, None)
    if isinstance(mat, FilteredBeckmannMaterial):
        leaves = _lean_leaves(mat)
        cond = (mat.eta, mat.k)
        if all(getattr(x, "ndim", 0) == 0 for x in leaves):
            p = mat.params()
            pv = _stack_pvec(p.ax, p.ay, p.rho, p.txn, p.tyn, 0.0, 0.0, 0.0)
            return _FusedInfo("beck", False, pv, None, cond)
        if (all(getattr(x, "ndim", 0) == 2 for x in leaves)
                and len({tuple(x.shape) for x in leaves}) == 1):
            return _FusedInfo("beck", False, None, mat.pvec_provider(),
                              cond)
        # mixed scalar/map moments (or mismatched map shapes) have no
        # sensible per-hit fetch: fail loudly
        raise ValueError(
            "FilteredBeckmannMaterial LEAN moments must be all scalar "
            "or all (H, W) maps of one shape for the path tracer; got "
            f"shapes {[tuple(getattr(x, 'shape', ())) for x in leaves]}")
    return None


def _stack_pvec(ax, ay, rho, txn, tyn, f0r, f0g, f0b):
    """Broadcast-stack parameter components into the samplers' (8,) or
    (8, N) pvec layout, on the device of the tensors among them."""
    xs = (ax, ay, rho, txn, tyn, f0r, f0g, f0b)
    tensors = sorted((x for x in xs if isinstance(x, torch.Tensor)),
                     key=lambda x: x.dim() == 0)
    device = tensors[0].device if tensors else None
    parts = [torch.as_tensor(x, dtype=torch.float32, device=device)
             for x in xs]
    shape = torch.broadcast_shapes(*[p.shape for p in parts])
    return torch.stack([p.expand(shape) for p in parts])


# uv period of the ground plane: one texture tile spans 4x4 world units
# (the sphere has radius 1), the role of the scene's uv parameterization
# in the reference's Mitsuba scenes
PLANE_UV_SCALE = 0.25


def _hit_uv(is_sphere, px, py, pz):
    """Per-hit texture coordinates: spherical uv on the sphere (the
    convention of render.sphere.sphere_uv) and tiled world-xy on the
    ground plane."""
    phi = torch.atan2(py, px)
    u_sph = torch.remainder(phi / (2.0 * math.pi), 1.0)
    v_sph = torch.arccos(torch.clamp(pz, -1.0, 1.0)) / math.pi
    u_pln = torch.remainder(px * PLANE_UV_SCALE, 1.0)
    v_pln = torch.remainder(py * PLANE_UV_SCALE, 1.0)
    return (torch.where(is_sphere, u_sph, u_pln),
            torch.where(is_sphere, v_sph, v_pln))


def _select_pvec(is_sphere, pv0, pv1):
    if pv0.dim() == 1:
        pv0 = pv0[:, None]
    if pv1.dim() == 1:
        pv1 = pv1[:, None]
    return torch.where(is_sphere[None, :], pv0, pv1)


def _make_fres_fn(infos, is_sphere, pv):
    """Per-lane Fresnel closure for the fused samplers when a material
    carries exact conductor Fresnel (the dj_beckmannconductor path);
    None = Schlick from the pvec rows."""
    if all(info.conductor is None for info in infos):
        return None
    from dj_brdf_torch.fresnel import conductor_fresnel

    def fres_fn(cosd):
        if any(info.conductor is None for info in infos):
            c1 = 1.0 - cosd
            c5 = (c1 * c1) * (c1 * c1) * c1
            fr = pv[5] + c5 * (1.0 - pv[5])
            fg = pv[6] + c5 * (1.0 - pv[6])
            fb = pv[7] + c5 * (1.0 - pv[7])
        else:
            fr = fg = fb = torch.zeros_like(cosd)
        for mask, info in ((is_sphere, infos[0]), (~is_sphere, infos[1])):
            if info.conductor is not None:
                eta, k = info.conductor
                f = conductor_fresnel(cosd, eta, k)
                fr = torch.where(mask, f[..., 0], fr)
                fg = torch.where(mask, f[..., 1], fg)
                fb = torch.where(mask, f[..., 2], fb)
        return fr, fg, fb

    return fres_fn


def _is_textured(mat):
    from dj_brdf_torch.lean.filtered import FilteredBeckmannMaterial
    from dj_brdf_torch.render.materials import TexturedMicrofacetMaterial

    return isinstance(mat, TexturedMicrofacetMaterial) or (
        isinstance(mat, FilteredBeckmannMaterial)
        and any(getattr(x, "ndim", 0) == 2 for x in _lean_leaves(mat)))


def _check_no_textured_fallback(mats):
    """Textured materials fetch per-hit parameters inside the fused SoA
    loops only; the generic loops have no uv plumbing for them. Raise a
    useful error instead of failing deep in the loop."""
    for mat in mats:
        if _is_textured(mat):
            raise ValueError(
                f"{type(mat).__name__} with texture maps needs the fused "
                "SoA path: pair it with a fused-capable material "
                "(GGX/Beckmann + Schlick MicrofacetMaterial, "
                "TexturedMicrofacetMaterial, or FilteredBeckmannMaterial)"
                " — the generic loop cannot fetch per-hit textures")


def _texture_ctx(infos):
    """When BOTH materials carry packed textures, pad their tables to a
    common width and concatenate them once (outside the bounce loop):
    sphere and floor lanes are disjoint, so one row read per bounce
    serves both materials' fetches. Returns (combined, row_offset,
    widths) or None."""
    provs = [info.pvec_at for info in infos]
    if any(p is None or p.packed is None for p in provs):
        return None
    k0 = provs[0].packed.shape[1]
    k1 = provs[1].packed.shape[1]
    k = max(k0, k1)

    def pad(t):
        return torch.nn.functional.pad(t, (0, k - t.shape[1]))

    combined = torch.cat([pad(provs[0].packed), pad(provs[1].packed)], 0)
    return combined, provs[0].packed.shape[0], (k0, k1)


def _needs_lod(infos):
    """True when some provider fetches from a mip pyramid (ray-cone
    LOD); the render loops track footprints only then."""
    return any(info.pvec_at is not None and info.pvec_at.wants_lod
               for info in infos)


def _lod_for(provider, is_sphere, cone_w):
    """Per-lane mip level from the ray cone's world-space width: the uv
    footprint is width x du/dworld of the hit geometry (sphere equator:
    1/2pi; plane: the uv tiling scale), and the level is log2 of that
    footprint in base-level texels — the ray-cones texture LOD
    (isotropic footprint; incidence elongation ignored)."""
    if cone_w is None or not provider.wants_lod:
        return None
    fp_uv = cone_w * torch.where(is_sphere, 1.0 / (2.0 * math.pi),
                                 PLANE_UV_SCALE)
    return torch.log2(torch.clamp(fp_uv * provider.w, min=1e-9))


def _resolve_scene(infos, tex_ctx, is_sphere, px, py, pz, cone_w=None):
    """Per-lane (8, N) pvec + Fresnel closure for a bounce's hit points:
    textured materials fetch their maps at the per-hit uv (mip level
    from the ray-cone footprint when the provider wants LOD), uniform
    materials broadcast. With two textured materials the fetch is ONE
    read of the combined table (``tex_ctx``); otherwise one per
    textured material."""
    if any(info.pvec is None for info in infos):
        uu, vv = _hit_uv(is_sphere, px, py, pz)
    if tex_ctx is not None:
        combined, off, (k0, k1) = tex_ctx
        p0, p1 = infos[0].pvec_at, infos[1].pvec_at
        idx0 = p0.index(uu, vv, _lod_for(p0, is_sphere, cone_w))
        idx1 = p1.index(uu, vv, _lod_for(p1, is_sphere, cone_w)) + off
        row = combined.index_select(0, torch.where(is_sphere, idx0, idx1))
        # off-lane bytes belong to the OTHER material: each provider's
        # neutral row goes there, so its assembly math never sees them
        # (keeps the backward free of 0 * inf NaNs)
        m = is_sphere[..., None]
        pvs = [p0.assemble(torch.where(m, row[..., :k0], p0.neutral)),
               p1.assemble(torch.where(m, p1.neutral, row[..., :k1]))]
    else:
        def resolve(info):
            if info.pvec is not None:
                return info.pvec
            p = info.pvec_at
            if p.packed is None:
                return p.assemble(None)
            idx = p.index(uu, vv, _lod_for(p, is_sphere, cone_w))
            return p.assemble(p.packed.index_select(0, idx))

        pvs = [resolve(info) for info in infos]
    pv = _select_pvec(is_sphere, *pvs)
    return pv, _make_fres_fn(infos, is_sphere, pv)


def _first_tensor(obj, depth=0):
    """The first tensor among a (nested) dataclass's fields."""
    if isinstance(obj, torch.Tensor):
        return obj
    if depth > 4 or not dataclasses.is_dataclass(obj):
        return None
    for f in dataclasses.fields(obj):
        t = _first_tensor(getattr(obj, f.name), depth + 1)
        if t is not None:
            return t
    return None


def _render_device(u, u_env, generator, objs):
    """``u``'s device, else ``u_env``'s, else the generator's, else that
    of the first tensor of the materials and the envmap; the card when
    there is none."""
    for x in (u, u_env, generator):
        if x is not None:
            return x.device
    for obj in objs:
        t = _first_tensor(obj)
        if t is not None:
            return t.device
    return torch.device("cuda")


def _fused_nee_and_sample(infos, pv, fres_fn, is_sphere, l_comp, u1, u2,
                          o_comp, with_pdf: bool = False):
    """NEE evalp + BSDF sample through the fused SoA samplers: one pass
    per op on the per-lane-selected (8, N) ``pv`` for same-family pairs,
    one dual-family pass for a GGX/Beckmann pair. ``pv``/``fres_fn``
    from :func:`_resolve_scene`. Returns the 10-tuple (fr, fg, fb, wr,
    wg, wb, ix, iy, iz, pdf); ``with_pdf`` also returns the BSDF
    sampler's pdf at the NEE direction after (fr, fg, fb), the MIS
    counter-pdf of environment lighting (an 11-tuple)."""
    from dj_brdf_torch.ops import soa

    fam0, caps0 = infos[0].family, infos[0].caps
    fam1, caps1 = infos[1].family, infos[1].caps
    lx, ly, lz = l_comp
    ox, oy, oz = o_comp

    def run(fam, caps):
        if fam == "beck":
            nee = soa.beckmann_evalp_soa(pv, lx, ly, lz, ox, oy, oz,
                                         with_pdf=with_pdf, fresnel_fn=fres_fn)
            out = soa.beckmann_evalp_is_soa(pv, u1, u2, ox, oy, oz,
                                            fresnel_fn=fres_fn)
        else:
            nee = soa.ggx_evalp_soa(pv, lx, ly, lz, ox, oy, oz,
                                    with_pdf=with_pdf, fresnel_fn=fres_fn)
            out = soa.ggx_evalp_is_soa(pv, u1, u2, ox, oy, oz, caps=caps,
                                       fresnel_fn=fres_fn)
        return nee + out

    with span("dj.render.bsdf"):
        if fam0 == fam1 and caps0 == caps1:
            return run(fam0, caps0)
        if {fam0, fam1} == {"ggx", "beck"}:
            # one dual-family pass; the GGX lanes keep their material's
            # sampler (caps or qf)
            is_beck = is_sphere if fam0 == "beck" else ~is_sphere
            ggx_caps = caps0 if fam0 == "ggx" else caps1
            return soa.mixed_nee_evalp_is_soa(pv, is_beck, lx, ly, lz,
                                              u1, u2, ox, oy, oz,
                                              caps=ggx_caps,
                                              with_nee_pdf=with_pdf,
                                              fresnel_fn=fres_fn)
        res0 = run(fam0, caps0)
        res1 = run(fam1, caps1)
        return tuple(torch.where(is_sphere, a, b) for a, b in zip(res0, res1))


def _fused_nee_eval(infos, pv, fres_fn, is_sphere, l_comp, o_comp):
    """NEE evalp only (fr, fg, fb) — the spp-deduplicated first bounce
    evaluates the light term once per pixel."""
    from dj_brdf_torch.ops import soa

    fam0, fam1 = infos[0].family, infos[1].family
    lx, ly, lz = l_comp
    ox, oy, oz = o_comp

    def run(fam):
        evalp = soa.beckmann_evalp_soa if fam == "beck" else soa.ggx_evalp_soa
        return evalp(pv, lx, ly, lz, ox, oy, oz, fresnel_fn=fres_fn)

    with span("dj.render.bsdf"):
        if fam0 == fam1:
            return run(fam0)
        res0 = run(fam0)
        res1 = run(fam1)
        return tuple(torch.where(is_sphere, a, b) for a, b in zip(res0, res1))


def _fused_sample(infos, pv, fres_fn, is_sphere, u1, u2, o_comp):
    """BSDF sample + IS weight only (wr, wg, wb, ix, iy, iz, pdf)."""
    from dj_brdf_torch.ops import soa

    fam0, caps0 = infos[0].family, infos[0].caps
    fam1, caps1 = infos[1].family, infos[1].caps
    ox, oy, oz = o_comp

    def run(fam, caps):
        if fam == "beck":
            return soa.beckmann_evalp_is_soa(pv, u1, u2, ox, oy, oz,
                                             fresnel_fn=fres_fn)
        return soa.ggx_evalp_is_soa(pv, u1, u2, ox, oy, oz, caps=caps,
                                    fresnel_fn=fres_fn)

    with span("dj.render.bsdf"):
        if fam0 == fam1 and caps0 == caps1:
            return run(fam0, caps0)
        if {fam0, fam1} == {"ggx", "beck"}:
            is_beck = is_sphere if fam0 == "beck" else ~is_sphere
            zero = torch.zeros_like(ox)
            return soa.mixed_nee_evalp_is_soa(pv, is_beck, zero, zero, zero,
                                              u1, u2, ox, oy, oz,
                                              caps=caps0 or caps1,
                                              with_nee=False,
                                              fresnel_fn=fres_fn)
        res0 = run(fam0, caps0)
        res1 = run(fam1, caps1)
        return tuple(torch.where(is_sphere, a, b) for a, b in zip(res0, res1))


def _intersect_soa(rox, roy, roz, rdx, rdy, rdz):
    """Component-array intersection (same scene and semantics as
    :func:`_intersect`): returns (hit, t, nx, ny, nz, is_sphere, px, py,
    pz)."""
    with span("dj.render.intersect"):
        b = rox * rdx + roy * rdy + roz * rdz
        c = rox * rox + roy * roy + roz * roz - 1.0
        disc = b * b - c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t_s = torch.where(disc > 0.0, -b - sq, math.inf)
        t_s = torch.where(t_s > _EPS, t_s, math.inf)

        t_p = (-1.0 - roz) / torch.where(torch.abs(rdz) < 1e-9, 1e-9, rdz)
        t_p = torch.where((t_p > _EPS) & (torch.abs(rdz) > 1e-9), t_p,
                          math.inf)

        is_sphere = t_s < t_p
        t = torch.minimum(t_s, t_p)
        hit = torch.isfinite(t)
        ts = torch.where(hit, t, 0.0)  # keep miss-lane positions finite
        px, py, pz = rox + ts * rdx, roy + ts * rdy, roz + ts * rdz
        inrm = torch.rsqrt(torch.clamp(px * px + py * py + pz * pz, min=1e-24))
        nx = torch.where(is_sphere, px * inrm, 0.0)
        ny = torch.where(is_sphere, py * inrm, 0.0)
        nz = torch.where(is_sphere, pz * inrm, 1.0)
        return hit, t, nx, ny, nz, is_sphere, px, py, pz


def _build_frame_soa(nx, ny, nz):
    """Branchless tangent frame (Duff et al.), component form of
    render.sphere._build_frame."""
    s = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    tx, ty, tz = 1.0 + s * nx * nx * a, s * b, -s * nx
    bx, by, bz = b, s + ny * ny * a, -ny
    return tx, ty, tz, bx, by, bz


_FOV_SCALE = 0.62


def camera_rays(res: int, spp: int, jitter_offsets=None, device=None):
    """The pinhole camera looking -y at the sphere: (ro, rd), each
    (res*res*spp, 3), sample-major (all pixels of copy 0 first).
    ``jitter_offsets`` (N, 2) perturbs each sample's sensor position."""
    f32 = dict(dtype=torch.float32, device=device)
    cam_pos = torch.tensor([0.0, 3.2, 0.6], **f32)
    look = normalize(-cam_pos)
    right = normalize(cross(look, torch.tensor([0.0, 0.0, 1.0], **f32)))
    up = cross(right, look)

    xs = (torch.arange(res, **f32) + 0.5) / res * 2.0 - 1.0
    px, py = torch.meshgrid(xs, -xs, indexing="xy")
    px = px.reshape(-1).repeat(spp)
    py = py.reshape(-1).repeat(spp)
    if jitter_offsets is not None:
        px = px + jitter_offsets[:, 0]
        py = py + jitter_offsets[:, 1]
    rd = normalize(look + _FOV_SCALE * (px[..., None] * right
                                        + py[..., None] * up))
    ro = torch.broadcast_to(cam_pos, rd.shape)
    return ro, rd


def _uniforms(name, x, shape, f32):
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must be (max_bounces, res*res*spp, "
                         f"{shape[2]}) = {shape}, got {tuple(x.shape)}")
    return x.to(**f32)


def render(sphere_mat, floor_mat, light_dir, light_radiance, sky_radiance,
           res: int = 256, spp: int = 8, max_bounces: int = 3,
           generator=None, u=None, jitter: bool = False,
           jitter_offsets=None, envmap=None, u_env=None, mesh=None):
    """Path-trace the scene. Returns an (res, res, 3) HDR image.

    ``sphere_mat``/``floor_mat``: any material with evalp/evalp_is in
    the local frame (see render.materials and lean.filtered); textured
    ones (TexturedMicrofacetMaterial, FilteredBeckmannMaterial with LEAN
    maps) fetch their parameters per hit in the fused loops, and
    UVMappedMaterial in the generic ones. ``light_dir`` points *toward*
    the light (a delta directional light).

    ``envmap``: an optional :class:`~dj_brdf_torch.render.envmap.EnvMap`
    on the render's device. It REPLACES the delta light and the constant
    sky: every bounce combines envmap importance sampling with BSDF
    sampling by the power heuristic (MIS), and misses read the envmap
    radiance with the matching weight. Differentiable w.r.t. the
    envmap radiance (through ``EnvMap.rebind``) and the materials.

    Random numbers: ``u`` (max_bounces, N, 2) uniforms for the BSDF
    samplers, N = res*res*spp, and with an envmap ``u_env``
    (max_bounces, N, 3) for its draws (bin row + accept, bin column +
    phi offset, theta offset); each is drawn from ``generator`` (a
    ``torch.Generator`` on the render's device; a fresh one seeded 0
    when None) unless given, ``u_env`` after ``u`` and the jitter
    offsets, so delta-light renders draw as before. ``jitter=True``
    perturbs each sample's sensor position uniformly within its pixel
    footprint, by ``jitter_offsets`` (N, 2) in [-1/res, 1/res) when
    given, else by draws from ``generator``; ``jitter=False`` keeps all
    spp copies of a pixel on one camera ray, which makes the
    spp-deduplicated first bounce an identity.

    The render runs on ``u``'s device, else ``u_env``'s, else the
    generator's, else that of the materials' or the envmap's tensors,
    else on the card (without a card that raises); on a CUDA device
    every step runs there.

    ``mesh``: a :class:`~dj_brdf_torch.parallel.mesh.Mesh`. The rays are
    sample-major (ray ``s * P + p`` is sample ``s`` of pixel ``p``, P =
    res*res), and the spp-deduplicated first bounce needs every sample of
    a pixel in one place, so the PIXEL axis is sharded: each rank traces
    all spp samples of its block of pixels (padded to a multiple of the
    ranks). ``u``, ``u_env`` and the jitter offsets are drawn (or given)
    globally and sliced the same way, so the sharded frame equals the
    unsharded one; the per-pixel radiance is all-gathered. Gradients
    w.r.t. the materials and the envmap reach every rank as the
    unsharded gradient (:meth:`~dj_brdf_torch.parallel.mesh.Mesh.
    replicated` behind a differentiable gather)."""
    mats = (sphere_mat, floor_mat)
    device = _render_device(u, u_env, generator, (*mats, envmap))
    f32 = dict(dtype=torch.float32, device=device)
    light_dir = normalize(torch.as_tensor(light_dir, **f32))
    light_rad = torch.as_tensor(light_radiance, **f32)
    sky_rad = torch.as_tensor(sky_radiance, **f32)

    n_rays = res * res * spp
    if jitter_offsets is not None and (
            not jitter or tuple(jitter_offsets.shape) != (n_rays, 2)):
        raise ValueError("jitter_offsets must be (res*res*spp, 2) and "
                         "come with jitter=True")
    if generator is None and (u is None or (jitter and jitter_offsets
                                            is None)
                              or (envmap is not None and u_env is None)):
        generator = torch.Generator(device=device).manual_seed(0)
    if jitter and jitter_offsets is None:
        jitter_offsets = (torch.rand((n_rays, 2), generator=generator, **f32)
                          * 2.0 - 1.0) / res
    ro, rd = camera_rays(res, spp, jitter_offsets, device)
    if u is None:
        u = torch.rand((max_bounces, n_rays, 2), generator=generator, **f32)
    u = _uniforms("u", u, (max_bounces, n_rays, 2), f32)
    cone_spread0 = 2.0 * _FOV_SCALE / res
    if envmap is not None:
        if u_env is None:
            u_env = torch.rand((max_bounces, n_rays, 3), generator=generator,
                               **f32)
        u_env = _uniforms("u_env", u_env, (max_bounces, n_rays, 3), f32)
    n_pix = res * res
    if mesh is not None:
        # every sample of this rank's pixels, still sample-major
        pix = torch.arange(mesh.padded(n_pix),
                           device=device)[mesh.block(n_pix)] % n_pix
        rays = (torch.arange(spp, device=device)[:, None] * n_pix
                + pix[None, :]).reshape(-1)
        ro, rd, u = ro[rays], rd[rays], u[:, rays]
        if u_env is not None:
            u_env = u_env[:, rays]
        mats, envmap = mesh.replicated((mats, envmap))
    radiance = _trace(mats, light_dir, light_rad, sky_rad, ro, rd, u,
                      u_env, envmap, spp, dedup_ok=not jitter,
                      cone_spread0=cone_spread0)
    pixels = _sample_mean(radiance, spp)
    if mesh is not None:
        pixels = mesh.all_gather(pixels, n=n_pix)
    return pixels.reshape(res, res, 3)


def _sample_mean(radiance, spp):
    """(P, 3) pixels from the (spp * P, 3) sample-major radiance: the spp
    samples added one after another, then divided. Elementwise adds give
    every pixel the same bits whatever block of pixels it is traced in;
    ``mean(dim=0)`` on the CPU sums in an order that depends on P."""
    samples = radiance.reshape(spp, -1, 3)
    total = samples[0]
    for k in range(1, spp):
        total = total + samples[k]
    return total / spp


def _trace(mats, light_dir, light_rad, sky_rad, ro, rd, u, u_env, envmap,
           spp, dedup_ok, cone_spread0):
    """Per-ray radiance (N, 3) of sample-major rays, by the loop the
    materials and the emitter select."""
    # static material dispatch: both materials fused-capable -> the flat
    # component-array (SoA) loops; otherwise the generic both-evaluate
    # loops on (N, 3) tensors
    infos = tuple(_fused_info(mat) for mat in mats)
    fused = all(x is not None for x in infos)
    if not fused:
        _check_no_textured_fallback(mats)
    if envmap is not None:
        if fused:
            return _render_envmap_soa(infos, envmap, ro, rd, u, u_env,
                                      cone_spread0=cone_spread0)
        return _render_envmap(mats, envmap, ro, rd, u, u_env)
    if fused:
        return _render_soa(infos, light_dir, light_rad, sky_rad, ro, rd, u,
                           spp, dedup_ok=dedup_ok, cone_spread0=cone_spread0)
    return _render_generic(mats, light_dir, light_rad, sky_rad, ro, rd, u)


def _render_generic(mats, light_dir, light_rad, sky_rad, ro, rd, u):
    """The generic loop: both materials evaluated on (N, 3) tensors,
    selected per ray."""
    n_rays = rd.shape[0]
    throughput = torch.ones_like(rd)
    radiance = torch.zeros_like(rd)
    alive = torch.ones(n_rays, dtype=torch.bool, device=rd.device)
    light = torch.broadcast_to(light_dir, rd.shape)
    for u_b in u:
        with span("dj.render.bounce"):
            hit, t, n, is_sphere = _intersect(ro, rd)

            # miss -> sky
            radiance = radiance + torch.where(
                (alive & ~hit)[..., None], throughput * sky_rad, 0.0)
            alive = alive & hit

            pos = ro + t[..., None] * rd
            o_loc = world_to_local(n, -rd)
            mats_b = _mats_at_hit(mats, is_sphere,
                                  torch.where(hit[..., None], pos, ro))

            # next-event estimation toward the delta light
            i_loc = world_to_local(n, light)
            shadow_o = pos + n * _EPS * 3.0
            lit = ~_occluded(shadow_o, light)

            f = _material_eval(mats_b, is_sphere, "evalp", i_loc, o_loc)
            w, i_s, pdf = _material_eval(mats_b, is_sphere, "evalp_is",
                                         u_b[:, 0], u_b[:, 1], o_loc)

            contrib = throughput * light_rad * f
            ok = alive & lit & (i_loc[..., 2] > 0.0) & (o_loc[..., 2] > 0.0)
            radiance = radiance + torch.where(ok[..., None], contrib, 0.0)

            throughput = throughput * torch.where(alive[..., None], w, 1.0)
            alive = alive & (pdf > 0.0) & (i_s[..., 2] > 0.0)
            # detached sampling — see _bounce_soa
            i_s = i_s.detach()
            rd_new = normalize(local_to_world(n, i_s), eps=1e-12)
            ro_new = pos + n * _EPS * 3.0
            ro = torch.where(alive[..., None], ro_new, ro)
            rd = torch.where(alive[..., None], rd_new, rd)
    # terminate remaining paths into the sky
    hit, _, _, _ = _intersect(ro, rd)
    return radiance + torch.where((alive & ~hit)[..., None],
                                  throughput * sky_rad, 0.0)


def _render_envmap(mats, em, ro, rd, u, u_env):
    """Environment-lit transport with multiple importance sampling, the
    generic loop (any material with evalp/pdf/evalp_is).

    Per bounce: one envmap NEE sample (divided by its true pdf, weighted
    by the power heuristic against the BSDF's pdf at that direction)
    plus one BSDF sample whose radiance is collected at the NEXT
    segment's miss, weighted against the envmap's pdf there. The camera
    ray's direct envmap hit carries weight 1 (no competing strategy)."""
    from dj_brdf_torch.render.envmap import power_heuristic

    def env_lookup(d):
        """radiance + sampling pdf toward d: one packed row read."""
        with span("dj.render.envmap"):
            r, g, b, pdf = em.eval_with_pdf(d[..., 0], d[..., 1], d[..., 2])
            return torch.stack([r, g, b], -1), pdf

    n_rays = rd.shape[0]
    throughput = torch.ones_like(rd)
    radiance = torch.zeros_like(rd)
    alive = torch.ones(n_rays, dtype=torch.bool, device=rd.device)
    prev_pdf = torch.full((n_rays,), -1.0, dtype=torch.float32,
                          device=rd.device)
    for u_bsdf, u_nee in zip(u, u_env):
        with span("dj.render.bounce"):
            hit, t, n, is_sphere = _intersect(ro, rd)

            # miss -> envmap radiance, MIS-weighted against the pdf of the
            # BSDF sample that produced this segment (prev_pdf < 0 marks the
            # deterministic camera ray: weight 1)
            le_miss, pdf_env_rd = env_lookup(rd)
            w_mis = torch.where(prev_pdf < 0.0, 1.0,
                                power_heuristic(prev_pdf, pdf_env_rd))
            miss = alive & ~hit
            radiance = radiance + torch.where(
                miss[..., None], throughput * le_miss * w_mis[..., None], 0.0)
            alive = alive & hit

            pos = ro + t[..., None] * rd
            o_loc = world_to_local(n, -rd)
            mats_b = _mats_at_hit(mats, is_sphere,
                                  torch.where(hit[..., None], pos, ro))

            # next-event estimation: one envmap importance sample
            with span("dj.render.envmap"):
                ldx, ldy, ldz, pdf_l = em.sample(u_nee[:, 0], u_nee[:, 1],
                                                 u_nee[:, 2])
            l_world = torch.stack([ldx, ldy, ldz], -1)
            l_loc = world_to_local(n, l_world)
            shadow_o = pos + n * _EPS * 3.0
            lit = ~_occluded(shadow_o, l_world)

            f = _material_eval(mats_b, is_sphere, "evalp", l_loc, o_loc)
            pdf_b_at_l = _material_eval(mats_b, is_sphere, "pdf", l_loc, o_loc)
            le, _ = env_lookup(l_world)
            w_nee = power_heuristic(pdf_l, torch.clamp(pdf_b_at_l, min=0.0))
            contrib = (throughput * le * f
                       * (w_nee / torch.clamp(pdf_l, min=1e-12))[..., None])
            ok = alive & lit & (l_loc[..., 2] > 0.0) & (o_loc[..., 2] > 0.0)
            radiance = radiance + torch.where(ok[..., None], contrib, 0.0)

            # BSDF sampling continues the path; its pdf feeds the next
            # segment's MIS weight
            w, i_s, pdf = _material_eval(mats_b, is_sphere, "evalp_is",
                                         u_bsdf[:, 0], u_bsdf[:, 1], o_loc)
            throughput = throughput * torch.where(alive[..., None], w, 1.0)
            alive = alive & (pdf > 0.0) & (i_s[..., 2] > 0.0)
            # detached sampling — see _bounce_soa
            i_s = i_s.detach()
            rd_new = normalize(local_to_world(n, i_s), eps=1e-12)
            ro = torch.where(alive[..., None], shadow_o, ro)
            rd = torch.where(alive[..., None], rd_new, rd)
            prev_pdf = torch.where(alive, pdf, prev_pdf)
    # terminate remaining live paths into the envmap (MIS-weighted)
    hit, _, _, _ = _intersect(ro, rd)
    miss = alive & ~hit
    le_fin, pdf_env_fin = env_lookup(rd)
    w_mis = torch.where(prev_pdf < 0.0, 1.0,
                        power_heuristic(prev_pdf, pdf_env_fin))
    return radiance + torch.where(
        miss[..., None], throughput * le_fin * w_mis[..., None], 0.0)


def _bounce_soa(infos, tex_ctx, state, cone, u_b, light_dir, light_rad,
                sky_rad):
    """One bounce of the delta-light SoA loop on the carry ``state`` =
    (rox, roy, roz, rdx, rdy, rdz, th_r, th_g, th_b, ra_r, ra_g, ra_b,
    alive) and, when a material fetches from a mip pyramid, the ray cone
    ``cone`` = (width, spread): the width grows linearly along the
    segment, the spread widens at each glossy bounce by the sampled
    lane's roughness. Returns (state, cone)."""
    (rox, roy, roz, rdx, rdy, rdz, th_r, th_g, th_b,
     ra_r, ra_g, ra_b, alive) = state
    ldx, ldy, ldz = light_dir[0], light_dir[1], light_dir[2]
    off = _EPS * 3.0
    hit, t, nx, ny, nz, is_sphere, px, py, pz = _intersect_soa(
        rox, roy, roz, rdx, rdy, rdz)
    cw = None
    if cone is not None:
        cw, cs = cone
        cw = cw + cs * torch.where(hit, t, 0.0)

    # miss -> sky
    miss = alive & ~hit
    ra_r = ra_r + torch.where(miss, th_r * sky_rad[0], 0.0)
    ra_g = ra_g + torch.where(miss, th_g * sky_rad[1], 0.0)
    ra_b = ra_b + torch.where(miss, th_b * sky_rad[2], 0.0)
    alive = alive & hit

    tx, ty, tz, bx, by, bz = _build_frame_soa(nx, ny, nz)
    # o = -rd and the light direction in the tangent frame
    ox = -(rdx * tx + rdy * ty + rdz * tz)
    oy = -(rdx * bx + rdy * by + rdz * bz)
    oz = -(rdx * nx + rdy * ny + rdz * nz)
    lx = ldx * tx + ldy * ty + ldz * tz
    ly = ldx * bx + ldy * by + ldz * bz
    lz = ldx * nx + ldy * ny + ldz * nz

    # next-event estimation toward the delta light
    sox, soy, soz = px + nx * off, py + ny * off, pz + nz * off
    s_hit = _intersect_soa(sox, soy, soz, ldx.expand_as(sox),
                           ldy.expand_as(sox), ldz.expand_as(sox))[0]
    lit = ~s_hit

    pv, fres_fn = _resolve_scene(infos, tex_ctx, is_sphere, px, py, pz,
                                 cone_w=cw)
    fr, fg, fb, wr, wg, wb, ixl, iyl, izl, pdf = _fused_nee_and_sample(
        infos, pv, fres_fn, is_sphere, (lx, ly, lz), u_b[0], u_b[1],
        (ox, oy, oz))

    ok = alive & lit & (lz > 0.0) & (oz > 0.0)
    ra_r = ra_r + torch.where(ok, th_r * light_rad[0] * fr, 0.0)
    ra_g = ra_g + torch.where(ok, th_g * light_rad[1] * fg, 0.0)
    ra_b = ra_b + torch.where(ok, th_b * light_rad[2] * fb, 0.0)

    th_r = th_r * torch.where(alive, wr, 1.0)
    th_g = th_g * torch.where(alive, wg, 1.0)
    th_b = th_b * torch.where(alive, wb, 1.0)
    alive = alive & (pdf > 0.0) & (izl > 0.0)

    # detached sampling (the Mitsuba-3 default): differentiate the
    # weights along FIXED paths — the reparameterization gradient
    # through sampled directions into the next intersection is
    # unbounded at grazing hits (d sqrt(disc) -> inf) and noisy
    ixl, iyl, izl = ixl.detach(), iyl.detach(), izl.detach()

    # next segment: local_to_world + normalize
    wx = ixl * tx + iyl * bx + izl * nx
    wy = ixl * ty + iyl * by + izl * ny
    wz = ixl * tz + iyl * bz + izl * nz
    inrm = torch.rsqrt(torch.clamp(wx * wx + wy * wy + wz * wz, min=1e-12))
    rdx = torch.where(alive, wx * inrm, rdx)
    rdy = torch.where(alive, wy * inrm, rdy)
    rdz = torch.where(alive, wz * inrm, rdz)
    rox = torch.where(alive, sox, rox)
    roy = torch.where(alive, soy, roy)
    roz = torch.where(alive, soz, roz)
    if cone is not None:
        cone = (cw, cs + torch.where(alive, torch.clamp(pv[0], max=1.0), 0.0))
    return (rox, roy, roz, rdx, rdy, rdz, th_r, th_g, th_b,
            ra_r, ra_g, ra_b, alive), cone


def _render_soa(infos, light_dir, light_rad, sky_rad, ro, rd, u,
                spp: int, dedup_ok: bool = True,
                cone_spread0: float = 0.0):
    """The fused-material render loop on flat (N,) component arrays:
    path state, intersection, tangent frames and both BSDF ops stay
    SoA end to end. Semantics match the generic loop to f32 rounding;
    the random numbers are laid out as there, so the two paths
    integrate the same sample set.

    The FIRST bounce is spp-deduplicated when a Beckmann side is
    present (its NEE evaluation is the expensive one) and all spp copies
    of a pixel share the camera ray (``dedup_ok``): intersection,
    tangent frame, shadow ray, texture fetch and NEE evaluation run once
    per pixel (P = N/spp lanes) and are tiled; only the BSDF sampler,
    which consumes the per-copy random numbers, runs at full ray count.
    The values are those of the per-ray computation (same ops, same
    inputs)."""
    n_rays = rd.shape[0]
    tex_ctx = _texture_ctx(infos)
    track_lod = _needs_lod(infos)
    f32 = dict(dtype=torch.float32, device=rd.device)
    # (B, N, 2) -> (B, 2, N): contiguous planes for each bounce
    u = u.movedim(-1, 1).contiguous()
    sk_r, sk_g, sk_b = sky_rad[0], sky_rad[1], sky_rad[2]

    def run_bounces(state, cone, u_bounces):
        for u_b in u_bounces:
            with span("dj.render.bounce"):
                state, cone = _bounce_soa(infos, tex_ctx, state, cone, u_b,
                                          light_dir, light_rad, sky_rad)
        return state

    dedup = (dedup_ok and spp > 1
             and any(info.family == "beck" for info in infos))
    if not dedup:
        ones = torch.ones(n_rays, **f32)
        zeros = torch.zeros_like(ones)
        state = (ro[..., 0], ro[..., 1], ro[..., 2],
                 rd[..., 0], rd[..., 1], rd[..., 2],
                 ones, ones, ones, zeros, zeros, zeros,
                 torch.ones(n_rays, dtype=torch.bool, device=rd.device))
        cone = ((zeros, torch.full((n_rays,), cone_spread0, **f32))
                if track_lod else None)
        return _finish_soa(run_bounces(state, cone, u), sk_r, sk_g, sk_b)

    ldx, ldy, ldz = light_dir[0], light_dir[1], light_dir[2]
    lr_r, lr_g, lr_b = light_rad[0], light_rad[1], light_rad[2]
    off = _EPS * 3.0
    P = n_rays // spp

    def tile(a):
        return a.repeat(spp)

    with span("dj.render.bounce"):
        rox_p, roy_p, roz_p = ro[:P, 0], ro[:P, 1], ro[:P, 2]
        rdx_p, rdy_p, rdz_p = rd[:P, 0], rd[:P, 1], rd[:P, 2]
        hit_p, t_p, nx_p, ny_p, nz_p, is_sph_p, px_p, py_p, pz_p = \
            _intersect_soa(rox_p, roy_p, roz_p, rdx_p, rdy_p, rdz_p)
        cw_p = (cone_spread0 * torch.where(hit_p, t_p, 0.0)
                if track_lod else None)
        tx_p, ty_p, tz_p, bx_p, by_p, bz_p = _build_frame_soa(nx_p, ny_p, nz_p)
        ox_p = -(rdx_p * tx_p + rdy_p * ty_p + rdz_p * tz_p)
        oy_p = -(rdx_p * bx_p + rdy_p * by_p + rdz_p * bz_p)
        oz_p = -(rdx_p * nx_p + rdy_p * ny_p + rdz_p * nz_p)
        lx_p = ldx * tx_p + ldy * ty_p + ldz * tz_p
        ly_p = ldx * bx_p + ldy * by_p + ldz * bz_p
        lz_p = ldx * nx_p + ldy * ny_p + ldz * nz_p
        sox_p, soy_p, soz_p = (px_p + nx_p * off, py_p + ny_p * off,
                               pz_p + nz_p * off)
        s_hit_p = _intersect_soa(sox_p, soy_p, soz_p, ldx.expand_as(sox_p),
                                 ldy.expand_as(sox_p), ldz.expand_as(sox_p))[0]
        pv_p, fres_p = _resolve_scene(infos, tex_ctx, is_sph_p, px_p, py_p,
                                      pz_p, cone_w=cw_p)
        fr_p, fg_p, fb_p = _fused_nee_eval(infos, pv_p, fres_p, is_sph_p,
                                           (lx_p, ly_p, lz_p),
                                           (ox_p, oy_p, oz_p))
        # per-pixel radiance terms of bounce 1 (throughput = 1, all alive)
        ok_p = hit_p & ~s_hit_p & (lz_p > 0.0) & (oz_p > 0.0)
        ra1_r = (torch.where(~hit_p, sk_r, 0.0)
                 + torch.where(ok_p, lr_r * fr_p, 0.0))
        ra1_g = (torch.where(~hit_p, sk_g, 0.0)
                 + torch.where(ok_p, lr_g * fg_p, 0.0))
        ra1_b = (torch.where(~hit_p, sk_b, 0.0)
                 + torch.where(ok_p, lr_b * fb_p, 0.0))

        # the sampler consumes per-copy randoms: full ray count (the
        # per-pixel pvec and Fresnel tiled with the other per-pixel values)
        alive1 = tile(hit_p)
        is_sph1 = tile(is_sph_p)
        o1 = (tile(ox_p), tile(oy_p), tile(oz_p))
        pv1t = pv_p.repeat(1, spp)
        fres1t = _make_fres_fn(infos, is_sph1, pv1t)
        wr1, wg1, wb1, ix1, iy1, iz1, pdf1 = _fused_sample(
            infos, pv1t, fres1t, is_sph1, u[0][0], u[0][1], o1)
        th_r = torch.where(alive1, wr1, 1.0)
        th_g = torch.where(alive1, wg1, 1.0)
        th_b = torch.where(alive1, wb1, 1.0)
        alive1 = alive1 & (pdf1 > 0.0) & (iz1 > 0.0)
        # detached sampling — see the bounce body
        ix1, iy1, iz1 = ix1.detach(), iy1.detach(), iz1.detach()
        wx = ix1 * tile(tx_p) + iy1 * tile(bx_p) + iz1 * tile(nx_p)
        wy = ix1 * tile(ty_p) + iy1 * tile(by_p) + iz1 * tile(ny_p)
        wz = ix1 * tile(tz_p) + iy1 * tile(bz_p) + iz1 * tile(nz_p)
        inrm1 = torch.rsqrt(torch.clamp(wx * wx + wy * wy + wz * wz,
                                        min=1e-12))
        state = (torch.where(alive1, tile(sox_p), tile(rox_p)),
                 torch.where(alive1, tile(soy_p), tile(roy_p)),
                 torch.where(alive1, tile(soz_p), tile(roz_p)),
                 torch.where(alive1, wx * inrm1, tile(rdx_p)),
                 torch.where(alive1, wy * inrm1, tile(rdy_p)),
                 torch.where(alive1, wz * inrm1, tile(rdz_p)),
                 th_r, th_g, th_b,
                 tile(ra1_r), tile(ra1_g), tile(ra1_b),
                 alive1)
        cone = None
        if track_lod:
            cone = (tile(cw_p), cone_spread0 + torch.where(
                alive1, torch.clamp(pv1t[0], max=1.0), 0.0))
    return _finish_soa(run_bounces(state, cone, u[1:]), sk_r, sk_g, sk_b)


def _finish_soa(state, sk_r, sk_g, sk_b):
    """Terminate remaining live paths into the sky: the per-ray radiance
    (N, 3) of the SoA carry."""
    (rox, roy, roz, rdx, rdy, rdz, th_r, th_g, th_b,
     ra_r, ra_g, ra_b, alive) = state
    hit = _intersect_soa(rox, roy, roz, rdx, rdy, rdz)[0]
    miss = alive & ~hit
    ra_r = ra_r + torch.where(miss, th_r * sk_r, 0.0)
    ra_g = ra_g + torch.where(miss, th_g * sk_g, 0.0)
    ra_b = ra_b + torch.where(miss, th_b * sk_b, 0.0)

    return torch.stack([ra_r, ra_g, ra_b], -1)


def _render_envmap_soa(infos, em, ro, rd, u, u_env,
                       cone_spread0: float = 0.0):
    """Environment-lit MIS transport on flat component arrays with the
    fused samplers, the SoA counterpart of :func:`_render_envmap`. Per
    bounce exactly TWO emitter row reads: one 4-wide alias row for the
    importance draw (direction + exact pdf), and one packed row serving
    the miss lanes' radiance+pdf (at the segment direction) and the
    surviving lanes' NEE radiance (at the drawn direction): miss and
    NEE lanes are disjoint, so they share the read. Plus ONE fused
    material pass producing the NEE eval, its MIS counter-pdf and the
    BSDF sample together (a GGX/Beckmann pair keeps the dual-family
    pass)."""
    from dj_brdf_torch.render.envmap import power_heuristic

    n_rays = rd.shape[0]
    h_em, w_em = em.radiance.shape[:2]
    u = u.movedim(-1, 1).contiguous()
    u_env = u_env.movedim(-1, 1).contiguous()
    off = _EPS * 3.0
    tex_ctx = _texture_ctx(infos)
    track_lod = _needs_lod(infos)
    f32 = dict(dtype=torch.float32, device=rd.device)

    rox, roy, roz = ro[..., 0], ro[..., 1], ro[..., 2]
    rdx, rdy, rdz = rd[..., 0], rd[..., 1], rd[..., 2]
    th_r = th_g = th_b = torch.ones(n_rays, **f32)
    ra_r = ra_g = ra_b = torch.zeros(n_rays, **f32)
    alive = torch.ones(n_rays, dtype=torch.bool, device=rd.device)
    prev_pdf = torch.full((n_rays,), -1.0, **f32)
    cw = None
    if track_lod:
        cw = torch.zeros(n_rays, **f32)
        cs = torch.full((n_rays,), cone_spread0, **f32)
    for u_bsdf, u_nee in zip(u, u_env):
        with span("dj.render.bounce"):
            hit, t, nx, ny, nz, is_sphere, px, py, pz = _intersect_soa(
                rox, roy, roz, rdx, rdy, rdz)
            if track_lod:
                cw = cw + cs * torch.where(hit, t, 0.0)
            miss = alive & ~hit

            with span("dj.render.envmap"):
                # emitter importance draw: grid position + exact bin density
                # from ONE alias-row read
                tg, pg, pb_l = em.sample_grid(u_nee[0], u_nee[1], u_nee[2])
                theta_l = tg * (math.pi / h_em)
                phi_l = pg * (2.0 * math.pi / w_em)
                sin_l = torch.sin(theta_l)
                llx = sin_l * torch.cos(phi_l)
                lly = sin_l * torch.sin(phi_l)
                llz = torch.cos(theta_l)
                ldx, ldy, ldz = em._to_world(llx, lly, llz)
                pdf_l = pb_l / torch.clamp(sin_l, min=1e-6)

                # one packed read: miss lanes at the segment direction's cell,
                # surviving lanes at the NEE cell (disjoint)
                mlx, mly, mlz = em._to_local(rdx, rdy, rdz)
                idx_m, f1m, f2m, sin_m = em._cell(mlx, mly, mlz)
                idx_n, f1n, f2n = em._cell_from_grid(tg, pg)
                idx = torch.where(miss, idx_m, idx_n)
                f1 = torch.where(miss, f1m, f1n)
                f2 = torch.where(miss, f2m, f2n)
                cr, cg, cb, pb_sel = em._lookup(idx, f1, f2)

                # miss -> envmap radiance with MIS against the generating BSDF
                # pdf (prev_pdf < 0 marks the camera ray)
                pdf_env_rd = pb_sel / sin_m
                w_mis = torch.where(prev_pdf < 0.0, 1.0,
                                    power_heuristic(prev_pdf, pdf_env_rd))
                ra_r = ra_r + torch.where(miss, th_r * cr * w_mis, 0.0)
                ra_g = ra_g + torch.where(miss, th_g * cg * w_mis, 0.0)
                ra_b = ra_b + torch.where(miss, th_b * cb * w_mis, 0.0)
                alive = alive & hit

            tx, ty, tz, bx, by, bz = _build_frame_soa(nx, ny, nz)
            ox = -(rdx * tx + rdy * ty + rdz * tz)
            oy = -(rdx * bx + rdy * by + rdz * bz)
            oz = -(rdx * nx + rdy * ny + rdz * nz)

            # NEE radiance: the same read's values on the surviving lanes
            lx = ldx * tx + ldy * ty + ldz * tz
            ly = ldx * bx + ldy * by + ldz * bz
            lz = ldx * nx + ldy * ny + ldz * nz

            sox, soy, soz = px + nx * off, py + ny * off, pz + nz * off
            lit = ~_intersect_soa(sox, soy, soz, ldx, ldy, ldz)[0]

            pv, fres_fn = _resolve_scene(infos, tex_ctx, is_sphere, px, py, pz,
                                         cone_w=cw)
            (fr, fg, fb, pdf_nee, wr, wg, wb, ixl, iyl, izl,
             pdf) = _fused_nee_and_sample(
                infos, pv, fres_fn, is_sphere, (lx, ly, lz), u_bsdf[0],
                u_bsdf[1], (ox, oy, oz), with_pdf=True)

            with span("dj.render.envmap"):
                w_nee = (power_heuristic(pdf_l, pdf_nee)
                         / torch.clamp(pdf_l, min=1e-12))
            ok = alive & lit & (lz > 0.0) & (oz > 0.0)
            scale = torch.where(ok, w_nee, 0.0)
            ra_r = ra_r + th_r * cr * fr * scale
            ra_g = ra_g + th_g * cg * fg * scale
            ra_b = ra_b + th_b * cb * fb * scale

            th_r = th_r * torch.where(alive, wr, 1.0)
            th_g = th_g * torch.where(alive, wg, 1.0)
            th_b = th_b * torch.where(alive, wb, 1.0)
            alive = alive & (pdf > 0.0) & (izl > 0.0)

            # detached sampling — see _bounce_soa
            ixl, iyl, izl = ixl.detach(), iyl.detach(), izl.detach()
            wx = ixl * tx + iyl * bx + izl * nx
            wy = ixl * ty + iyl * by + izl * ny
            wz = ixl * tz + iyl * bz + izl * nz
            inrm = torch.rsqrt(torch.clamp(wx * wx + wy * wy + wz * wz,
                                           min=1e-12))
            rdx = torch.where(alive, wx * inrm, rdx)
            rdy = torch.where(alive, wy * inrm, rdy)
            rdz = torch.where(alive, wz * inrm, rdz)
            rox = torch.where(alive, sox, rox)
            roy = torch.where(alive, soy, roy)
            roz = torch.where(alive, soz, roz)
            prev_pdf = torch.where(alive, pdf, prev_pdf)
            if track_lod:
                cs = cs + torch.where(alive, torch.clamp(pv[0], max=1.0), 0.0)

    # terminate remaining live paths into the envmap (MIS-weighted)
    hit = _intersect_soa(rox, roy, roz, rdx, rdy, rdz)[0]
    miss = alive & ~hit
    with span("dj.render.envmap"):
        mr, mg, mb, pdf_env_fin = em.eval_with_pdf(rdx, rdy, rdz)
        w_mis = torch.where(prev_pdf < 0.0, 1.0,
                            power_heuristic(prev_pdf, pdf_env_fin))
        ra_r = ra_r + torch.where(miss, th_r * mr * w_mis, 0.0)
        ra_g = ra_g + torch.where(miss, th_g * mg * w_mis, 0.0)
        ra_b = ra_b + torch.where(miss, th_b * mb * w_mis, 0.0)
    return torch.stack([ra_r, ra_g, ra_b], -1)
