"""A small differentiable path tracer: delta-light transport.

The reference delegates light transport to Mitsuba's integrators and
only supplies BSDF plugins (mitsuba/*.cpp); this renderer is the port's
equivalent: a sphere-on-ground-plane scene ("matpreview" style), a
fixed bounce count, next-event estimation for a directional (delta)
light plus a constant sky, and any two materials (sphere + floor) with
their own importance samplers. Differentiable end-to-end w.r.t.
material parameters (sampled directions are detached).

Two loops, chosen from the materials: when both are uniform GGX or
Beckmann + Schlick :class:`~dj_brdf_torch.render.materials.
MicrofacetMaterial`, the flat component-array (SoA) loop with the fused
samplers of :mod:`dj_brdf_torch.ops.soa` (one dual-family pass for a
GGX/Beckmann pair, and an spp-deduplicated first bounce when a
Beckmann side is present); otherwise the generic loop, which evaluates
both materials on (N, 3) tensors and selects.

Counterpart of ``dj_brdf_tpu/render/pathtrace.py``'s delta-light
transport. ``lax.scan`` becomes a Python loop over bounces, and the
random numbers come from an explicit ``torch.Generator`` on the
render's device, or are injected (``u``, ``jitter_offsets``) so a test
can feed both packages the same numbers. Environment maps
(``envmap=``), sharding (``mesh=``), textured materials and LEAN's
``FilteredBeckmannMaterial`` are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from dj_brdf_torch.core.math import cross, dot, normalize, vec3
from dj_brdf_torch.render.sphere import _build_frame

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


class _FusedInfo(NamedTuple):
    """Material description for the fused SoA render loop (static
    dispatch, like the reference's plugin-construction-time
    distribution resolution, mitsuba/dj_brdf.cpp:193-204)."""
    family: str            # "ggx" | "beck"
    caps: bool             # GGX spherical-caps sampler
    pvec: torch.Tensor     # (8,) uniform params


def _fused_info(mat):
    """_FusedInfo when ``mat`` qualifies for the fused SoA samplers (a
    uniform GGX/Beckmann + Schlick MicrofacetMaterial), else None."""
    from dj_brdf_torch.microfacet.ndf import Beckmann, GGXSphericalCaps
    from dj_brdf_torch.render.materials import MicrofacetMaterial

    if not isinstance(mat, MicrofacetMaterial):
        return None
    pv = mat._fused_pvec()
    if pv is None:
        return None
    fam = "beck" if type(mat.dist) is Beckmann else "ggx"
    return _FusedInfo(fam, isinstance(mat.dist, GGXSphericalCaps), pv)


def _select_pvec(is_sphere, pv0, pv1):
    if pv0.dim() == 1:
        pv0 = pv0[:, None]
    if pv1.dim() == 1:
        pv1 = pv1[:, None]
    return torch.where(is_sphere[None, :], pv0, pv1)


def _check_ported(mats, envmap, mesh):
    """Raise for what later slices port, naming the slice, before any
    work: the renderer never falls into another loop for them."""
    if envmap is not None:
        raise NotImplementedError(
            "envmap= (environment-map MIS transport) is not ported yet: it "
            "comes with the environment-map slice (render/envmap.py)")
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (sharded rendering) is not ported yet: it comes with "
            "slice 4 (torch.distributed)")
    for mat in mats:
        name = type(mat).__name__
        if hasattr(mat, "lean") or name == "FilteredBeckmannMaterial":
            raise NotImplementedError(
                f"{name} (LEAN filtering) is not ported yet: it comes with "
                "the LEAN slice (lean/)")
        if (hasattr(mat, "at_uv") or hasattr(mat, "pvec_provider")
                or _has_texture(mat)):
            raise NotImplementedError(
                f"textured {name} is not ported yet: per-hit texture "
                "fetches come with the textured-materials slice")


def _has_texture(mat):
    """True when a material's parameters are per-pixel maps rather
    than scalars."""
    params = getattr(mat, "params", None)
    if params is None or not dataclasses.is_dataclass(params):
        return False
    return any(torch.as_tensor(getattr(params, f.name)).dim() != 0
               for f in dataclasses.fields(params))


def _first_tensor(obj, depth=0):
    """The first tensor among a (nested) dataclass material's fields."""
    if isinstance(obj, torch.Tensor):
        return obj
    if depth > 4 or not dataclasses.is_dataclass(obj):
        return None
    for f in dataclasses.fields(obj):
        t = _first_tensor(getattr(obj, f.name), depth + 1)
        if t is not None:
            return t
    return None


def _render_device(u, generator, mats):
    """``u``'s device, else the generator's, else that of the first
    material tensor; the card when there is none."""
    if u is not None:
        return u.device
    if generator is not None:
        return generator.device
    for mat in mats:
        t = _first_tensor(mat)
        if t is not None:
            return t.device
    return torch.device("cuda")


def _fused_nee_and_sample(infos, pv, is_sphere, l_comp, u1, u2, o_comp):
    """NEE evalp + BSDF sample through the fused SoA samplers: one pass
    per op on the per-lane-selected (8, N) ``pv`` for same-family pairs,
    one dual-family pass for a GGX/Beckmann pair. Returns the 10-tuple
    (fr, fg, fb, wr, wg, wb, ix, iy, iz, pdf)."""
    from dj_brdf_torch.ops import soa

    fam0, caps0 = infos[0].family, infos[0].caps
    fam1, caps1 = infos[1].family, infos[1].caps
    lx, ly, lz = l_comp
    ox, oy, oz = o_comp

    def run(fam, caps):
        if fam == "beck":
            f3 = soa.beckmann_evalp_soa(pv, lx, ly, lz, ox, oy, oz)
            out = soa.beckmann_evalp_is_soa(pv, u1, u2, ox, oy, oz)
        else:
            f3 = soa.ggx_evalp_soa(pv, lx, ly, lz, ox, oy, oz)
            out = soa.ggx_evalp_is_soa(pv, u1, u2, ox, oy, oz, caps=caps)
        return f3 + out

    if fam0 == fam1 and caps0 == caps1:
        return run(fam0, caps0)
    if {fam0, fam1} == {"ggx", "beck"}:
        # one dual-family pass; the GGX lanes keep their material's
        # sampler (caps or qf)
        is_beck = is_sphere if fam0 == "beck" else ~is_sphere
        ggx_caps = caps0 if fam0 == "ggx" else caps1
        return soa.mixed_nee_evalp_is_soa(pv, is_beck, lx, ly, lz,
                                          u1, u2, ox, oy, oz, caps=ggx_caps)
    res0 = run(fam0, caps0)
    res1 = run(fam1, caps1)
    return tuple(torch.where(is_sphere, a, b) for a, b in zip(res0, res1))


def _fused_nee_eval(infos, pv, is_sphere, l_comp, o_comp):
    """NEE evalp only (fr, fg, fb) — the spp-deduplicated first bounce
    evaluates the light term once per pixel."""
    from dj_brdf_torch.ops import soa

    fam0, fam1 = infos[0].family, infos[1].family
    lx, ly, lz = l_comp
    ox, oy, oz = o_comp

    def run(fam):
        evalp = soa.beckmann_evalp_soa if fam == "beck" else soa.ggx_evalp_soa
        return evalp(pv, lx, ly, lz, ox, oy, oz)

    if fam0 == fam1:
        return run(fam0)
    res0 = run(fam0)
    res1 = run(fam1)
    return tuple(torch.where(is_sphere, a, b) for a, b in zip(res0, res1))


def _fused_sample(infos, pv, is_sphere, u1, u2, o_comp):
    """BSDF sample + IS weight only (wr, wg, wb, ix, iy, iz, pdf)."""
    from dj_brdf_torch.ops import soa

    fam0, caps0 = infos[0].family, infos[0].caps
    fam1, caps1 = infos[1].family, infos[1].caps
    ox, oy, oz = o_comp

    def run(fam, caps):
        if fam == "beck":
            return soa.beckmann_evalp_is_soa(pv, u1, u2, ox, oy, oz)
        return soa.ggx_evalp_is_soa(pv, u1, u2, ox, oy, oz, caps=caps)

    if fam0 == fam1 and caps0 == caps1:
        return run(fam0, caps0)
    if {fam0, fam1} == {"ggx", "beck"}:
        is_beck = is_sphere if fam0 == "beck" else ~is_sphere
        zero = torch.zeros_like(ox)
        return soa.mixed_nee_evalp_is_soa(pv, is_beck, zero, zero, zero,
                                          u1, u2, ox, oy, oz,
                                          caps=caps0 or caps1,
                                          with_nee=False)
    res0 = run(fam0, caps0)
    res1 = run(fam1, caps1)
    return tuple(torch.where(is_sphere, a, b) for a, b in zip(res0, res1))


def _intersect_soa(rox, roy, roz, rdx, rdy, rdz):
    """Component-array intersection (same scene and semantics as
    :func:`_intersect`): returns (hit, t, nx, ny, nz, is_sphere, px, py,
    pz)."""
    b = rox * rdx + roy * rdy + roz * rdz
    c = rox * rox + roy * roy + roz * roz - 1.0
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_s = torch.where(disc > 0.0, -b - sq, math.inf)
    t_s = torch.where(t_s > _EPS, t_s, math.inf)

    t_p = (-1.0 - roz) / torch.where(torch.abs(rdz) < 1e-9, 1e-9, rdz)
    t_p = torch.where((t_p > _EPS) & (torch.abs(rdz) > 1e-9), t_p, math.inf)

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
    fov_scale = 0.62
    rd = normalize(look + fov_scale * (px[..., None] * right
                                       + py[..., None] * up))
    ro = torch.broadcast_to(cam_pos, rd.shape)
    return ro, rd


def render(sphere_mat, floor_mat, light_dir, light_radiance, sky_radiance,
           res: int = 256, spp: int = 8, max_bounces: int = 3,
           generator=None, u=None, jitter: bool = False,
           jitter_offsets=None, envmap=None, mesh=None):
    """Path-trace the scene. Returns an (res, res, 3) HDR image.

    ``sphere_mat``/``floor_mat``: any material with evalp/evalp_is in
    the local frame (see render.materials). ``light_dir`` points
    *toward* the light (a delta directional light).

    Random numbers: ``u`` (max_bounces, N, 2) uniforms for the BSDF
    samplers, N = res*res*spp, drawn from ``generator`` (a
    ``torch.Generator`` on the render's device; a fresh one seeded 0
    when None) unless given. ``jitter=True`` perturbs each sample's
    sensor position uniformly within its pixel footprint, by
    ``jitter_offsets`` (N, 2) in [-1/res, 1/res) when given, else by
    draws from ``generator``; ``jitter=False`` keeps all spp copies of a
    pixel on one camera ray, which makes the spp-deduplicated first
    bounce an identity.

    The render runs on ``u``'s device, else the generator's, else that
    of the materials' tensors, else on the card (without a card that
    raises); on a CUDA device every step runs there.

    ``envmap=`` and ``mesh=`` are not ported yet and raise
    ``NotImplementedError``, as do textured and LEAN materials."""
    mats = (sphere_mat, floor_mat)
    _check_ported(mats, envmap, mesh)
    device = _render_device(u, generator, mats)
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
                                            is None)):
        generator = torch.Generator(device=device).manual_seed(0)
    if jitter and jitter_offsets is None:
        jitter_offsets = (torch.rand((n_rays, 2), generator=generator, **f32)
                          * 2.0 - 1.0) / res
    ro, rd = camera_rays(res, spp, jitter_offsets, device)
    if u is None:
        u = torch.rand((max_bounces, n_rays, 2), generator=generator, **f32)
    if tuple(u.shape) != (max_bounces, n_rays, 2):
        raise ValueError(f"u must be (max_bounces, res*res*spp, 2) = "
                         f"({max_bounces}, {n_rays}, 2), got {tuple(u.shape)}")
    u = u.to(**f32)

    infos = (_fused_info(sphere_mat), _fused_info(floor_mat))
    if all(x is not None for x in infos):
        return _render_soa(infos, light_dir, light_rad, sky_rad, ro, rd, u,
                           res, spp, dedup_ok=not jitter)
    return _render_generic(mats, light_dir, light_rad, sky_rad, ro, rd, u,
                           res, spp)


def _render_generic(mats, light_dir, light_rad, sky_rad, ro, rd, u,
                    res: int, spp: int):
    """The generic loop: both materials evaluated on (N, 3) tensors,
    selected per ray."""
    n_rays = rd.shape[0]
    throughput = torch.ones_like(rd)
    radiance = torch.zeros_like(rd)
    alive = torch.ones(n_rays, dtype=torch.bool, device=rd.device)
    light = torch.broadcast_to(light_dir, rd.shape)
    for u_b in u:
        hit, t, n, is_sphere = _intersect(ro, rd)

        # miss -> sky
        radiance = radiance + torch.where(
            (alive & ~hit)[..., None], throughput * sky_rad, 0.0)
        alive = alive & hit

        pos = ro + t[..., None] * rd
        o_loc = world_to_local(n, -rd)

        # next-event estimation toward the delta light
        i_loc = world_to_local(n, light)
        shadow_o = pos + n * _EPS * 3.0
        lit = ~_occluded(shadow_o, light)

        f = _material_eval(mats, is_sphere, "evalp", i_loc, o_loc)
        w, i_s, pdf = _material_eval(mats, is_sphere, "evalp_is",
                                     u_b[:, 0], u_b[:, 1], o_loc)

        contrib = throughput * light_rad * f
        ok = alive & lit & (i_loc[..., 2] > 0.0) & (o_loc[..., 2] > 0.0)
        radiance = radiance + torch.where(ok[..., None], contrib, 0.0)

        throughput = throughput * torch.where(alive[..., None], w, 1.0)
        alive = alive & (pdf > 0.0) & (i_s[..., 2] > 0.0)
        # detached sampling — see _render_soa
        i_s = i_s.detach()
        rd_new = normalize(local_to_world(n, i_s), eps=1e-12)
        ro_new = pos + n * _EPS * 3.0
        ro = torch.where(alive[..., None], ro_new, ro)
        rd = torch.where(alive[..., None], rd_new, rd)
    # terminate remaining paths into the sky
    hit, _, _, _ = _intersect(ro, rd)
    radiance = radiance + torch.where((alive & ~hit)[..., None],
                                      throughput * sky_rad, 0.0)
    return radiance.reshape(spp, res, res, 3).mean(dim=0)


def _bounce_soa(infos, state, u_b, light_dir, light_rad, sky_rad):
    """One bounce of the SoA loop on the carry ``state`` = (rox, roy,
    roz, rdx, rdy, rdz, th_r, th_g, th_b, ra_r, ra_g, ra_b, alive)."""
    (rox, roy, roz, rdx, rdy, rdz, th_r, th_g, th_b,
     ra_r, ra_g, ra_b, alive) = state
    ldx, ldy, ldz = light_dir[0], light_dir[1], light_dir[2]
    off = _EPS * 3.0
    hit, t, nx, ny, nz, is_sphere, px, py, pz = _intersect_soa(
        rox, roy, roz, rdx, rdy, rdz)

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

    pv = _select_pvec(is_sphere, infos[0].pvec, infos[1].pvec)
    fr, fg, fb, wr, wg, wb, ixl, iyl, izl, pdf = _fused_nee_and_sample(
        infos, pv, is_sphere, (lx, ly, lz), u_b[0], u_b[1], (ox, oy, oz))

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
    return (rox, roy, roz, rdx, rdy, rdz, th_r, th_g, th_b,
            ra_r, ra_g, ra_b, alive)


def _render_soa(infos, light_dir, light_rad, sky_rad, ro, rd, u,
                res: int, spp: int, dedup_ok: bool = True):
    """The fused-material render loop on flat (N,) component arrays:
    path state, intersection, tangent frames and both BSDF ops stay
    SoA end to end. Semantics match the generic loop to f32 rounding;
    the random numbers are laid out as there, so the two paths
    integrate the same sample set.

    The FIRST bounce is spp-deduplicated when a Beckmann side is
    present (its NEE evaluation is the expensive one) and all spp copies
    of a pixel share the camera ray (``dedup_ok``): intersection,
    tangent frame, shadow ray and NEE evaluation run once per pixel
    (P = N/spp lanes) and are tiled; only the BSDF sampler, which
    consumes the per-copy random numbers, runs at full ray count. The
    values are those of the per-ray computation (same ops, same
    inputs)."""
    n_rays = rd.shape[0]
    # (B, N, 2) -> (B, 2, N): contiguous planes for each bounce
    u = u.movedim(-1, 1).contiguous()
    sk_r, sk_g, sk_b = sky_rad[0], sky_rad[1], sky_rad[2]

    def run_bounces(state, u_bounces):
        for u_b in u_bounces:
            state = _bounce_soa(infos, state, u_b, light_dir, light_rad,
                                sky_rad)
        return state

    dedup = (dedup_ok and spp > 1
             and any(info.family == "beck" for info in infos))
    if not dedup:
        ones = torch.ones(n_rays, dtype=torch.float32, device=rd.device)
        zeros = torch.zeros_like(ones)
        state = (ro[..., 0], ro[..., 1], ro[..., 2],
                 rd[..., 0], rd[..., 1], rd[..., 2],
                 ones, ones, ones, zeros, zeros, zeros,
                 torch.ones(n_rays, dtype=torch.bool, device=rd.device))
        return _finish_soa(run_bounces(state, u), sk_r, sk_g, sk_b, res, spp)

    ldx, ldy, ldz = light_dir[0], light_dir[1], light_dir[2]
    lr_r, lr_g, lr_b = light_rad[0], light_rad[1], light_rad[2]
    off = _EPS * 3.0
    P = n_rays // spp

    def tile(a):
        return a.repeat(spp)

    rox_p, roy_p, roz_p = ro[:P, 0], ro[:P, 1], ro[:P, 2]
    rdx_p, rdy_p, rdz_p = rd[:P, 0], rd[:P, 1], rd[:P, 2]
    hit_p, t_p, nx_p, ny_p, nz_p, is_sph_p, px_p, py_p, pz_p = \
        _intersect_soa(rox_p, roy_p, roz_p, rdx_p, rdy_p, rdz_p)
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
    pv_p = _select_pvec(is_sph_p, infos[0].pvec, infos[1].pvec)
    fr_p, fg_p, fb_p = _fused_nee_eval(infos, pv_p, is_sph_p,
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
    # per-pixel pvec tiled with the other per-pixel values)
    alive1 = tile(hit_p)
    is_sph1 = tile(is_sph_p)
    o1 = (tile(ox_p), tile(oy_p), tile(oz_p))
    pv1t = pv_p.repeat(1, spp)
    wr1, wg1, wb1, ix1, iy1, iz1, pdf1 = _fused_sample(
        infos, pv1t, is_sph1, u[0][0], u[0][1], o1)
    th_r = torch.where(alive1, wr1, 1.0)
    th_g = torch.where(alive1, wg1, 1.0)
    th_b = torch.where(alive1, wb1, 1.0)
    alive1 = alive1 & (pdf1 > 0.0) & (iz1 > 0.0)
    # detached sampling — see the bounce body
    ix1, iy1, iz1 = ix1.detach(), iy1.detach(), iz1.detach()
    wx = ix1 * tile(tx_p) + iy1 * tile(bx_p) + iz1 * tile(nx_p)
    wy = ix1 * tile(ty_p) + iy1 * tile(by_p) + iz1 * tile(ny_p)
    wz = ix1 * tile(tz_p) + iy1 * tile(bz_p) + iz1 * tile(nz_p)
    inrm1 = torch.rsqrt(torch.clamp(wx * wx + wy * wy + wz * wz, min=1e-12))
    state = (torch.where(alive1, tile(sox_p), tile(rox_p)),
             torch.where(alive1, tile(soy_p), tile(roy_p)),
             torch.where(alive1, tile(soz_p), tile(roz_p)),
             torch.where(alive1, wx * inrm1, tile(rdx_p)),
             torch.where(alive1, wy * inrm1, tile(rdy_p)),
             torch.where(alive1, wz * inrm1, tile(rdz_p)),
             th_r, th_g, th_b,
             tile(ra1_r), tile(ra1_g), tile(ra1_b),
             alive1)
    return _finish_soa(run_bounces(state, u[1:]), sk_r, sk_g, sk_b, res, spp)


def _finish_soa(state, sk_r, sk_g, sk_b, res: int, spp: int):
    """Terminate remaining live paths into the sky and assemble the
    image from the SoA carry."""
    (rox, roy, roz, rdx, rdy, rdz, th_r, th_g, th_b,
     ra_r, ra_g, ra_b, alive) = state
    hit = _intersect_soa(rox, roy, roz, rdx, rdy, rdz)[0]
    miss = alive & ~hit
    ra_r = ra_r + torch.where(miss, th_r * sk_r, 0.0)
    ra_g = ra_g + torch.where(miss, th_g * sk_g, 0.0)
    ra_b = ra_b + torch.where(miss, th_b * sk_b, 0.0)

    radiance = torch.stack([ra_r, ra_g, ra_b], -1)
    return radiance.reshape(spp, res, res, 3).mean(dim=0)
