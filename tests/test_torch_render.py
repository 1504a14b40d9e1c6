"""Port parity, rendering: the fused SoA samplers (ops/soa.py's render
half), render/sphere and the ``entry()`` forward, the renderer
materials, and the delta-light path tracer, against the JAX package on
the same inputs. The path tracer takes JAX's own uniforms (``u``), so
both packages integrate the same sample set.

Tolerances: f32 throughout. A path-traced pixel sums up to three
bounces of ~300-op chains; a lane whose alive mask flips between the
two packages (a grazing hit or a horizon test an ulp from its edge)
changes its pixel by one sample's contribution. At the tested sizes no
pixel flipped, and at most 1 pixel in 256 may (``MAX_FLIPS``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dj_brdf_tpu import fresnel as jfres
from dj_brdf_tpu.io import synth as jsynth
from dj_brdf_tpu.microfacet import brdf as jbrdf
from dj_brdf_tpu.microfacet import ndf as jndf
from dj_brdf_tpu.microfacet.params import MicrofacetParams as JParams
from dj_brdf_tpu.models.lambert import Lambert as JLambert
from dj_brdf_tpu.ops import soa as jsoa
from dj_brdf_tpu.render import materials as jmat
from dj_brdf_tpu.render import pathtrace as jpt
from dj_brdf_tpu.render import sphere as jsphere
from dj_brdf_torch import convert
from dj_brdf_torch import fresnel as tfres
from dj_brdf_torch.entry import entry as t_entry
from dj_brdf_torch.microfacet import brdf as tbrdf
from dj_brdf_torch.microfacet import ndf as tndf
from dj_brdf_torch.microfacet.params import MicrofacetParams as TParams
from dj_brdf_torch.models.lambert import Lambert as TLambert
from dj_brdf_torch.ops import soa as tsoa
from dj_brdf_torch.render import materials as tmat
from dj_brdf_torch.render import pathtrace as tpt
from dj_brdf_torch.render import sphere as tsphere

LIGHT = [0.3, 0.4, 0.8]
LIGHT_RAD = [4.0, 4.0, 4.0]
SKY = [0.3, 0.35, 0.4]
MAX_FLIPS = 1 / 256
PV = [0.35, 0.18, 0.25, 0.06, -0.04, 0.9, 0.6, 0.3]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def t(x):
    return torch.tensor(np.array(x))


def close(got, want, rtol=1e-4, atol_rel=1e-5, what=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def image_close(got, want, rtol=1e-4, atol=1e-4):
    """Pixelwise, allowing MAX_FLIPS of the pixels to differ (see the
    module docstring)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    flips = bad.any(-1).sum()
    assert flips <= MAX_FLIPS * bad[..., 0].size, \
        (flips, float(np.abs(got - want).max()))


# ---------------------------------------------------------------- soa

def check_sampled(got, want):
    """(wr, wg, wb, ix, iy, iz, pdf): the O(1) weights and directions
    within 1e-4 absolute (GGX's closed-form qf2 multiplies tan and cot
    terms that are ill conditioned near its branch switch: single lanes
    move by up to 6e-5 between the packages), the pdf at rtol 1e-4."""
    assert len(got) == len(want) == 7
    for k, (g, w) in enumerate(zip(got[:6], want[:6])):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=str(k))
    close(got[6], want[6], rtol=1e-4, atol_rel=1e-5, what="pdf")


def gated_lanes(n, seed):
    """Receivers, lights and uniforms with gated lanes mixed in: o below
    the horizon, o grazing, o below the mean-normal horizon, and exact
    normal incidence. The random directions keep 0.01 rad from the
    pole: closer, f32 quantises the warped receiver's polar angle (one
    ulp of cos theta near 1 moves theta by ~3e-4 rad), and the two
    packages' rsqrt roundings then draw visibly different samples
    (measured: lanes at theta ~ 1e-3 moved by 0.3)."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0.01, 1.55, (2, n))
    ph = rng.uniform(0, 2 * np.pi, (2, n))
    o = np.stack([np.sin(th[0]) * np.cos(ph[0]),
                  np.sin(th[0]) * np.sin(ph[0]), np.cos(th[0])])
    light = np.stack([np.sin(th[1]) * np.cos(ph[1]),
                      np.sin(th[1]) * np.sin(ph[1]), np.cos(th[1])])
    o[2, 0::17] *= -1.0                           # below the horizon
    o[:, 1::17] = [[0.9999], [0.0], [0.0141]]      # grazing
    o[:, 2::17] = [[-0.3], [0.5], [0.02]]          # below the mean normal
    o[:, 3::17] = [[0.0], [0.0], [1.0]]            # normal incidence
    u = rng.uniform(0, 1, (2, n))
    return ([c.astype(np.float32) for c in o],
            [c.astype(np.float32) for c in light],
            [c.astype(np.float32) for c in u])


def pvecs(n, per_lane, seed=3):
    if not per_lane:
        return np.asarray(PV, np.float32)
    rng = np.random.default_rng(seed)
    lo = np.asarray([0.1, 0.1, -0.3, -0.1, -0.1, 0.05, 0.05, 0.05])
    hi = np.asarray([0.7, 0.7, 0.3, 0.1, 0.1, 0.95, 0.95, 0.95])
    return (lo[:, None] + (hi - lo)[:, None]
            * rng.uniform(size=(8, n))).astype(np.float32)


def fres_pair():
    """A per-lane Fresnel override (a conductor) for fresnel_fn."""
    eta, k = [0.143, 0.375, 1.442], [3.983, 2.386, 1.603]

    def jf(c):
        f = jfres.conductor_fresnel(c, jnp.asarray(eta), jnp.asarray(k))
        return f[..., 0], f[..., 1], f[..., 2]

    def tf(c):
        f = tfres.conductor_fresnel(c, torch.tensor(eta), torch.tensor(k))
        return f[..., 0], f[..., 1], f[..., 2]
    return jf, tf


@pytest.mark.parametrize("kind", ["ggx_caps", "ggx_qf", "beck"])
@pytest.mark.parametrize("per_lane", [False, True])
def test_evalp_is_soa_matches_jax(kind, per_lane):
    n = 1024
    o, _, u = gated_lanes(n, 1)
    pv = pvecs(n, per_lane)
    if kind == "beck":
        want = jsoa.beckmann_evalp_is_soa(jnp.asarray(pv), *u, *o)
        got = tsoa.beckmann_evalp_is_soa(t(pv), *map(t, u), *map(t, o))
    else:
        caps = kind == "ggx_caps"
        want = jsoa.ggx_evalp_is_soa(jnp.asarray(pv), *u, *o, caps=caps)
        got = tsoa.ggx_evalp_is_soa(t(pv), *map(t, u), *map(t, o),
                                    caps=caps)
    check_sampled(got, want)
    assert float((got[-1] > 0).float().mean()) > 0.5


@pytest.mark.parametrize("caps", [False, True])
@pytest.mark.parametrize("with_nee", [True, False])
@pytest.mark.parametrize("fresnel", [False, True])
def test_mixed_nee_evalp_is_soa_matches_jax(caps, with_nee, fresnel):
    n = 1024
    o, light, u = gated_lanes(n, 2)
    pv = pvecs(n, True)
    is_beck = np.arange(n) % 3 == 0
    jf, tf = fres_pair() if fresnel else (None, None)
    want = jsoa.mixed_nee_evalp_is_soa(
        jnp.asarray(pv), jnp.asarray(is_beck), *light, *u, *o, caps=caps,
        with_nee=with_nee, fresnel_fn=jf)
    got = tsoa.mixed_nee_evalp_is_soa(
        t(pv), torch.from_numpy(is_beck), *map(t, light), *map(t, u),
        *map(t, o), caps=caps, with_nee=with_nee, fresnel_fn=tf)
    assert len(got) == len(want) == (10 if with_nee else 7)
    for k, (g, w) in enumerate(zip(got[:-7], want[:-7])):
        close(g, w, rtol=2e-5, atol_rel=1e-6, what=f"nee {k}")
    check_sampled(got[-7:], want[-7:])


@pytest.mark.parametrize("family", ["ggx", "beck"])
def test_evalp_soa_with_pdf_and_fresnel_fn_match_jax(family):
    n = 1024
    o, light, _ = gated_lanes(n, 4)
    pv = pvecs(n, True)
    jf, tf = fres_pair()
    name = {"ggx": "ggx_evalp_soa", "beck": "beckmann_evalp_soa"}[family]
    for kw_j, kw_t in (({"with_pdf": True}, {"with_pdf": True}),
                       ({"fresnel_fn": jf}, {"fresnel_fn": tf})):
        want = getattr(jsoa, name)(jnp.asarray(pv), *light, *o, **kw_j)
        got = getattr(tsoa, name)(t(pv), *map(t, light), *map(t, o), **kw_t)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, rtol=2e-5, atol_rel=1e-6)


# ---------------------------------------------------- sphere and entry

def test_render_sphere_matches_jax():
    params = dict(a1=0.3, a2=0.1, phi=0.5)
    jp = JParams.elliptic(params["a1"], params["a2"], params["phi"])
    tp = TParams.elliptic(params["a1"], params["a2"], params["phi"])
    f0 = [0.95, 0.64, 0.54]
    want = jsphere.render_sphere(
        lambda i, o: jbrdf.evalp(jndf.GGX(), jfres.Schlick(
            f0=jnp.asarray(f0)), jp, i, o), LIGHT, res=32,
        light_radiance=(2.0, 1.0, 0.5), view_dir=(0.1, -0.2, 1.0))
    got = tsphere.render_sphere(
        lambda i, o: tbrdf.evalp(tndf.GGX(), tfres.Schlick(
            f0=torch.tensor(f0)), tp, i, o), LIGHT, res=32,
        light_radiance=(2.0, 1.0, 0.5), view_dir=(0.1, -0.2, 1.0))
    assert got.shape == (32, 32, 3)
    close(got, want, rtol=1e-5, atol_rel=1e-6)
    u, v = tsphere.sphere_uv(tsphere.sphere_normals(32)[0])
    ju, jv = jsphere.sphere_uv(jsphere.sphere_normals(32)[0])
    close(u, ju, atol_rel=1e-6)
    close(v, jv, atol_rel=1e-6)


def test_sample_texture_matches_jax():
    """Nearest-texel lookups at the sphere's UVs (edges included) pick
    the same texels in both packages, and the gradient w.r.t. the texels
    (a hit count per texel) agrees exactly."""
    rng = np.random.default_rng(5)
    tex = rng.uniform(0, 1, (8, 16, 3)).astype(np.float32)
    u, v = jsphere.sphere_uv(jsphere.sphere_normals(32)[0])
    u = np.concatenate([np.asarray(u).ravel(), [0.0, 1.0, 0.9999]])
    v = np.concatenate([np.asarray(v).ravel(), [1.0, 0.0, 0.5]])
    want = jsphere.sample_texture(jnp.asarray(tex), jnp.asarray(u),
                                  jnp.asarray(v))
    tt = torch.tensor(tex, requires_grad=True)
    got = tsphere.sample_texture(tt, t(u).float(), t(v).float())
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    jg = jax.grad(lambda x: jsphere.sample_texture(
        x, jnp.asarray(u), jnp.asarray(v)).sum())(jnp.asarray(tex))
    got.sum().backward()
    np.testing.assert_array_equal(tt.grad.numpy(), np.asarray(jg))


def test_entry_forward_and_gradient_match_jax():
    """The flagship forward at its res 256, and the gradient of the
    image mean w.r.t. f0 and the light direction."""
    import __graft_entry__ as graft

    jfwd, jargs = graft.entry()
    tfwd, targs = t_entry()
    want = jfwd(*jargs)
    got = tfwd(*targs)
    assert got.shape == (256, 256, 3)
    # visible pixels at rtol 1e-5; the rest are exactly 0 in both
    close(got, want, rtol=1e-5, atol_rel=1e-6)
    jg = jax.grad(lambda f0, l: jfwd(jargs[0], f0, l).mean(),
                  argnums=(0, 1))(jargs[1], jargs[2])
    f0 = targs[1].clone().requires_grad_(True)
    light = targs[2].clone().requires_grad_(True)
    tfwd(targs[0], f0, light).mean().backward()
    close(f0.grad, jg[0], rtol=1e-4)
    close(light.grad, jg[1], rtol=1e-4)


# ------------------------------------------------------------ materials

def jax_materials():
    ggx_f = jfres.Schlick(f0=jnp.asarray([0.9, 0.6, 0.3]))
    p = JParams.pdfparams(0.35, 0.18, 0.25, 0.06, -0.04)
    lam = JLambert(reflectance=jnp.asarray([0.4, 0.5, 0.6]))
    tab = jndf.Tabular(**{k: jnp.asarray(v) for k, v in
                          _tabular_tables().items()})
    return {
        "microfacet_ggx": jmat.MicrofacetMaterial(jndf.GGX(), ggx_f, p),
        "microfacet_caps": jmat.MicrofacetMaterial(
            jndf.GGXSphericalCaps(), ggx_f, p),
        "microfacet_beck": jmat.MicrofacetMaterial(jndf.Beckmann(), ggx_f,
                                                   p),
        "microfacet_tabular": jmat.MicrofacetMaterial(tab, ggx_f,
                                                      JParams.isotropic(0.4)),
        "measured": jmat.MeasuredMaterial(model=lam,
                                          proxy_params=JParams.isotropic(0.6),
                                          proxy_dist=jndf.GGX()),
        "cosine": jmat.CosineMaterial(model=lam),
        "conductor": jmat.ConductorWrap(
            inner=jmat.MicrofacetMaterial(jndf.GGX(), ggx_f, p),
            eta=jnp.asarray([0.143, 0.375, 1.442]),
            k=jnp.asarray([3.983, 2.386, 1.603])),
    }


def _tabular_tables(res=64):
    u = np.linspace(0, 1, res, dtype=np.float32)
    return dict(p22=(np.exp(-4 * u * u) / np.pi).astype(np.float32),
                sigma=(1.0 - 0.3 * u).astype(np.float32),
                cdf=u.copy(), qf=(0.98 * u ** 1.5).astype(np.float32))


@pytest.mark.parametrize("name", sorted(jax_materials()))
def test_material_evalp_is_matches_jax(name):
    jm = jax_materials()[name]
    tm = convert.material_from_jax(jm)
    assert type(tm).__name__ == type(jm).__name__
    n = 1024
    o, light, u = gated_lanes(n, 6)
    o3, l3 = np.stack(o, -1), np.stack(light, -1)
    w_j, i_j, p_j = (np.asarray(x) for x in jm.evalp_is(*u, o3))
    w_t, i_t, p_t = tm.evalp_is(*map(t, u), t(o3))
    close(i_t, i_j, atol_rel=1e-4)
    close(p_t, p_j, rtol=1e-4, atol_rel=1e-6)
    close(w_t, w_j, rtol=1e-4, atol_rel=1e-4)
    close(tm.evalp(t(l3), t(o3)), jm.evalp(l3, o3), rtol=2e-5,
          atol_rel=1e-6)
    close(tm.pdf(t(l3), t(o3)), jm.pdf(l3, o3), rtol=1e-4, atol_rel=1e-6)


def test_eval_hd_matches_jax():
    jm = jax_materials()["microfacet_ggx"]
    tm = convert.material_from_jax(jm)
    rng = np.random.default_rng(8)
    h = np.stack([np.zeros(64), np.zeros(64), np.ones(64)], -1)
    th = rng.uniform(0.05, 1.4, 64)
    h = np.stack([np.sin(th) * 0.3, np.sin(th) * 0.2,
                  np.sqrt(1 - np.sin(th) ** 2 * 0.13)], -1)
    d = np.stack([np.sin(th), np.zeros(64), np.cos(th)], -1)
    h, d = h.astype(np.float32), d.astype(np.float32)
    close(tmat.eval_hd(tm, t(h), t(d)), jmat.eval_hd(jm, h, d), rtol=1e-4)


def test_measured_material_from_model_matches_jax():
    """The dj_sgd/dj_abc pattern: the GGX proxy fitted to a model's
    tabulation (here a GGX eval at res 16), then evalp_is."""
    from dj_brdf_torch.fit.tabular import microfacet_eval_fn

    f0 = [0.9, 0.6, 0.3]
    jm = jmat.MeasuredMaterial.from_model(
        lambda i, o: jbrdf.eval(jndf.GGX(), jfres.Schlick(
            f0=jnp.asarray(f0)), JParams.isotropic(0.3), i, o), res=16)
    tm = tmat.MeasuredMaterial.from_model(microfacet_eval_fn(
        tndf.GGX(), tfres.Schlick(f0=torch.tensor(f0)),
        TParams.isotropic(0.3)), res=16)
    np.testing.assert_allclose(float(tm.proxy_params.ax),
                               float(jm.proxy_params.ax), rtol=1e-4)
    o, _, u = gated_lanes(256, 9)
    o3 = np.stack(o, -1)
    jm = jmat.MeasuredMaterial(model=JLambert(jnp.asarray(f0)),
                               proxy_params=jm.proxy_params,
                               proxy_dist=jm.proxy_dist)
    tm = dataclasses.replace(tm, model=TLambert(torch.tensor(f0)))
    w_j, i_j, p_j = jm.evalp_is(*u, o3)
    w_t, i_t, p_t = tm.evalp_is(*map(t, u), t(o3))
    close(i_t, i_j, atol_rel=1e-4)
    close(p_t, p_j, rtol=1e-4, atol_rel=1e-6)
    close(w_t, w_j, rtol=1e-4, atol_rel=1e-4)


# ---------------------------------------------------------- path tracer

def scene(floor):
    """bench.py's GGX+Schlick sphere over a Beckmann or GGX floor, or
    over a cosine-sampled Lambert floor (the generic loop)."""
    sphere = jmat.MicrofacetMaterial(
        jndf.GGX(), jfres.Schlick(f0=jnp.asarray([0.9, 0.6, 0.3])),
        JParams.elliptic(0.3, 0.15, 0.7))
    if floor == "cosine":
        fl = jmat.CosineMaterial(
            model=JLambert(reflectance=jnp.asarray([0.4, 0.4, 0.4])))
    else:
        fl = jmat.MicrofacetMaterial(
            jndf.Beckmann() if floor == "beck" else jndf.GGX(),
            jfres.Schlick(f0=jnp.asarray([0.3, 0.3, 0.3])),
            JParams.isotropic(0.5))
    return sphere, fl


def jax_u(max_bounces, n_rays):
    """The uniforms JAX's render draws from its default key."""
    return np.array(jax.random.uniform(jax.random.PRNGKey(0),
                                       (max_bounces, n_rays, 2)))


def render_both(js, jf, res, spp, nb, **kw):
    want = np.asarray(jpt.render(js, jf, jnp.asarray(LIGHT),
                                 jnp.asarray(LIGHT_RAD), jnp.asarray(SKY),
                                 res=res, spp=spp, max_bounces=nb, **kw))
    extra = {}
    if kw.get("jitter"):
        key = jax.random.fold_in(jax.random.PRNGKey(0), 0x5e75)
        extra["jitter_offsets"] = t(jax.random.uniform(
            key, (res * res * spp, 2), minval=-1.0 / res, maxval=1.0 / res))
    got = tpt.render(convert.material_from_jax(js),
                     convert.material_from_jax(jf), LIGHT, LIGHT_RAD, SKY,
                     res=res, spp=spp, max_bounces=nb,
                     u=t(jax_u(nb, res * res * spp)), **kw, **extra)
    return got, want


@pytest.mark.parametrize("floor,jitter", [("beck", False), ("ggx", False),
                                          ("ggx", True), ("cosine", False)])
def test_pathtrace_matches_jax(floor, jitter):
    """The SoA loop with the dual-family pass and the dedup first bounce
    (Beckmann floor), the single-family SoA loop (GGX floor), jittered
    camera rays, and the generic loop (cosine-sampled floor)."""
    js, jf = scene(floor)
    got, want = render_both(js, jf, 16, 4, 3, jitter=jitter)
    assert got.shape == (16, 16, 3)
    image_close(got, want)
    # a top-corner pixel sees only the sky
    np.testing.assert_allclose(got[0, 0].numpy(), SKY, rtol=1e-6)


def test_pathtrace_dedup_agrees_with_the_per_ray_loop(monkeypatch):
    """The spp-deduplicated first bounce is an identity: the same image
    as running bounce 1 through the ordinary loop body."""
    js, jf = scene("beck")
    ts, tf = convert.material_from_jax(js), convert.material_from_jax(jf)
    u = t(jax_u(2, 16 * 16 * 4))
    kw = dict(res=16, spp=4, max_bounces=2, u=u)
    deduped = tpt.render(ts, tf, LIGHT, LIGHT_RAD, SKY, **kw)
    per_ray = tpt.render(ts, tf, LIGHT, LIGHT_RAD, SKY, jitter=True,
                         jitter_offsets=torch.zeros(16 * 16 * 4, 2), **kw)
    np.testing.assert_allclose(deduped.numpy(), per_ray.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_pathtrace_fused_loop_matches_generic_loop(monkeypatch):
    js, jf = scene("beck")
    ts, tf = convert.material_from_jax(js), convert.material_from_jax(jf)
    kw = dict(res=16, spp=2, max_bounces=2, u=t(jax_u(2, 16 * 16 * 2)))
    fused = tpt.render(ts, tf, LIGHT, LIGHT_RAD, SKY, **kw)
    monkeypatch.setattr(tpt, "_fused_info", lambda m: None)
    generic = tpt.render(ts, tf, LIGHT, LIGHT_RAD, SKY, **kw)
    image_close(generic, fused, rtol=2e-3, atol=2e-4)


def test_pathtrace_measured_material_from_merl_matches_jax():
    """The generic loop with MeasuredMaterial.from_merl on a MERL table
    baked by bake_merl (a GGX sphere's table), proxy fitted at res 32."""
    def ggx(i, o):
        return jbrdf.eval(jndf.GGX(), jfres.Schlick(
            f0=jnp.asarray([0.9, 0.6, 0.3])), JParams.isotropic(0.25), i, o)

    table = np.asarray(jsynth.bake_merl(ggx), np.float32)
    jm = jmat.MeasuredMaterial.from_merl(jnp.asarray(table), res=32)
    tm = tmat.MeasuredMaterial.from_merl(torch.from_numpy(table), res=32)
    np.testing.assert_allclose(float(tm.proxy_params.ax),
                               float(jm.proxy_params.ax), rtol=1e-4)
    _, jf = scene("ggx")
    res, spp, nb = 12, 2, 2
    want = np.asarray(jpt.render(jm, jf, jnp.asarray(LIGHT),
                                 jnp.asarray(LIGHT_RAD), jnp.asarray(SKY),
                                 res=res, spp=spp, max_bounces=nb))
    got = tpt.render(tm, convert.material_from_jax(jf), LIGHT, LIGHT_RAD,
                     SKY, res=res, spp=spp, max_bounces=nb,
                     u=t(jax_u(nb, res * res * spp)))
    image_close(got, want, rtol=1e-4, atol=1e-4)


def test_pathtrace_gradient_matches_jax():
    """d mean(image) / d (sphere f0, sphere alpha) at res 8 on the mixed
    scene (dual-family pass, dedup, the Halley root's backward)."""
    res, spp, nb = 8, 2, 2

    def jimg(f0, a):
        sphere = jmat.MicrofacetMaterial(jndf.GGX(), jfres.Schlick(f0=f0),
                                         JParams.elliptic(a, 0.15, 0.7))
        _, fl = scene("beck")
        return jpt.render(sphere, fl, jnp.asarray(LIGHT),
                          jnp.asarray(LIGHT_RAD), jnp.asarray(SKY), res=res,
                          spp=spp, max_bounces=nb).mean()

    f0 = np.asarray([0.9, 0.6, 0.3], np.float32)
    jg_f0, jg_a = jax.grad(jimg, argnums=(0, 1))(jnp.asarray(f0),
                                                 jnp.float32(0.3))
    tf0 = torch.tensor(f0, requires_grad=True)
    ta = torch.tensor(0.3, requires_grad=True)
    sphere = tmat.MicrofacetMaterial(tndf.GGX(), tfres.Schlick(f0=tf0),
                                     TParams.elliptic(ta, 0.15, 0.7))
    fl = convert.material_from_jax(scene("beck")[1])
    img = tpt.render(sphere, fl, LIGHT, LIGHT_RAD, SKY, res=res, spp=spp,
                     max_bounces=nb, u=t(jax_u(nb, res * res * spp)))
    img.mean().backward()
    assert torch.isfinite(tf0.grad).all() and tf0.grad.abs().max() > 0
    close(tf0.grad, jg_f0, rtol=1e-3, atol_rel=1e-4)
    close(ta.grad, jg_a, rtol=1e-3, atol_rel=1e-4)


def test_pathtrace_default_generator_and_shapes():
    ts, tf = (convert.material_from_jax(m) for m in scene("ggx"))
    a = tpt.render(ts, tf, LIGHT, LIGHT_RAD, SKY, res=8, spp=2,
                   max_bounces=2)
    b = tpt.render(ts, tf, LIGHT, LIGHT_RAD, SKY, res=8, spp=2,
                   max_bounces=2,
                   generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and torch.isfinite(a).all()
    with pytest.raises(ValueError, match="u must be"):
        tpt.render(ts, tf, LIGHT, LIGHT_RAD, SKY, res=8, spp=2,
                   max_bounces=2, u=torch.rand(1, 128, 2))


def test_unported_render_arguments_raise():
    ts, tf = (convert.material_from_jax(m) for m in scene("ggx"))
    args = (LIGHT, LIGHT_RAD, SKY)
    with pytest.raises(NotImplementedError, match="environment-map"):
        tpt.render(ts, tf, *args, res=4, spp=1, envmap=object())
    with pytest.raises(NotImplementedError, match="slice 4"):
        tpt.render(ts, tf, *args, res=4, spp=1, mesh=object())
    textured = dataclasses.replace(ts, params=TParams.elliptic(
        torch.full((4, 4), 0.3), torch.full((4, 4), 0.2), 0.0))
    with pytest.raises(NotImplementedError, match="textured"):
        tpt.render(textured, tf, *args, res=4, spp=1)

    @dataclasses.dataclass(frozen=True)
    class FilteredBeckmannMaterial:
        lean: object = None
    with pytest.raises(NotImplementedError, match="LEAN"):
        tpt.render(ts, FilteredBeckmannMaterial(), *args, res=4, spp=1)
    with pytest.raises(TypeError, match="no counterpart"):
        convert.material_from_jax(jmat.TexturedMicrofacetMaterial(
            jndf.GGX(), jfres.Schlick(f0=jnp.ones(3)), jnp.ones((2, 2)),
            jnp.ones((2, 2)), jnp.zeros(())))
