"""Port parity, textured materials: per-hit texture fetches in the path
tracer's fused loops (``TexturedMicrofacetMaterial``, LEAN-mapped
``FilteredBeckmannMaterial`` with and without ray-cone mip selection,
exact conductor Fresnel per lane) and in its generic loops
(``UVMappedMaterial`` over a tabular distribution), under the delta
light and under an environment map, with gradients w.r.t. the alpha
map, the LEAN moments and the envmap radiance, against the JAX package
on the same uniforms.

Tolerances: ``test_torch_render.py``'s image tolerances (rtol and atol
1e-4 per pixel, at most 1 pixel in 256 flipped by a branch an ulp from
its edge); gradients at rtol 1e-3 with an absolute floor of 1e-4 of the
largest entry, as the material gradients there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dj_brdf_tpu import fresnel as jfres
from dj_brdf_tpu.fit import tabular as jtabular
from dj_brdf_tpu.lean.filtered import FilteredBeckmannMaterial as JFiltered
from dj_brdf_tpu.lean.lrep import Lrep as JLrep
from dj_brdf_tpu.microfacet import brdf as jbrdf
from dj_brdf_tpu.microfacet import ndf as jndf
from dj_brdf_tpu.microfacet.params import MicrofacetParams as JParams
from dj_brdf_tpu.models.lambert import Lambert as JLambert
from dj_brdf_tpu.render import envmap as jenv
from dj_brdf_tpu.render import materials as jmat
from dj_brdf_tpu.render import pathtrace as jpt
from dj_brdf_torch import convert
from dj_brdf_torch.lean.filtered import FilteredBeckmannMaterial
from dj_brdf_torch.lean.lrep import Lrep
from dj_brdf_torch.render import envmap as tenv
from dj_brdf_torch.render import materials as tmat
from dj_brdf_torch.render import pathtrace as tpt

LIGHT = [0.3, 0.4, 0.8]
LIGHT_RAD = [3.0, 3.0, 3.0]
SKY = [0.2, 0.25, 0.3]
MAX_FLIPS = 1 / 256
ETA = [0.143, 0.375, 1.442]
K = [3.983, 2.386, 1.603]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def t(x):
    return torch.tensor(np.array(x))


def image_close(got, want, rtol=1e-4, atol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    flips = bad.any(-1).sum()
    assert flips <= MAX_FLIPS * bad[..., 0].size, \
        (flips, float(np.abs(got - want).max()))


def f32(x):
    return jnp.asarray(x, jnp.float32)


def alpha_map(shape=(8, 8), seed=5):
    return np.random.default_rng(seed).uniform(0.05, 0.6, shape).astype(
        np.float32)


def lean_maps(shape=(16, 16), seed=6):
    rng = np.random.default_rng(seed)
    e1, e2 = rng.normal(0, 0.15, (2,) + shape).astype(np.float32)
    return (e1, e2, e1 * e1 + 0.02, e2 * e2 + 0.02, e1 * e2)


def textured_sphere(amap, dist=None):
    return jmat.TexturedMicrofacetMaterial(
        dist=dist or jndf.GGX(), fres=jfres.Schlick(f0=f32([0.9, 0.6, 0.3])),
        alpha1=f32(amap), alpha2=f32(amap), alpha_angle=f32(0.3))


def lean_floor(m, mip_lod=False):
    return JFiltered(lean=JLrep(*map(f32, m)),
                     base_params=JParams.isotropic(f32(0.1)),
                     eta=f32(ETA), k=f32(K), mip_lod=mip_lod)


def beck_floor():
    return jmat.MicrofacetMaterial(
        jndf.Beckmann(), jfres.Schlick(f0=f32([0.3, 0.3, 0.3])),
        JParams.isotropic(f32(0.5)))


def cosine_floor():
    return jmat.CosineMaterial(model=JLambert(reflectance=f32([0.4] * 3)))


def sun_sky(h=8, w=16):
    rng = np.random.default_rng(1)
    img = np.abs(rng.normal(1.0, 0.4, (h, w, 3))).astype(np.float32)
    img[2:3, 5:7] *= 40.0
    return img


def envmaps(img):
    return (jenv.EnvMap.build(jnp.asarray(img)),
            tenv.EnvMap.build(img, device="cpu"))


def jax_uniforms(nb, n_rays):
    key = jax.random.PRNGKey(0)
    return (t(jax.random.uniform(key, (nb, n_rays, 2))),
            t(jax.random.uniform(jax.random.fold_in(key, 0xE57),
                                 (nb, n_rays, 3))))


def render_pair(js, jf, env=None, res=16, spp=4, nb=3):
    lights = (LIGHT_RAD, SKY) if env is None else ([0, 0, 0], [0, 0, 0])
    jem, tem = (None, None) if env is None else envmaps(env)
    want = np.asarray(jpt.render(js, jf, f32(LIGHT), f32(lights[0]),
                                 f32(lights[1]), res=res, spp=spp,
                                 max_bounces=nb, envmap=jem))
    u, u_env = jax_uniforms(nb, res * res * spp)
    got = tpt.render(convert.material_from_jax(js),
                     convert.material_from_jax(jf), LIGHT, *lights, res=res,
                     spp=spp, max_bounces=nb, u=u,
                     u_env=None if env is None else u_env, envmap=tem)
    return got, want


@pytest.mark.parametrize("mip_lod", [False, True])
@pytest.mark.parametrize("light", ["delta", "envmap"])
def test_textured_sphere_over_lean_floor_matches_jax(mip_lod, light):
    """The matpreview composition: an alpha-textured GGX sphere over a
    LEAN-mapped Beckmann conductor (one combined row read per bounce,
    neutral rows on the other material's lanes, conductor Fresnel on
    the floor lanes), ray-cone LOD on or off; the delta light takes the
    deduplicated first bounce, the envmap the SoA MIS loop."""
    js = textured_sphere(alpha_map())
    jf = lean_floor(lean_maps(), mip_lod)
    got, want = render_pair(js, jf, None if light == "delta" else sun_sky())
    assert float(got.mean()) > 0.02
    image_close(got, want)


@pytest.mark.parametrize("case", ["textured_beck_floor", "uniform_lean",
                                  "textured_beckmann_sphere"])
def test_single_textured_material_matches_jax(case):
    """One textured material (its own row read) beside a uniform one;
    a uniform LEAN conductor (conductor Fresnel beside Schlick lanes);
    a textured Beckmann sphere (same family as the floor)."""
    if case == "textured_beck_floor":
        js, jf = textured_sphere(alpha_map((9, 13))), beck_floor()
    elif case == "uniform_lean":
        js = textured_sphere(np.float32(0.3))
        jf = lean_floor([np.float32(x) for x in (0.2, 0.1, 0.06, 0.04,
                                                 0.04)])
    else:
        js = textured_sphere(alpha_map(), jndf.Beckmann())
        jf = beck_floor()
    got, want = render_pair(js, jf)
    image_close(got, want)


def tabular_pair():
    def eval_fn(i, o):
        return jbrdf.eval(jndf.GGX(), jfres.Schlick(f0=f32([0.9, 0.6, 0.3])),
                          JParams.isotropic(0.3), i, o)

    tab, tab_fres = jtabular.build_tabular(eval_fn, 16)
    amap = np.random.default_rng(11).uniform(0.6, 1.4, (5, 7))
    return jmat.UVMappedMaterial(dist=tab, fres=tab_fres, alpha1=f32(amap),
                                 alpha2=f32(amap), alpha_angle=f32(0.0))


@pytest.mark.parametrize("light", ["delta", "envmap"])
def test_uv_mapped_tabular_matches_jax(light):
    """UVMappedMaterial over a Tabular NDF through the generic loops:
    textures fetched at the hit's uv (at_uv), any distribution."""
    got, want = render_pair(tabular_pair(), cosine_floor(),
                            None if light == "delta" else sun_sky(),
                            res=12, spp=2, nb=2)
    assert float(got.mean()) > 0.02
    image_close(got, want)


def test_gradients_match_jax():
    """d mean(image) / d (alpha map, LEAN E1 map, envmap radiance) at res
    8 under the envmap (SoA MIS loop, combined read, mip LOD)."""
    amap, lm, img = alpha_map(), lean_maps((8, 8)), sun_sky()
    jem, tem = envmaps(img)
    res, spp, nb = 8, 2, 2

    def jloss(a, e1, rad):
        sphere = textured_sphere(a)
        floor = lean_floor((e1,) + lm[1:], mip_lod=True)
        return jpt.render(sphere, floor, f32(LIGHT), jnp.zeros(3),
                          jnp.zeros(3), res=res, spp=spp, max_bounces=nb,
                          envmap=jem.rebind(rad)).mean()

    want = jax.grad(jloss, argnums=(0, 1, 2))(f32(amap), f32(lm[0]),
                                              f32(img))
    a = torch.tensor(amap, requires_grad=True)
    e1 = torch.tensor(lm[0], requires_grad=True)
    rad = torch.tensor(img, requires_grad=True)
    sphere = tmat.TexturedMicrofacetMaterial(
        dist=convert.material_from_jax(jndf.GGX()),
        fres=convert.material_from_jax(jfres.Schlick(f0=f32([0.9, 0.6, 0.3]))),
        alpha1=a, alpha2=a, alpha_angle=torch.tensor(0.3))
    floor = convert.material_from_jax(lean_floor(lm, mip_lod=True))
    floor = floor.replace(lean=floor.lean.replace(E1=e1))
    u, u_env = jax_uniforms(nb, res * res * spp)
    tpt.render(sphere, floor, LIGHT, [0, 0, 0], [0, 0, 0], res=res, spp=spp,
               max_bounces=nb, envmap=tem.rebind(rad), u=u,
               u_env=u_env).mean().backward()
    for got, w in zip((a.grad, e1.grad, rad.grad), want):
        w = np.asarray(w)
        assert torch.isfinite(got).all() and got.abs().max() > 0
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max())


def test_what_jax_rejects_the_port_rejects():
    """Partially textured LEAN moments, a textured material with a floor
    the fused loop cannot take, and alpha maps of different shapes: the
    same ValueError in both packages."""
    mixed = lean_floor([np.float32(0.0), np.float32(0.0),
                        np.full((4, 4), 0.05, np.float32), np.float32(0.05),
                        np.float32(0.0)])
    unfusable = (textured_sphere(alpha_map((4, 4))), cosine_floor())
    shapes = jmat.TexturedMicrofacetMaterial(
        dist=jndf.GGX(), fres=jfres.Schlick(f0=f32([0.9, 0.6, 0.3])),
        alpha1=f32(alpha_map((4, 4))), alpha2=f32(alpha_map((4, 5))),
        alpha_angle=f32(0.0))
    for (js, jf), match in (((mixed, beck_floor()), "all scalar or all"),
                            (unfusable, "fused SoA path"),
                            ((shapes, beck_floor()), "share one shape")):
        for envmap in (False, True):
            jem, tem = envmaps(sun_sky()) if envmap else (None, None)
            with pytest.raises(ValueError, match=match):
                jpt.render(js, jf, f32(LIGHT), f32(LIGHT_RAD), f32(SKY),
                           res=4, spp=1, max_bounces=1, envmap=jem)
            with pytest.raises(ValueError, match=match):
                tpt.render(convert.material_from_jax(js),
                           convert.material_from_jax(jf), LIGHT, LIGHT_RAD,
                           SKY, res=4, spp=1, max_bounces=1, envmap=tem)


def test_convert_builds_the_textured_classes():
    for jm in (textured_sphere(alpha_map()), tabular_pair(),
               lean_floor(lean_maps(), mip_lod=True)):
        tm = convert.material_from_jax(jm)
        assert type(tm).__name__ == type(jm).__name__
    assert isinstance(tm, FilteredBeckmannMaterial) and tm.mip_lod
    assert isinstance(tm.lean, Lrep) and tm.dmap_scale is None
