"""Port parity, environment-map lighting: the host alias builder, the
``EnvMap`` tables, its sampler and lookups, ``rebind``'s gradient, and
the envmap MIS transport of the path tracer (both loops), against the
JAX package on the same inputs. The renders take JAX's own uniforms:
``u`` from ``PRNGKey(0)`` and ``u_env`` from its ``fold_in(.., 0xE57)``.

Tolerances: the tables and ``sample_grid`` bit for bit (integer and
f32 arithmetic without transcendentals). ``eval_with_pdf`` and
``sample`` at f32 rounding, except lanes whose arccos/arctan2 rounding
puts the direction in the neighbouring cell or half-cell: there the
bilinear weights or the pdf bin change (``CELL_FLIPS`` of the lanes at
most). Renders at ``test_torch_render.py``'s image tolerances."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dj_brdf_tpu import fresnel as jfres
from dj_brdf_tpu.io import native
from dj_brdf_tpu.io import synth as jsynth
from dj_brdf_tpu.microfacet import brdf as jbrdf
from dj_brdf_tpu.microfacet import ndf as jndf
from dj_brdf_tpu.microfacet.params import MicrofacetParams as JParams
from dj_brdf_tpu.models.lambert import Lambert as JLambert
from dj_brdf_tpu.models.merl import Merl as JMerl
from dj_brdf_tpu.render import envmap as jenv
from dj_brdf_tpu.render import materials as jmat
from dj_brdf_tpu.render import pathtrace as jpt
from dj_brdf_torch import convert
from dj_brdf_torch.ops import _build
from dj_brdf_torch.render import envmap as tenv
from dj_brdf_torch.render import pathtrace as tpt

LIGHT = [0.3, 0.4, 0.8]
CELL_FLIPS = 1 / 256
MAX_FLIPS = 1 / 256


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def t(x):
    return torch.tensor(np.array(x))


def image_close(got, want, rtol=1e-4, atol=1e-4):
    """Pixelwise, allowing MAX_FLIPS of the pixels to differ (a lane
    whose alive mask flips between the packages, as in
    test_torch_render.py)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    flips = bad.any(-1).sum()
    assert flips <= MAX_FLIPS * bad[..., 0].size, \
        (flips, float(np.abs(got - want).max()))


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def sun_sky(h=16, w=32, seed=0):
    rng = np.random.default_rng(seed)
    img = np.abs(rng.normal(1.0, 0.5, (h, w, 3))).astype(np.float32)
    img[h // 5:h // 5 + max(1, h // 10),
        w // 3:w // 3 + max(1, w // 12)] *= 40.0
    return img


def both_envmaps(img, **kw):
    jem = jenv.EnvMap.build(jnp.asarray(img), **kw)
    rot = kw.pop("rotation", None)
    tem = tenv.EnvMap.build(img, device="cpu",
                            rotation=None if rot is None else np.array(rot),
                            **kw)
    return jem, tem


# ------------------------------------------------------------- alias

@pytest.mark.parametrize("kind", ["random", "zeros", "one_hot", "2^18+1"])
def test_alias_builder_matches_the_native_builder(kind):
    """The port's host library against the JAX package's native one,
    bit for bit: random masses, masses with zero bins, a one-hot mass,
    and 2^18 + 1 bins."""
    assert native.available()
    rng = np.random.default_rng(1)
    n = {"2^18+1": (1 << 18) + 1}.get(kind, 4099)
    mass = rng.uniform(0.0, 1.0, n) ** 3
    if kind == "zeros":
        mass[rng.uniform(size=n) < 0.3] = 0.0
    elif kind == "one_hot":
        mass = np.zeros(n)
        mass[1234] = 2.5
    want = native.build_alias(mass)
    got = tenv.build_alias(mass)
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    np.testing.assert_array_equal(got[1], want[1])


def test_alias_builder_rejects_bad_masses():
    for mass in (np.zeros(8), np.array([1.0, -1.0]), np.array([np.nan]),
                 np.zeros(0)):
        with pytest.raises(ValueError, match="djbt_build_alias"):
            tenv.build_alias(mass)


def test_alias_library_builds_under_the_port_and_needs_g_plus_plus(
        monkeypatch, tmp_path):
    """The host library lands in the port's build directory, named by
    the hash of its source; without a C++ compiler the build raises
    (there is no numpy fallback)."""
    path = _build.build("alias")
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert "dj_brdf_tpu" not in str(path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.build("alias")


# ------------------------------------------------------------ tables

@pytest.mark.parametrize("case", ["bilinear_32x64", "nearest_512x520",
                                  "rotated"])
def test_envmap_build_tables_bit_for_bit(case):
    """EnvMap.build's radiance, packed and alias tables equal JAX's
    native-built ones bit for bit: bilinear rows at 32x64, nearest rows
    above 2^18 bins (auto), and with a rotation."""
    kw = {}
    if case == "nearest_512x520":
        img = sun_sky(512, 520, seed=2)
    else:
        img = sun_sky(32, 64)
    if case == "rotated":
        kw["rotation"] = np.asarray(jenv.EnvMap.rotation_z(0.7))
    jem, tem = both_envmaps(img, **kw)
    assert tem.packed.shape[1] == (4 if case.startswith("nearest") else 16)
    for name in ("radiance", "packed", "alias"):
        np.testing.assert_array_equal(bits(getattr(tem, name)),
                                      bits(getattr(jem, name)), err_msg=name)
    if case == "rotated":
        rz = tenv.EnvMap.rotation_z(0.7)
        np.testing.assert_allclose(rz.numpy(), np.asarray(jem.rot),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(bits(tem.rot), bits(jem.rot))
    conv = convert.envmap_from_jax(jem)
    for name in ("radiance", "packed", "alias"):
        np.testing.assert_array_equal(bits(getattr(conv, name)),
                                      bits(getattr(jem, name)))


def test_envmap_build_rejects_what_jax_rejects():
    img = np.ones((4, 8, 3), np.float32)
    with pytest.raises(ValueError, match="unknown filter"):
        tenv.EnvMap.build(img, filter="cubic", device="cpu")
    with pytest.raises(ValueError, match="unknown filter"):
        jenv.EnvMap.build(jnp.asarray(img), filter="cubic")
    img[1, 2, 0] = np.inf
    with pytest.raises(ValueError, match="non-finite"):
        tenv.EnvMap.build(img, device="cpu")
    with pytest.raises(ValueError, match="non-finite"):
        jenv.EnvMap.build(jnp.asarray(img))


# ---------------------------------------------------------- sampling

def uniforms(n, seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.0, 1.0, (3, n)).astype(np.float32)
    u[:, :4] = [[0.0, 1.0, 0.9999999, 0.5]] * 3       # edges
    return u


@pytest.mark.parametrize("filt", ["bilinear", "nearest"])
def test_sample_grid_bit_for_bit(filt):
    jem, tem = both_envmaps(sun_sky(32, 64), filter=filt)
    u = uniforms(8192, 3)
    want = jem.sample_grid(*map(jnp.asarray, u))
    got = tem.sample_grid(*map(torch.from_numpy, u))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bits(g), bits(w))


def directions(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:3] = [[0, 0, 1], [0, 0, -1], [1, 0, 0]]       # poles, phi = 0
    return d.astype(np.float32)


@pytest.mark.parametrize("filt,rotate", [("bilinear", False),
                                         ("nearest", False),
                                         ("bilinear", True)])
def test_eval_sample_and_power_heuristic_match_jax(filt, rotate):
    kw = dict(filter=filt)
    if rotate:
        kw["rotation"] = np.asarray(jenv.EnvMap.rotation_z(0.7))
    jem, tem = both_envmaps(sun_sky(32, 64), **kw)
    n = 8192
    d = directions(n, 4)
    want = np.stack(jem.eval_with_pdf(*(jnp.asarray(d[:, k])
                                        for k in range(3))))
    got = torch.stack(tem.eval_with_pdf(*(t(d[:, k]) for k in range(3))))
    bad = ~np.isclose(got.numpy(), want, rtol=1e-5, atol=1e-6).all(0)
    assert bad.mean() <= CELL_FLIPS, bad.sum()

    u = uniforms(n, 5)
    want = np.stack(jem.sample(*map(jnp.asarray, u)))
    got = torch.stack(tem.sample(*map(torch.from_numpy, u))).numpy()
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(got[3], want[3], rtol=2e-5)

    pa = np.abs(np.random.default_rng(6).normal(size=(2, n))).astype(
        np.float32)
    pa[:, :3] = [[0.0, 0.0, 1e-30], [0.0, 1.0, 0.0]]
    got = tenv.power_heuristic(*map(torch.from_numpy, pa))
    want = jenv.power_heuristic(*map(jnp.asarray, pa))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_rebind_gradient_matches_jax():
    """d/d radiance of a weighted sum of rebind(radiance) lookups,
    against jax.grad; the frozen pdf columns take no gradient."""
    img = sun_sky(16, 32)
    jem, tem = both_envmaps(img)
    d = directions(2048, 7)
    wts = np.random.default_rng(8).uniform(size=(3, 2048)).astype(np.float32)

    def jloss(rad):
        r, g, b, pdf = jem.rebind(rad).eval_with_pdf(
            *(jnp.asarray(d[:, k]) for k in range(3)))
        return ((jnp.stack([r, g, b]) * wts).sum() + pdf.sum())

    want = jax.grad(jloss)(jnp.asarray(img))
    rad = torch.tensor(img, requires_grad=True)
    r, g, b, pdf = tem.rebind(rad).eval_with_pdf(*(t(d[:, k]) for k in range(3)))
    ((torch.stack([r, g, b]) * t(wts)).sum() + pdf.sum()).backward()
    np.testing.assert_allclose(rad.grad.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    # the same radiance reproduces the built map's packed rows
    np.testing.assert_array_equal(bits(tem.rebind(t(img)).packed),
                                  bits(tem.packed))


# ----------------------------------------------------------- renders

def scene(kind):
    """The GGX+Schlick sphere over a Beckmann floor (mixed), a GGX floor
    (same family), a cosine-sampled Lambert floor (generic loop), or a
    MERL-table MeasuredMaterial sphere over the cosine floor."""
    sphere = jmat.MicrofacetMaterial(
        jndf.GGX(), jfres.Schlick(f0=jnp.asarray([0.9, 0.6, 0.3])),
        JParams.elliptic(0.3, 0.15, 0.7))
    cosine = jmat.CosineMaterial(
        model=JLambert(reflectance=jnp.asarray([0.4, 0.4, 0.4])))
    if kind == "cosine":
        return sphere, cosine
    if kind == "measured":
        return measured_sphere(), cosine
    return sphere, jmat.MicrofacetMaterial(
        jndf.Beckmann() if kind == "mixed" else jndf.GGX(),
        jfres.Schlick(f0=jnp.asarray([0.3, 0.3, 0.3])),
        JParams.isotropic(0.5))


def measured_sphere():
    def ggx(i, o):
        return jbrdf.eval(jndf.GGX(), jfres.Schlick(
            f0=jnp.asarray([0.9, 0.6, 0.3])), JParams.isotropic(0.25), i, o)
    table = np.asarray(jsynth.bake_merl(ggx), np.float32)
    return jmat.MeasuredMaterial(model=JMerl(table=jnp.asarray(table)),
                                 proxy_params=JParams.isotropic(0.3),
                                 proxy_dist=jndf.GGX())


def jax_uniforms(nb, n_rays):
    key = jax.random.PRNGKey(0)
    return (t(jax.random.uniform(key, (nb, n_rays, 2))),
            t(jax.random.uniform(jax.random.fold_in(key, 0xE57),
                                 (nb, n_rays, 3))))


def render_pair(js, jf, jem, tem, res=16, spp=4, nb=3):
    want = np.asarray(jpt.render(js, jf, jnp.asarray(LIGHT), jnp.zeros(3),
                                 jnp.zeros(3), res=res, spp=spp,
                                 max_bounces=nb, envmap=jem))
    u, u_env = jax_uniforms(nb, res * res * spp)
    got = tpt.render(convert.material_from_jax(js),
                     convert.material_from_jax(jf), LIGHT, [0, 0, 0],
                     [0, 0, 0], res=res, spp=spp, max_bounces=nb,
                     envmap=tem, u=u, u_env=u_env)
    return got, want


@pytest.mark.parametrize("kind,rotate", [("mixed", False), ("same", False),
                                         ("mixed", True), ("cosine", False),
                                         ("measured", False)])
def test_envmap_render_matches_jax(kind, rotate):
    """render(envmap=) on the SoA MIS loop (mixed: the dual-family pass
    with its NEE pdf; same-family; a rotated map) and on the generic
    loop (a cosine floor; a MERL MeasuredMaterial)."""
    kw = {"rotation": np.asarray(jenv.EnvMap.rotation_z(0.7))} if rotate \
        else {}
    jem, tem = both_envmaps(sun_sky(16, 32), **kw)
    js, jf = scene(kind)
    res, spp = (12, 2) if kind == "measured" else (16, 4)
    got, want = render_pair(js, jf, jem, tem, res, spp)
    assert got.shape == (res, res, 3) and float(got.mean()) > 0.1
    image_close(got, want)


def test_envmap_soa_loop_matches_generic_loop(monkeypatch):
    jem, tem = both_envmaps(sun_sky(16, 32))
    ts, tf = (convert.material_from_jax(m) for m in scene("mixed"))
    u, u_env = jax_uniforms(2, 16 * 16 * 2)
    kw = dict(res=16, spp=2, max_bounces=2, envmap=tem, u=u, u_env=u_env)
    fused = tpt.render(ts, tf, LIGHT, [0, 0, 0], [0, 0, 0], **kw)
    monkeypatch.setattr(tpt, "_fused_info", lambda m: None)
    generic = tpt.render(ts, tf, LIGHT, [0, 0, 0], [0, 0, 0], **kw)
    image_close(generic, fused, rtol=2e-3, atol=2e-4)


def test_envmap_render_draws_u_env_after_u():
    """Without u_env the render draws it from the generator after u, so
    a delta-light render's stream is unchanged; u_env's shape is
    checked."""
    _, tem = both_envmaps(sun_sky(8, 16))
    ts, tf = (convert.material_from_jax(m) for m in scene("mixed"))
    n = 8 * 8 * 2
    gen = torch.Generator().manual_seed(5)
    u = torch.rand((2, n, 2), generator=gen)
    u_env = torch.rand((2, n, 3), generator=gen)
    kw = dict(res=8, spp=2, max_bounces=2, envmap=tem)
    a = tpt.render(ts, tf, LIGHT, [0, 0, 0], [0, 0, 0],
                   generator=torch.Generator().manual_seed(5), **kw)
    b = tpt.render(ts, tf, LIGHT, [0, 0, 0], [0, 0, 0], u=u, u_env=u_env,
                   **kw)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="u_env must be"):
        tpt.render(ts, tf, LIGHT, [0, 0, 0], [0, 0, 0], u=u,
                   u_env=u_env[..., :2], **kw)


def test_envmap_radiance_gradient_matches_jax():
    """d mean(image) / d radiance through rebind at res 8, against
    jax.grad of the JAX render (mixed scene, SoA MIS loop)."""
    img = sun_sky(8, 16)
    jem, tem = both_envmaps(img)
    js, jf = scene("mixed")
    res, spp, nb = 8, 2, 2

    def jloss(rad):
        return jpt.render(js, jf, jnp.asarray(LIGHT), jnp.zeros(3),
                          jnp.zeros(3), res=res, spp=spp, max_bounces=nb,
                          envmap=jem.rebind(rad)).mean()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(img)))
    rad = torch.tensor(img, requires_grad=True)
    u, u_env = jax_uniforms(nb, res * res * spp)
    img_t = tpt.render(convert.material_from_jax(js),
                       convert.material_from_jax(jf), LIGHT, [0, 0, 0],
                       [0, 0, 0], res=res, spp=spp, max_bounces=nb,
                       envmap=tem.rebind(rad), u=u, u_env=u_env)
    img_t.mean().backward()
    g = rad.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    np.testing.assert_allclose(g, want, rtol=1e-3,
                               atol=1e-4 * np.abs(want).max())


def test_envmap_render_on_the_table_device():
    """An EnvMap built from a CPU tensor lives on the CPU; a numpy image
    goes to the card by default (without one, building there raises)."""
    em = tenv.EnvMap.build(torch.from_numpy(sun_sky(4, 8)))
    assert em.packed.device.type == "cpu" and em.rot is None
    assert dataclasses.replace(em).alias.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tenv.EnvMap.build(sun_sky(4, 8))
