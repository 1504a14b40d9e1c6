"""Port parity, anisotropic tabulation: dj_brdf_torch.fit.tabular_aniso
(every stage and the whole builder, both power paths, float64 under
use_x64), microfacet.ndf.TabularAnisotropic (evaluation, sampling,
the microfacet BRDF and materials over it), the anisotropic moment fits
and their gradients w.r.t. the table, and the utia_fit / utia_tab
chains, against the JAX package on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dj_brdf_tpu import fresnel as jfres
from dj_brdf_tpu.fit import moments as jmom
from dj_brdf_tpu.fit import tabular as jtab
from dj_brdf_tpu.fit import tabular_aniso as jta
from dj_brdf_tpu.io import synth as jsynth
from dj_brdf_tpu.microfacet import ndf as jndf
from dj_brdf_tpu.microfacet.params import MicrofacetParams as JParams
from dj_brdf_tpu.models import utia as jutia
from dj_brdf_tpu.render import materials as jmat
from dj_brdf_torch import config, convert
from dj_brdf_torch import fresnel as tfres
from dj_brdf_torch.fit import moments as tmom
from dj_brdf_torch.fit import tabular as ttab
from dj_brdf_torch.fit import tabular_aniso as tta
from dj_brdf_torch.microfacet import ndf as tndf
from dj_brdf_torch.microfacet.params import MicrofacetParams as TParams
from dj_brdf_torch.models import utia as tutia
from dj_brdf_torch.parallel.mesh import Mesh

ELLIPSE = (0.4, 0.15, 0.35)     # tests/test_render_fit_parallel.py:133-134
TABLES = ("p22", "sigma", "pdf1", "cdf1", "pdf2", "cdf2")
QF = ("qf1_table", "qf2_table")
PARAMS = ("ax", "ay", "rho", "txn", "tyn")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def jax_eval():
    return jtab.microfacet_eval_fn(jndf.GGX(), jfres.Ideal(),
                                   JParams.elliptic(*ELLIPSE))


def torch_eval():
    return ttab.microfacet_eval_fn(tndf.GGX(), tfres.Ideal(),
                                   TParams.elliptic(*ELLIPSE))


def close(got, want, rtol, atol_rel, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=rtol,
        atol=atol_rel * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def qf_close(got, want, what=""):
    """A quantile table comes from ``searchsorted`` on spline values, so
    an ulp of the CDF can move an entry by one grid step 1/(8 cnt):
    entries equal up to rounding, or one step off, at most 1 in 64."""
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    step = 1.0 / (8 * (want.shape[-1] - 1))
    d = np.abs(got - want)
    moved = np.abs(d - step) <= 1e-6
    assert ((d <= 1e-6) | moved).all(), what
    assert moved.mean() <= 1 / 64, what


def tables_close(got, want, rtol, atol_rel):
    for name in TABLES:
        close(getattr(got, name), getattr(want, name), rtol, atol_rel, name)
    for name in QF:
        qf_close(getattr(got, name), getattr(want, name), name)


@pytest.mark.parametrize("shape", [(9, 16), (16, 16)])
def test_kernel_matrix_matches_jax(shape):
    want = np.asarray(jta.kernel_matrix(jax_eval(), *shape))
    got = tta.kernel_matrix(torch_eval(), *shape, device="cpu")
    assert got.shape == want.shape == ((shape[0] - 1) * shape[1],) * 2
    close(got, want, 1e-5, 1e-6)


def test_power_iterations_match_jax():
    """The float64 power iteration and the working-precision one on the
    same matrix: rtol 1e-6 (a float64 product rounded to f32) and 1e-5
    (f32 sums in another order)."""
    a = np.array(jta.kernel_matrix(jax_eval(), 16, 16))
    close(tta.power_iteration_p22(torch.from_numpy(a), 16, 16),
          jta.power_iteration_p22(a, 16, 16), 1e-6, 1e-7, "float64")
    close(tta._device_power_table(torch.from_numpy(a), 16, 16),
          jta._device_power_table(jnp.asarray(a), 16, 16), 1e-5, 1e-6,
          "working precision")


@pytest.fixture(scope="module")
def stages():
    """JAX's tables at every stage of a 16x16 build, fed one by one to
    both packages."""
    a = jta.kernel_matrix(jax_eval(), 16, 16)
    raw = jta.power_iteration_p22(a, 16, 16)
    p22 = jta.normalize_p22(raw)
    pdf1 = jta.compute_pdf1(p22)
    cdf1 = jta.compute_cdf1(pdf1)
    pdf2 = jta.compute_pdf2(p22, pdf1)
    cdf2 = jta.compute_cdf2(pdf2)
    return {k: np.array(v) for k, v in dict(
        raw=raw, p22=p22, pdf1=pdf1, cdf1=cdf1, pdf2=pdf2, cdf2=cdf2).items()}


STAGES = {
    "normalize_p22": ("raw",), "compute_sigma": ("p22",),
    "compute_pdf1": ("p22",), "compute_cdf1": ("pdf1",),
    "compute_qf1": ("cdf1",), "compute_pdf2": ("p22", "pdf1"),
    "compute_cdf2": ("pdf2",), "compute_qf2": ("cdf2",)}


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_each_stage_matches_jax_on_the_same_table(stages, stage):
    """rtol 1e-5, atol 1e-6 of the max; quantiles as ``qf_close``."""
    args = [stages[k] for k in STAGES[stage]]
    want = np.asarray(getattr(jta, stage)(*map(jnp.asarray, args)))
    got = getattr(tta, stage)(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32 and got.shape == want.shape
    if stage.startswith("compute_qf"):
        qf_close(got, want)
    else:
        close(got, want, 1e-5, 1e-6)


def test_normalize_p22_returns_the_constant(stages):
    _, want = jta.normalize_p22(jnp.asarray(stages["raw"]), return_nint=True)
    _, got = tta.normalize_p22(torch.from_numpy(stages["raw"]),
                               return_nint=True)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("power", ["host", "device"])
@pytest.mark.parametrize("res", [16, 45])
def test_builder_matches_jax(res, power):
    """The whole pipeline at res x res through each power path: every
    table at rtol 1e-5, atol 1e-5 of its max, the quantiles as
    ``qf_close``, the Fresnel points at atol 1e-5."""
    jd, jf = jta.build_tabular_anisotropic(jax_eval(), res, res, power=power)
    td, tf = tta.build_tabular_anisotropic(torch_eval(), res, res,
                                           power=power, device="cpu")
    assert type(td) is tndf.TabularAnisotropic
    assert td.p22.shape == (res, res) and td.pdf1.shape == (res,)
    tables_close(td, jd, 1e-5, 1e-5)
    close(tf.points, jf.points, 0.0, 1e-5, "fresnel")


@pytest.fixture
def x64():
    """Both packages in float64 (JAX's x64, the port's use_x64), undone
    after the test."""
    jax.config.update("jax_enable_x64", True)
    config.use_x64(True)
    try:
        yield
    finally:
        config.use_x64(False)
        jax.config.update("jax_enable_x64", False)


def test_builder_in_float64_matches_jax_x64(x64):
    """Under x64 the builder runs in float64 in both packages: rtol 1e-9,
    atol 1e-12 of the max (transcendentals differ in the last ulps)."""
    jd, jf = jta.build_tabular_anisotropic(jax_eval(), 16, 16)
    td, tf = tta.build_tabular_anisotropic(torch_eval(), 16, 16,
                                           device="cpu")
    assert td.p22.dtype == torch.float64 and jd.p22.dtype == jnp.float64
    tables_close(td, jd, 1e-9, 1e-12)
    close(tf.points, jf.points, 0.0, 1e-9, "fresnel")


def test_builder_rejects_mesh_and_unknown_power():
    """``mesh=`` with an explicit ``power`` raises as the JAX package's
    does (the sharded stage 1 always runs in f32); an unknown ``power``
    raises. The sharded builder itself: tests/test_torch_mesh.py."""
    mesh = Mesh(rank=0, size=1, device=torch.device("cpu"))
    for power in ("host", "device"):
        with pytest.raises(ValueError, match="power='auto'"):
            jta.build_tabular_anisotropic(jax_eval(), 8, 8, power=power,
                                          mesh=object())
        with pytest.raises(ValueError, match="power='auto'"):
            tta.build_tabular_anisotropic(torch_eval(), 8, 8, power=power,
                                          mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="power"):
        tta.build_tabular_anisotropic(torch_eval(), 8, 8, power="sometimes",
                                      device="cpu")


@pytest.fixture(scope="module")
def dists():
    """A 16x16 JAX table and the port's copy of it."""
    jd, jf = jta.build_tabular_anisotropic(jax_eval(), 16, 16)
    return jd, jf, convert.tabular_anisotropic_from_jax(jd), \
        convert.material_from_jax(jf)


def rand_dirs(rng, n):
    th = rng.uniform(0.05, 1.5, n)
    ph = rng.uniform(-np.pi, np.pi, n)
    return np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                     np.cos(th)], -1).astype(np.float32)


def test_tabular_anisotropic_eval_and_sampling_match_jax(dists):
    """Every table lookup and the nmap sampler with the same uniforms:
    rtol 1e-5, atol 1e-6 of the max."""
    jd, _, td, _ = dists
    rng = np.random.default_rng(5)
    x, y = (rng.normal(0, 0.8, 4096).astype(np.float32) for _ in range(2))
    theta = rng.uniform(0, 0.5 * np.pi, 4096).astype(np.float32)
    phi = rng.uniform(-np.pi, 2 * np.pi, 4096).astype(np.float32)
    u1, u2 = (rng.uniform(0, 1, 4096).astype(np.float32) for _ in range(2))
    k = rand_dirs(rng, 4096)
    T = torch.from_numpy
    for name, args in (("p22_std", (x, y)), ("sigma_std", (k,)),
                       ("p22_std_theta_phi", (theta, phi)),
                       ("pdf1_eval", (phi,)), ("cdf1_eval", (phi,)),
                       ("qf1_eval", (u1,)), ("pdf2_eval", (theta, phi)),
                       ("cdf2_eval", (theta, phi)), ("qf2_eval", (u1, phi))):
        want = getattr(jd, name)(*map(jnp.asarray, args))
        close(getattr(td, name)(*map(T, args)), want, 1e-5, 1e-6, name)
    want = jd.sample_vp22_std(*map(jnp.asarray, (u1, u2, k)))
    got = td.sample_vp22_std(T(u1), T(u2), T(k))
    for g, w, name in zip(got, want, ("x", "y")):
        close(g, w, 1e-5, 1e-6, f"sample {name}")


def test_pole_and_origin_guards_keep_gradients_finite(dists):
    """At slopes (0, 0) and k = up, where sqrt/atan2 have infinite or 0/0
    derivatives, the 1e-24 floors keep the backward finite, and equal to
    JAX's."""
    jd, _, td, _ = dists
    xy = torch.zeros(2, requires_grad=True)
    td.p22_std(xy[0], xy[1]).backward()
    jg = jax.grad(lambda v: jd.p22_std(v[0], v[1]))(jnp.zeros(2))
    assert torch.isfinite(xy.grad).all()
    np.testing.assert_allclose(xy.grad.numpy(), np.asarray(jg), atol=1e-6)
    k = torch.tensor([0.0, 0.0, 1.0], requires_grad=True)
    td.sigma_std(k).backward()
    jg = jax.grad(jd.sigma_std)(jnp.asarray([0.0, 0.0, 1.0]))
    assert torch.isfinite(k.grad).all()
    np.testing.assert_allclose(k.grad.numpy(), np.asarray(jg), atol=1e-6)


def test_materials_over_the_table_match_jax(dists):
    """utia_tab's material (the table itself, standard params, its
    Fresnel) through the microfacet BRDF: evalp, pdf and the sampler's
    weight, direction and pdf with the same uniforms (the tolerances of
    tests/test_torch_render.py's material test)."""
    jd, jf, td, tf = dists
    jm = jmat.MicrofacetMaterial(dist=jd, fres=jf,
                                 params=JParams.standard())
    tm = convert.material_from_jax(jm)
    assert type(tm.dist) is tndf.TabularAnisotropic
    rng = np.random.default_rng(6)
    o, light = rand_dirs(rng, 2048), rand_dirs(rng, 2048)
    u1, u2 = (rng.uniform(0, 1, 2048).astype(np.float32) for _ in range(2))
    T = torch.from_numpy
    close(tm.evalp(T(light), T(o)), jm.evalp(light, o), 2e-5, 1e-6, "evalp")
    close(tm.pdf(T(light), T(o)), jm.pdf(light, o), 1e-4, 1e-6, "pdf")
    w_j, i_j, p_j = jm.evalp_is(u1, u2, o)
    w_t, i_t, p_t = tm.evalp_is(T(u1), T(u2), T(o))
    close(i_t, i_j, 0.0, 1e-4, "direction")
    close(p_t, p_j, 1e-4, 1e-6, "sample pdf")
    close(w_t, w_j, 1e-4, 1e-4, "weight")


@pytest.mark.parametrize("fit", ["fit_beckmann_parameters_anisotropic",
                                 "fit_ggx_parameters_anisotropic"])
def test_moment_fits_and_gradients_match_jax(dists, fit):
    """The fitted parameters at rtol 1e-5 (atol 1e-7) and d ax / d p22
    against jax.grad at rtol 1e-4, atol 1e-6 of the largest."""
    jd, _, td, _ = dists
    want = getattr(jmom, fit)(jd)
    got = getattr(tmom, fit)(td)
    for f in PARAMS:
        np.testing.assert_allclose(float(getattr(got, f)),
                                   float(getattr(want, f)), rtol=1e-5,
                                   atol=1e-7, err_msg=f)
    jg = jax.grad(lambda p22: getattr(jmom, fit)(jd.replace(p22=p22)).ax)(
        jd.p22)
    p22 = td.p22.clone().requires_grad_(True)
    getattr(tmom, fit)(td.replace(p22=p22)).ax.backward()
    assert float(p22.grad.abs().sum()) > 0.0
    close(p22.grad, jg, 1e-4, 1e-6, "d ax / d p22")


@pytest.fixture(scope="module")
def utia_chain():
    """A GGX UTIA bake at fit res 12 through both packages'
    Utia.build -> build_tabular_anisotropic (the utia_fit and utia_tab
    scenes of dj_brdf_tpu/cli/render.py:264-286)."""
    raw = jsynth.bake_utia(lambda i, o: jax_eval()(i, o))
    table = (np.maximum(raw, 0.0) / 140.0).astype(np.float32)
    jd, jf = jta.build_tabular_anisotropic(
        jutia.Utia.build(jnp.asarray(table)), 12, 12)
    td, tf = tta.build_tabular_anisotropic(
        tutia.Utia.build(torch.from_numpy(table)), 12, 12)
    return jd, jf, td, tf


def test_utia_fit_chain_matches_jax(utia_chain):
    """utia_fit: the table, its Beckmann moment fit and the material
    made of them (rtol 1e-5 on the tables and the fit, the material at
    tests/test_torch_render.py's 2e-5)."""
    jd, jf, td, tf = utia_chain
    tables_close(td, jd, 1e-5, 1e-5)
    jp = jmom.fit_beckmann_parameters_anisotropic(jd)
    tp = tmom.fit_beckmann_parameters_anisotropic(td)
    for f in PARAMS:
        np.testing.assert_allclose(float(getattr(tp, f)),
                                   float(getattr(jp, f)), rtol=1e-5,
                                   atol=1e-7, err_msg=f)
    jm = jmat.MicrofacetMaterial(jndf.Beckmann(), jf, jp)
    tm = convert.material_from_jax(jm)
    rng = np.random.default_rng(7)
    o, light = rand_dirs(rng, 1024), rand_dirs(rng, 1024)
    close(tm.evalp(torch.from_numpy(light), torch.from_numpy(o)),
          jm.evalp(light, o), 2e-5, 1e-6)


def test_utia_tab_chain_samples_like_jax(utia_chain):
    jd, jf, td, tf = utia_chain
    jm = jmat.MicrofacetMaterial(dist=jd, fres=jf, params=JParams.standard())
    tm = convert.material_from_jax(jm)
    rng = np.random.default_rng(8)
    o = rand_dirs(rng, 1024)
    u1, u2 = (rng.uniform(0, 1, 1024).astype(np.float32) for _ in range(2))
    w_j, i_j, p_j = jm.evalp_is(u1, u2, o)
    w_t, i_t, p_t = tm.evalp_is(*map(torch.from_numpy, (u1, u2, o)))
    close(i_t, i_j, 0.0, 1e-4, "direction")
    close(p_t, p_j, 1e-4, 1e-6, "pdf")
    close(w_t, w_j, 1e-4, 1e-4, "weight")
