"""Port parity, core layer: dj_brdf_torch.core, fresnel, microfacet.params
and config against the JAX package on the same numpy inputs (f32)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dj_brdf_tpu import fresnel as jfres
from dj_brdf_tpu.core import math as jmath
from dj_brdf_tpu.core import special as jspecial
from dj_brdf_tpu.core import spline as jspline
from dj_brdf_tpu.microfacet import params as jparams
from dj_brdf_torch import config
from dj_brdf_torch import fresnel as tfres
from dj_brdf_torch.core import math as tmath
from dj_brdf_torch.core import pytree
from dj_brdf_torch.core import special as tspecial
from dj_brdf_torch.core import spline as tspline
from dj_brdf_torch.microfacet import params as tparams

# Same f32 operations on both sides; differences are libm rounding.
RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def check(got, want, rtol=RTOL, atol=ATOL):
    got = [got] if isinstance(got, torch.Tensor) else got
    want = [want] if not isinstance(want, (tuple, list)) else want
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().numpy()
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def both(*arrays):
    """The same numpy arrays as JAX and torch inputs."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def unit_dirs(rng, n, hemi=False):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    if hemi:
        v[:, 2] = np.abs(v[:, 2]) + 0.05
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------- special

def test_erf_matches_reference_polynomial():
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    (jx,), (tx,) = both(x)
    check(tspecial.erf(tx), jspecial.erf(jx))


def test_erf_special_points():
    x = np.asarray([0.0, -0.0, 1e-8, -1e-8, 6.0, -6.0], np.float32)
    (jx,), (tx,) = both(x)
    got = tspecial.erf(tx)
    check(got, jspecial.erf(jx))
    assert got[0] == 0 and got[1] == 0
    np.testing.assert_allclose(got[4:].numpy(), [1.0, -1.0], atol=1e-7)
    assert got[2] == -got[3]


def test_erfinv_matches_reference_polynomial():
    u = np.linspace(-0.99999, 0.99999, 4001, dtype=np.float32)
    (ju,), (tu,) = both(u)
    check(tspecial.erfinv(tu), jspecial.erfinv(ju), rtol=1e-6, atol=1e-6)


def test_erf_exact_is_torch():
    assert tspecial.erf_exact is torch.erf
    assert tspecial.erfinv_exact is torch.erfinv


# ------------------------------------------------------------------ math

def _math_cases(rng):
    a, b = unit_dirs(rng, 257), unit_dirs(rng, 257)
    th = rng.uniform(0.0, np.pi, 257).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, 257).astype(np.float32)
    u1, u2 = rng.uniform(0, 1, (2, 257)).astype(np.float32)
    rgb = rng.uniform(0, 2, (257, 3)).astype(np.float32)
    axis = unit_dirs(rng, 1)[0]
    hemi_i, hemi_o = unit_dirs(rng, 257, True), unit_dirs(rng, 257, True)
    # the frame of h is ill-conditioned at the pole (phi_h = atan2 of two
    # tiny numbers): keep half vectors at least 0.05 off it
    h = hemi_i + hemi_o
    off_pole = np.hypot(h[:, 0], h[:, 1]) > 0.05 * np.linalg.norm(h, axis=-1)
    hemi_i, hemi_o = hemi_i[off_pole], hemi_o[off_pole]
    return {
        "vec3": ("vec3", (a[:, 0], a[:, 1], a[:, 2])),
        "from_spherical": ("from_spherical", (th, ph)),
        "to_spherical": ("to_spherical", (np.concatenate(
            [a, [[0, 0, 1], [0, 0, -1]]]).astype(np.float32),)),
        "dot": ("dot", (a, b)),
        "cross": ("cross", (a, b)),
        "normalize": ("normalize", (3.0 * a,)),
        "intensity": ("intensity", (rgb,)),
        "sat": ("sat", (3.0 * a,)),
        "rotate_vector": ("rotate_vector", (a, np.broadcast_to(
            axis, a.shape).copy(), th)),
        "io_to_hd": ("io_to_hd", (hemi_i, hemi_o)),
        "hd_to_io": ("hd_to_io", (hemi_i, hemi_o)),
        "reflect": ("reflect", (a, b)),
        "uniform_to_concentric": ("uniform_to_concentric", (
            np.concatenate([u1, [0.5]]).astype(np.float32),
            np.concatenate([u2, [0.5]]).astype(np.float32))),
        "cosine_hemisphere_sample": ("cosine_hemisphere_sample", (u1, u2)),
    }


MATH_CASES = list(_math_cases(np.random.default_rng(1)))


@pytest.mark.parametrize("case", MATH_CASES)
def test_math_matches_jax(case):
    name, args = _math_cases(np.random.default_rng(1))[case]
    jargs, targs = both(*args)
    want = getattr(jmath, name)(*jargs)
    got = getattr(tmath, name)(*targs)
    # io_to_hd / hd_to_io chain acos, atan2, two Rodrigues rotations (sin,
    # cos) and two normalizations: each libm call may round by an ulp,
    # and the chain reaches a few ulps of its O(1) outputs
    atol = 2e-6 if name in ("io_to_hd", "hd_to_io") else ATOL
    check(got, want, atol=atol)


def test_normalize_eps_grad_finite():
    v = torch.zeros((4, 3), requires_grad=True)
    tmath.normalize(v, eps=1e-24).sum().backward()
    assert torch.isfinite(v.grad).all()


# ---------------------------------------------------------------- spline

@pytest.mark.parametrize("wrap", ["edge", "repeat"])
def test_spline_eval1d_matches_jax(wrap):
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, 1, (17, 3)).astype(np.float32)
    u = rng.uniform(-0.2, 1.2, 301).astype(np.float32)
    (jp, ju), (tp, tu) = both(pts, u)
    check(tspline.eval1d(tp, tu, wrap), jspline.eval1d(jp, ju, wrap))


def test_spline_eval2d_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 1, (9, 13)).astype(np.float32)
    u1, u2 = rng.uniform(0, 1, (2, 301)).astype(np.float32)
    (jp, j1, j2), (tp, t1, t2) = both(pts, u1, u2)
    check(tspline.eval2d(tp, t1, t2, "repeat", "edge"),
          jspline.eval2d(jp, j1, j2, "repeat", "edge"))


def test_spline_bad_wrap_raises():
    with pytest.raises(ValueError):
        tspline.eval1d(torch.zeros(4), torch.zeros(2), "mirror")


# --------------------------------------------------------------- fresnel

def _fresnel_models(rng, lib, asarray):
    f0 = rng.uniform(0.02, 0.98, 3).astype(np.float32)
    ior = rng.uniform(1.2, 2.5, 3).astype(np.float32)
    eta = rng.uniform(0.2, 2.0, 3).astype(np.float32)
    k = rng.uniform(1.0, 4.0, 3).astype(np.float32)
    pts = rng.uniform(0, 1, (12, 3)).astype(np.float32)
    return {
        "Ideal": lib.Ideal(),
        "Unpolarized": lib.Unpolarized(ior=asarray(ior)),
        "Schlick": lib.Schlick(f0=asarray(f0)),
        "SGDFresnel": lib.SGDFresnel(f0=asarray(f0), f1=asarray(0.3 * f0)),
        "Conductor": lib.Conductor(eta=asarray(eta), k=asarray(k)),
        "SplineFresnel": lib.SplineFresnel(points=asarray(pts)),
    }


@pytest.mark.parametrize("model", ["Ideal", "Unpolarized", "Schlick",
                                   "SGDFresnel", "Conductor",
                                   "SplineFresnel"])
def test_fresnel_matches_jax(model):
    c = np.linspace(0.0, 1.0, 257, dtype=np.float32)
    (jc,), (tc,) = both(c)
    want = _fresnel_models(np.random.default_rng(4), jfres, jnp.asarray)[model](jc)
    got = _fresnel_models(np.random.default_rng(4), tfres,
                          torch.from_numpy)[model](tc)
    check(got, want)


def test_ior_f0_roundtrip_matches_jax():
    ior = np.linspace(1.05, 3.0, 64, dtype=np.float32)
    f0 = np.concatenate([np.linspace(0.0, 0.99, 63), [1.0]]).astype(np.float32)
    (ji, jf), (ti, tf) = both(ior, f0)
    check(tfres.ior_to_f0(ti), jfres.ior_to_f0(ji))
    check(tfres.f0_to_ior(tf), jfres.f0_to_ior(jf), rtol=2e-6)


# ---------------------------------------------------------------- params

def test_ellipse_pdfparams_match_jax():
    rng = np.random.default_rng(5)
    a1 = rng.uniform(0.05, 1.0, 64).astype(np.float32)
    a2 = rng.uniform(0.05, 1.0, 64).astype(np.float32)
    phi = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    jargs, targs = both(a1, a2, phi)
    want = jparams.ellipse_to_pdfparams(*jargs)
    got = tparams.ellipse_to_pdfparams(*targs)
    check(got, want, atol=1e-6)
    check(tparams.pdfparams_to_ellipse(*got),
          jparams.pdfparams_to_ellipse(*want), rtol=2e-6, atol=2e-6)


def test_microfacet_params_constructors_match_jax():
    J, T = jparams.MicrofacetParams, tparams.MicrofacetParams
    n = unit_dirs(np.random.default_rng(6), 8, hemi=True)
    cases = [
        (J.standard(), T.standard()),
        (J.isotropic(0.3), T.isotropic(0.3)),
        (J.elliptic(0.5, 0.2, 0.3, txn=0.1, tyn=-0.05),
         T.elliptic(0.5, 0.2, 0.3, txn=0.1, tyn=-0.05)),
        (J.pdfparams(0.4, 0.2, 0.3, 0.05, -0.1),
         T.pdfparams(0.4, 0.2, 0.3, 0.05, -0.1)),
        (J.from_normal(jnp.asarray(n), 0.3, 0.2),
         T.from_normal(torch.from_numpy(n), 0.3, 0.2)),
    ]
    for jp, tp in cases:
        for f in ("ax", "ay", "rho", "txn", "tyn"):
            check(getattr(tp, f), getattr(jp, f), atol=1e-6)
        check(tp.sqrt_one_minus_rho_sqr, jp.sqrt_one_minus_rho_sqr)
        check(tp.mean_normal, jp.mean_normal)
        check(tp.ellipse(), jp.ellipse(), rtol=2e-6, atol=2e-6)


# --------------------------------------------------------- pytree/config

def test_pytree_dataclass_replace_and_static_fields():
    from dj_brdf_torch.microfacet.ndf import GGX

    p = tparams.MicrofacetParams.isotropic(0.3)
    q = p.replace(ax=torch.tensor(0.7))
    assert float(q.ax) == pytest.approx(0.7) and q.ay is p.ay
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.ax = torch.tensor(1.0)
    assert pytree.tensor_fields(p) == ("ax", "ay", "rho", "txn", "tyn")
    assert pytree.tensor_fields(GGX()) == ()


def test_config_x64_switch():
    assert config.EPSILON == 1e-4
    assert config.default_float() == torch.float32
    try:
        config.use_x64(True)
        assert config.default_float() == torch.float64
        assert tparams.MicrofacetParams.isotropic(0.3).ax.dtype == torch.float64
    finally:
        config.use_x64(False)
    assert torch.get_default_dtype() == torch.float32
