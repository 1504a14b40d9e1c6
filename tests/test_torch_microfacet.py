"""Port parity, microfacet layer: dj_brdf_torch.microfacet.ndf (evaluation
half) and brdf against the JAX package on the same numpy inputs (f32),
plus the degenerate-direction and gradient behaviour."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dj_brdf_tpu import fresnel as jfres
from dj_brdf_tpu.microfacet import brdf as jmf
from dj_brdf_tpu.microfacet import ndf as jndf
from dj_brdf_tpu.microfacet.params import MicrofacetParams as JParams
from dj_brdf_torch import fresnel as tfres
from dj_brdf_torch.microfacet import brdf as tmf
from dj_brdf_torch.microfacet import ndf as tndf
from dj_brdf_torch.microfacet.params import MicrofacetParams as TParams

# evalp chains ~40 f32 operations (sqrt, exp, erf polynomial, divides)
RTOL, ATOL = 2e-5, 1e-6
DISTS = ["GGX", "Beckmann", "GGXSphericalCaps"]
# (a1, a2, phi_a, txn, tyn): isotropic, anisotropic with rho != 0, and
# off-centre mean normals
PARAMS = [(0.3, 0.3, 0.0, 0.0, 0.0), (0.5, 0.2, 0.3, 0.1, -0.05),
          (0.15, 0.6, -0.9, -0.2, 0.12)]
F0 = np.asarray([0.9, 0.7, 0.4], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def hemi_dirs(rng, n):
    th = rng.uniform(0.02, 1.55, n)
    ph = rng.uniform(0, 2 * np.pi, n)
    return np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                     np.cos(th)], -1).astype(np.float32)


def models(dist, p):
    a1, a2, phi, txn, tyn = p
    return ((getattr(jndf, dist)(), jfres.Schlick(f0=jnp.asarray(F0)),
             JParams.elliptic(a1, a2, phi, txn=txn, tyn=tyn)),
            (getattr(tndf, dist)(), tfres.Schlick(f0=torch.from_numpy(F0)),
             TParams.elliptic(a1, a2, phi, txn=txn, tyn=tyn)))


def check(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("p", PARAMS, ids=["iso", "aniso", "offcentre"])
@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("fn", ["evalp", "eval"])
def test_evalp_eval_match_jax(fn, dist, p):
    rng = np.random.default_rng(10)
    i, o = hemi_dirs(rng, 2048), hemi_dirs(rng, 2048)
    (jd, jf, jp), (td, tf, tp) = models(dist, p)
    want = getattr(jmf, fn)(jd, jf, jp, jnp.asarray(i), jnp.asarray(o))
    got = getattr(tmf, fn)(td, tf, tp, torch.from_numpy(i),
                           torch.from_numpy(o))
    assert float(np.abs(np.asarray(want)).max()) > 0
    check(got, want)


@pytest.mark.parametrize("fn", ["ndf", "sigma", "g1", "gaf", "vndf"])
@pytest.mark.parametrize("dist", ["GGX", "Beckmann"])
def test_microfacet_terms_match_jax(fn, dist):
    rng = np.random.default_rng(11)
    i, o = hemi_dirs(rng, 1024), hemi_dirs(rng, 1024)
    h = (i + o) / np.linalg.norm(i + o, axis=-1, keepdims=True)
    (jd, _, jp), (td, _, tp) = models(dist, PARAMS[1])
    jargs = {"ndf": (jnp.asarray(h),), "sigma": (jnp.asarray(o),),
             "g1": (jnp.asarray(h), jnp.asarray(o)),
             "gaf": (jnp.asarray(h), jnp.asarray(i), jnp.asarray(o)),
             "vndf": (jnp.asarray(h), jnp.asarray(o))}[fn]
    targs = tuple(torch.from_numpy(np.array(a)) for a in jargs)
    check(getattr(tmf, fn)(td, tp, *targs), getattr(jmf, fn)(jd, jp, *jargs))


@pytest.mark.parametrize("dist", ["GGX", "Beckmann"])
def test_p22_vp22_match_jax(dist):
    rng = np.random.default_rng(12)
    x, y = rng.normal(0, 0.6, (2, 1024)).astype(np.float32)
    k = hemi_dirs(rng, 1024)
    (jd, _, jp), (td, _, tp) = models(dist, PARAMS[2])
    tx, ty, tk = (torch.from_numpy(a) for a in (x, y, k))
    check(tmf.p22(td, tp, tx, ty), jmf.p22(jd, jp, x, y))
    check(tmf.vp22(td, tp, tx, ty, tk),
          jmf.vp22(jd, jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(k)))


@pytest.mark.parametrize("fn", ["p22_radial", "sigma_std_radial",
                                "cdf_radial", "qf_radial"])
@pytest.mark.parametrize("dist", ["GGX", "Beckmann"])
def test_radial_queries_match_jax(fn, dist):
    x = {"p22_radial": np.linspace(0, 20, 513),
         "sigma_std_radial": np.linspace(-1, 1, 513),
         "cdf_radial": np.linspace(0, 6, 513),
         "qf_radial": np.linspace(0, 0.999, 513)}[fn].astype(np.float32)
    want = getattr(getattr(jndf, dist)(), fn)(jnp.asarray(x))
    got = getattr(getattr(tndf, dist)(), fn)(torch.from_numpy(x))
    check(got, want, rtol=2e-6, atol=1e-7)


def test_spherical_caps_is_ggx_for_evaluation():
    from dj_brdf_torch.fit.lsq import fused_eligible

    assert isinstance(tndf.GGXSphericalCaps(), tndf.GGX)
    assert fused_eligible(tndf.GGXSphericalCaps()) == "ggx"
    assert fused_eligible(tndf.Beckmann()) == "beck"
    assert fused_eligible(tndf.GGX(), shadow=False) is None
    assert tndf.GGX().supports_smith_vndf


@pytest.mark.parametrize("dist", DISTS)
def test_degenerate_directions_zero_with_finite_grads(dist):
    """o below the horizon, o.z == 0 and i == -o give 0; o = +z is finite.
    Autograd through all of them stays finite (the double-where)."""
    rng = np.random.default_rng(13)
    i = hemi_dirs(rng, 6)
    o = hemi_dirs(rng, 6)
    o[0] = [0.3, 0.1, -0.9]                          # below the horizon
    o[1] = [1.0, 0.0, 0.0]                           # grazing, o.z = 0
    o[2] = -i[2]                                     # i == -o
    i[3], o[3] = [0.0, 0.0, 1.0], [0.0, 0.0, 1.0]    # both at the pole
    o[4] = [0.0, 0.0, 1.0]                           # o = +z
    ti, to = torch.from_numpy(i), torch.from_numpy(o)
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in
              zip(("ax", "ay", "rho", "txn", "tyn"), (0.4, 0.3, 0.2, 0.05,
                                                       -0.03))}
    f0 = torch.tensor(F0, requires_grad=True)
    val = tmf.evalp(getattr(tndf, dist)(), tfres.Schlick(f0=f0),
                    TParams(**leaves), ti, to)
    assert torch.all(val[:3] == 0)
    assert torch.isfinite(val).all() and (val[3:] > 0).all()
    val.sum().backward()
    for leaf in (*leaves.values(), f0):
        assert torch.isfinite(leaf.grad).all()


@pytest.mark.parametrize("dist", DISTS)
def test_evalp_gradient_matches_jax_grad(dist):
    rng = np.random.default_rng(14)
    i, o = hemi_dirs(rng, 512), hemi_dirs(rng, 512)
    names = ("ax", "ay", "rho", "txn", "tyn")
    vals = np.asarray([0.45, 0.25, 0.3, 0.08, -0.06], np.float32)

    def jloss(v, f0):
        p = JParams(*[v[k] for k in range(5)])
        return jmf.evalp(getattr(jndf, dist)(), jfres.Schlick(f0=f0), p,
                         jnp.asarray(i), jnp.asarray(o)).mean()

    want_p, want_f = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(vals),
                                                     jnp.asarray(F0))
    leaves = [torch.tensor(v, requires_grad=True) for v in vals]
    f0 = torch.tensor(F0, requires_grad=True)
    tmf.evalp(getattr(tndf, dist)(), tfres.Schlick(f0=f0),
              TParams(**dict(zip(names, leaves))), torch.from_numpy(i),
              torch.from_numpy(o)).mean().backward()
    got_p = torch.stack([leaf.grad for leaf in leaves])
    check(got_p, want_p, rtol=1e-4, atol=0)
    check(f0.grad, want_f, rtol=1e-4, atol=0)
