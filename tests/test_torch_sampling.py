"""Port parity, the sampling half of the microfacet layer: the Beckmann
slope-space quantile and its implicit-function gradient, every
distribution's ``sample_vp22_std``, and ``brdf.sample``/``pdf``/
``evalp_is``, against the JAX package on the same numpy inputs (f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dj_brdf_tpu.microfacet import brdf as jbrdf
from dj_brdf_tpu.microfacet import ndf as jndf
from dj_brdf_tpu import fresnel as jfres
from dj_brdf_tpu.microfacet.params import MicrofacetParams as JParams
from dj_brdf_tpu.ops import soa as jsoa
from dj_brdf_torch import fresnel as tfres
from dj_brdf_torch.microfacet import brdf as tbrdf
from dj_brdf_torch.microfacet import ndf as tndf
from dj_brdf_torch.microfacet.params import MicrofacetParams as TParams
from dj_brdf_torch.ops import soa as tsoa

DISTS = ["beckmann", "ggx", "caps", "tabular"]
# an anisotropic, off-centre material (the fit's range) and an
# isotropic centred one
PARAMS = [dict(ax=0.35, ay=0.18, rho=0.25, txn=0.06, tyn=-0.04),
          dict(ax=0.5, ay=0.5, rho=0.0, txn=0.0, tyn=0.0)]
F0 = [0.9, 0.6, 0.3]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def t(x):
    return torch.tensor(np.array(x))


def tabular_tables(res=64, seed=5):
    """Monotone tables for the nmap sampler (only ``qf`` is read), a
    smooth p22/sigma for the pdf."""
    rng = np.random.default_rng(seed)
    qf = np.sort(rng.uniform(0, 1, res)).astype(np.float32)
    qf[0], qf[-1] = 0.0, 0.98
    u = np.linspace(0, 1, res, dtype=np.float32)
    p22 = (np.exp(-4 * u * u) / np.pi).astype(np.float32)
    sigma = (1.0 - 0.3 * u).astype(np.float32)
    cdf = np.linspace(0, 1, res, dtype=np.float32)
    return dict(p22=p22, sigma=sigma, cdf=cdf, qf=qf)


def dists(name):
    if name == "tabular":
        tabs = tabular_tables()
        return (jndf.Tabular(**{k: jnp.asarray(v) for k, v in tabs.items()}),
                tndf.Tabular(**{k: torch.from_numpy(v)
                                for k, v in tabs.items()}))
    cls = {"beckmann": "Beckmann", "ggx": "GGX",
           "caps": "GGXSphericalCaps"}[name]
    return getattr(jndf, cls)(), getattr(tndf, cls)()


def directions(n, seed, lo=0.0, hi=1.5):
    rng = np.random.default_rng(seed)
    th = rng.uniform(lo, hi, n)
    ph = rng.uniform(0, 2 * np.pi, n)
    return np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                     np.cos(th)], -1).astype(np.float32)


def uniforms(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (2, n)).astype(np.float32)


def grid():
    """A (u, theta_k) grid away from the clamped tails."""
    u, th = np.meshgrid(np.linspace(0.02, 0.98, 24),
                        np.linspace(0.02, 1.5, 16))
    return u.ravel().astype(np.float32), th.ravel().astype(np.float32)


def test_qf2_value_and_gradient_match_jax():
    """beckmann_qf2_slope_domain's value, and its gradient w.r.t. u and
    cos(theta_k) through the implicit-function backward of the root
    (jax.grad through the JAX custom_jvp)."""
    u, th = grid()

    def jfun(u, c):
        s = jnp.sqrt(jnp.maximum(1.0 - c * c, 1e-24))
        return jndf.beckmann_qf2_slope_domain(u, c, s)

    ju, jc = jnp.asarray(u), jnp.asarray(np.cos(th))
    want = np.asarray(jfun(ju, jc))
    want_gu, want_gc = jax.grad(lambda a, b: jfun(a, b).sum(),
                                argnums=(0, 1))(ju, jc)

    tu = torch.tensor(u, requires_grad=True)
    tc = torch.tensor(np.cos(th), requires_grad=True)
    ts = torch.sqrt(torch.clamp(1.0 - tc * tc, min=1e-24))
    got = tndf.beckmann_qf2_slope_domain(tu, tc, ts)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=2e-6)
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(want_gu),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(want_gc),
                               rtol=1e-4, atol=1e-5)


def test_qf2_root_gradient_matches_finite_differences():
    """The autograd.Function's implicit-function gradient against
    central differences of the converged root, in float64 (interior
    lanes: the ft >= 1e-3 floor only clips the flat tail)."""
    u, th = grid()
    c = torch.tensor(np.cos(th), dtype=torch.float64)
    s = torch.sqrt(torch.clamp(1.0 - c * c, min=1e-24))
    uu = torch.tensor(u, dtype=torch.float64, requires_grad=True)
    root = tndf.beckmann_qf2_slope_domain(uu, c, s, iterations=12)
    (g,) = torch.autograd.grad(root.sum(), uu)
    h = 1e-6
    fd = (tndf.beckmann_qf2_slope_domain(uu.detach() + h, c, s, 12)
          - tndf.beckmann_qf2_slope_domain(uu.detach() - h, c, s, 12)) \
        / (2 * h)
    np.testing.assert_allclose(g.numpy(), fd.numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", DISTS)
def test_sample_vp22_std_matches_jax(name):
    jd, td = dists(name)
    k = directions(512, 1, 0.0, 1.45)
    u1, u2 = uniforms(512, 2)
    want = jd.sample_vp22_std(jnp.asarray(u1), jnp.asarray(u2),
                              jnp.asarray(k))
    got = td.sample_vp22_std(t(u1), t(u2), t(k))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def _params(p):
    return (JParams.pdfparams(**p),
            TParams.pdfparams(**{k: torch.tensor(v) for k, v in p.items()}))


@pytest.mark.parametrize("name", DISTS)
@pytest.mark.parametrize("pi", [0, 1])
def test_sample_pdf_evalp_is_match_jax(name, pi):
    """brdf.sample, pdf and evalp_is with the same u: directions within
    1e-4 and pdf at rtol 1e-4 (f32 chains of ~100 ops on near-grazing
    samples); weights, which are O(1), within 1e-4 absolute (GGX's
    closed-form qf2 multiplies tan and cot terms that are ill
    conditioned near its branch switch: 2 of 3072 weights move by
    2e-5 between the two packages)."""
    jd, td = dists(name)
    jp, tp = _params(PARAMS[pi])
    jf, tf = (jfres.Schlick(f0=jnp.asarray(F0)),
              tfres.Schlick(f0=torch.tensor(F0)))
    o = directions(1024, 3 + pi, 0.0, 1.5)
    u1, u2 = uniforms(1024, 4 + pi)
    args_j = (jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(o))
    args_t = (t(u1), t(u2), t(o))

    i_j = np.asarray(jbrdf.sample(jd, jp, *args_j))
    i_t = tbrdf.sample(td, tp, *args_t)
    np.testing.assert_allclose(i_t.numpy(), i_j, atol=1e-4)

    pdf_j = np.asarray(jbrdf.pdf(jd, jp, jnp.asarray(i_j), jnp.asarray(o)))
    pdf_t = tbrdf.pdf(td, tp, t(i_j), t(o))
    np.testing.assert_allclose(pdf_t.numpy(), pdf_j, rtol=1e-4,
                               atol=1e-6 * pdf_j.max())

    w_j, ii_j, p_j = (np.asarray(x) for x in
                      jbrdf.evalp_is(jd, jf, jp, *args_j))
    w_t, ii_t, p_t = tbrdf.evalp_is(td, tf, tp, *args_t)
    np.testing.assert_allclose(ii_t.numpy(), ii_j, atol=1e-4)
    np.testing.assert_allclose(p_t.numpy(), p_j, rtol=1e-4,
                               atol=1e-6 * p_j.max())
    np.testing.assert_allclose(w_t.numpy(), w_j, rtol=1e-4, atol=1e-4)
    assert (p_t > 0).float().mean() > 0.5


def test_normal_incidence_sampling_not_collapsed():
    """Regression mirroring tests/test_ops.py:549: the floored sin under
    the sqrt means exact normal incidence reads sin_k = 1e-12, never 0,
    so the normal-incidence guard is <= 1e-9; an == 0 test would zero
    the azimuthal frame and collapse every VNDF sample to the mean
    normal. At o = +z the sampled directions must spread."""
    n = 64
    rng = np.random.default_rng(0)
    pv = torch.tensor([0.5, 0.5, 0.0, 0.0, 0.0, 0.9, 0.6, 0.3])
    z, o1 = torch.zeros(n), torch.ones(n)
    u1 = torch.tensor(rng.uniform(0.05, 0.95, n), dtype=torch.float32)
    u2 = torch.tensor(rng.uniform(0.05, 0.95, n), dtype=torch.float32)
    for kernel in (lambda: tsoa.ggx_evalp_is_soa(pv, u1, u2, z, z, o1,
                                                 caps=False),
                   lambda: tsoa.beckmann_evalp_is_soa(pv, u1, u2, z, z, o1),
                   lambda: tsoa.mixed_nee_evalp_is_soa(
                       pv, torch.arange(n) % 2 == 0, z, z, o1, u1, u2,
                       z, z, o1)[-7:]):
        out = kernel()
        ixy = torch.stack([out[3], out[4]], -1).numpy()
        assert np.abs(ixy).max() > 0.05, "samples collapsed to +z"
        assert np.unique(np.round(ixy, 4), axis=0).shape[0] > n // 2
    # layered path too
    i_l = tbrdf.sample(tndf.Beckmann(), TParams.isotropic(0.5), u1, u2,
                       torch.stack([z, z, o1], -1))
    assert float(i_l[:, :2].abs().max()) > 0.05
    # and the JAX package agrees on the very samples
    want = jsoa.beckmann_evalp_is_soa(jnp.asarray(pv.numpy()),
                                      jnp.asarray(u1.numpy()),
                                      jnp.asarray(u2.numpy()),
                                      jnp.zeros(n), jnp.zeros(n),
                                      jnp.ones(n))
    got = tsoa.beckmann_evalp_is_soa(pv, u1, u2, z, z, o1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
