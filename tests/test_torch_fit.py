"""Port parity, fit layer: dj_brdf_torch.fit.lsq / fit.batch and convert
against the JAX package, from the same initial parameters and data."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dj_brdf_tpu import fresnel as jfres
from dj_brdf_tpu.fit import batch as jbatch
from dj_brdf_tpu.fit import lsq as jlsq
from dj_brdf_tpu.microfacet import brdf as jmf
from dj_brdf_tpu.microfacet import ndf as jndf
from dj_brdf_tpu.microfacet.params import MicrofacetParams as JParams
from dj_brdf_torch import convert
from dj_brdf_torch import fresnel as tfres
from dj_brdf_torch.core.pytree import tree_leaves
from dj_brdf_torch.fit import batch as tbatch
from dj_brdf_torch.fit import lsq as tlsq
from dj_brdf_torch.microfacet import brdf as tmf
from dj_brdf_torch.microfacet import ndf as tndf
from dj_brdf_torch.microfacet.params import MicrofacetParams as TParams
from dj_brdf_torch.parallel.mesh import make_mesh

FAMILIES = {"ggx": "GGX", "beck": "Beckmann"}
TRUE_F0 = np.asarray([0.9, 0.6, 0.3], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def world_one():
    """A mesh over a world of one (gloo, in-process), destroyed after
    the test so that no later mesh in this process finds it."""
    mesh = make_mesh(1, "cpu")
    yield mesh
    dist.destroy_process_group()


def hemi_dirs(rng, n):
    th = rng.uniform(0.02, 1.5, n)
    ph = rng.uniform(0, 2 * np.pi, n)
    return np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                     np.cos(th)], -1).astype(np.float32)


def problem(family, n=4096, seed=0):
    """Directions and the JAX package's evalp of an anisotropic,
    off-centre truth, as numpy."""
    rng = np.random.default_rng(seed)
    i, o = hemi_dirs(rng, n), hemi_dirs(rng, n)
    target = jmf.evalp(getattr(jndf, FAMILIES[family])(),
                       jfres.Schlick(f0=jnp.asarray(TRUE_F0)),
                       JParams.elliptic(0.3, 0.15, 0.4, txn=0.05),
                       jnp.asarray(i), jnp.asarray(o))
    return i, o, np.array(target)


def jax_init():
    raw = jlsq.raw_init(0.4, 0.6)
    return raw._replace(raw_rho=jnp.float32(0.1), txn=jnp.float32(-0.02),
                        logit_f0=jnp.asarray([0.3, 0.1, -0.4], jnp.float32))


@pytest.mark.parametrize("family", ["ggx", "beck"])
def test_fit_lsq_trajectory_matches_jax(family):
    i, o, target = problem(family)
    raw = jax_init()
    jp, jf, jl = jlsq.fit_lsq(getattr(jndf, FAMILIES[family])(),
                              jnp.asarray(i), jnp.asarray(o),
                              jnp.asarray(target), steps=20, init=raw)
    tp, tf, tl = tlsq.fit_lsq(
        getattr(tndf, FAMILIES[family])(), torch.from_numpy(i),
        torch.from_numpy(o), torch.from_numpy(target), steps=20,
        init=convert.raw_from_jax(raw))
    assert tl.shape == (20,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-7)
    got = convert.params_to_numpy(tp)
    for k, v in got.items():
        np.testing.assert_allclose(v, np.asarray(getattr(jp, k)),
                                   rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(convert.fresnel_to_numpy(tf)["f0"],
                               np.asarray(jf.f0), rtol=1e-4)


@pytest.mark.parametrize("family", ["ggx", "beck"])
def test_fit_lsq_fused_matches_layered(family):
    i, o, target = problem(family, n=2048, seed=1)
    args = (getattr(tndf, FAMILIES[family])(), torch.from_numpy(i),
            torch.from_numpy(o), torch.from_numpy(target))
    init = convert.raw_from_jax(jax_init())
    _, _, l_auto = tlsq.fit_lsq(*args, steps=20, init=init)
    _, _, l_never = tlsq.fit_lsq(*args, steps=20, init=init, fused="never")
    np.testing.assert_allclose(l_auto.numpy(), l_never.numpy(), rtol=1e-3)


def test_fit_lsq_rejects_unknown_fused():
    i, o, target = (torch.zeros((4, 3)),) * 3
    with pytest.raises(ValueError):
        tlsq.fit_lsq(tndf.GGX(), i, o, target, steps=1, fused="always")


def _batch_targets(family, alphas, f0s, i, o):
    dist = getattr(jndf, FAMILIES[family])()
    return np.stack([np.array(jmf.evalp(
        dist, jfres.Schlick(f0=jnp.asarray(f0)), JParams.isotropic(a),
        jnp.asarray(i), jnp.asarray(o))) for a, f0 in zip(alphas, f0s)])


@pytest.mark.parametrize("family", ["ggx", "beck"])
def test_fit_materials_matches_jax(family):
    rng = np.random.default_rng(2)
    i, o = hemi_dirs(rng, 2048), hemi_dirs(rng, 2048)
    alphas = [0.15, 0.35, 0.6]
    f0s = np.asarray([[0.9, 0.6, 0.3], [0.5, 0.5, 0.5], [0.2, 0.4, 0.8]],
                     np.float32)
    targets = _batch_targets(family, alphas, f0s, i, o)
    jp, jf, jl = jbatch.fit_materials(
        jnp.asarray(targets), jnp.asarray(i), jnp.asarray(o), steps=30,
        dist=getattr(jndf, FAMILIES[family])())
    tp, tf, tl = tbatch.fit_materials(
        torch.from_numpy(targets), torch.from_numpy(i), torch.from_numpy(o),
        steps=30, dist=getattr(tndf, FAMILIES[family])())
    assert tl.shape == (3,) and tp.ax.shape == (3,) and tf.f0.shape == (3, 3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3)
    np.testing.assert_allclose(tp.ax.numpy(), np.asarray(jp.ax), rtol=1e-3)


def test_fit_materials_recovers_materials():
    """Mirror of the JAX package's batch recovery test."""
    i, o = tbatch.sample_direction_set(2048, torch.Generator().manual_seed(0),
                                       "cpu")
    alphas = torch.tensor([0.15, 0.35, 0.6])
    f0s = torch.tensor([[0.9, 0.6, 0.3], [0.5, 0.5, 0.5], [0.2, 0.4, 0.8]])
    targets = torch.stack([tmf.evalp(tndf.GGX(), tfres.Schlick(f0=f0),
                                     TParams.isotropic(a), i, o)
                           for a, f0 in zip(alphas, f0s)])
    params, fres, losses = tbatch.fit_materials(targets, i, o, steps=300)
    np.testing.assert_allclose(params.ax.numpy(), alphas.numpy(), rtol=0.08)
    np.testing.assert_allclose(fres.f0.numpy(), f0s.numpy(), atol=0.08)
    assert float(losses.max()) < 5e-3


def test_fit_materials_layered_matches_fused():
    rng = np.random.default_rng(3)
    i, o = hemi_dirs(rng, 1024), hemi_dirs(rng, 1024)
    targets = torch.from_numpy(_batch_targets(
        "ggx", [0.2, 0.5], np.asarray([[0.9, 0.6, 0.3]] * 2, np.float32),
        i, o))
    ti, to = torch.from_numpy(i), torch.from_numpy(o)
    pa, _, la = tbatch.fit_materials(targets, ti, to, steps=20)
    pn, _, ln = tbatch.fit_materials(targets, ti, to, steps=20,
                                     fused="never")
    np.testing.assert_allclose(la.numpy(), ln.numpy(), rtol=1e-3)
    np.testing.assert_allclose(pa.ax.numpy(), pn.ax.numpy(), rtol=1e-3)


def test_fit_materials_rejects_mesh_and_unknown_fused(world_one):
    """``mesh=`` over a world of one (gloo, in-process) gives the
    unsharded fit bit for bit (2 and 4 ranks: tests/test_torch_mesh.py);
    an unknown ``fused`` raises."""
    rng = np.random.default_rng(4)
    i, o = hemi_dirs(rng, 256), hemi_dirs(rng, 256)
    targets = torch.from_numpy(_batch_targets(
        "ggx", [0.2, 0.5, 0.3], np.asarray([[0.9, 0.6, 0.3]] * 3,
                                           np.float32), i, o))
    ti, to = torch.from_numpy(i), torch.from_numpy(o)
    want = tbatch.fit_materials(targets, ti, to, steps=5)
    got = tbatch.fit_materials(targets, ti, to, steps=5,
                               mesh=world_one)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(g, w)
    targets, i = torch.zeros((2, 4, 3)), torch.zeros((4, 3))
    with pytest.raises(ValueError):
        tbatch.fit_materials(targets, i, i, steps=1, fused="sometimes")


def test_sample_direction_set():
    i, o = tbatch.sample_direction_set(4096, torch.Generator().manual_seed(5),
                                       "cpu")
    i2, _ = tbatch.sample_direction_set(4096,
                                        torch.Generator().manual_seed(5),
                                        "cpu")
    assert torch.equal(i, i2)
    for d in (i, o):
        assert d.shape == (4096, 3) and d.dtype == torch.float32
        torch.testing.assert_close(d.norm(dim=-1), torch.ones(4096))
        theta = torch.arccos(d[:, 2])
        assert float(theta.min()) >= 0.03 - 1e-4
        assert float(theta.max()) <= 1.5 + 1e-4


def test_raw_init_and_raw_to_model_match_jax():
    jraw = jlsq.raw_init(0.25, 0.7)
    traw = tlsq.raw_init(0.25, 0.7, "cpu")
    for k, v in convert.raw_to_numpy(traw).items():
        np.testing.assert_allclose(v, np.asarray(getattr(jraw, k)),
                                   rtol=1e-6)
    raw = jax_init()
    jp, jf = jlsq.raw_to_model(raw)
    tp, tf = tlsq.raw_to_model(convert.raw_from_jax(raw))
    for k, v in convert.params_to_numpy(tp).items():
        np.testing.assert_allclose(v, np.asarray(getattr(jp, k)), rtol=1e-6)
    np.testing.assert_allclose(tf.f0.numpy(), np.asarray(jf.f0), rtol=1e-6)


def test_convert_roundtrips_with_batch_axes():
    rng = np.random.default_rng(4)
    raw = {k: rng.normal(size=(5,)).astype(np.float32)
           for k in ("log_ax", "log_ay", "raw_rho", "txn", "tyn")}
    raw["logit_f0"] = rng.normal(size=(5, 3)).astype(np.float32)
    back = convert.raw_to_numpy(convert.raw_from_jax(raw))
    for k, v in raw.items():
        np.testing.assert_array_equal(back[k], v)
    jraw = jax.vmap(lambda _: jax_init())(jnp.arange(5))
    traw = convert.raw_from_jax(jraw)
    assert traw.logit_f0.shape == (5, 3) and traw.log_ax.shape == (5,)

    jp = JParams.elliptic(jnp.asarray([0.3, 0.5]), 0.2, 0.4, txn=0.1)
    tp = convert.params_from_jax(jp)
    for k, v in convert.params_to_numpy(tp).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jp, k)))
    jf = jfres.Schlick(f0=jnp.asarray(TRUE_F0))
    np.testing.assert_array_equal(
        convert.fresnel_to_numpy(convert.fresnel_from_jax(jf))["f0"],
        TRUE_F0)
