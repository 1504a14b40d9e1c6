"""Port parity, LEAN: the Lrep algebra, the array-form map builders
(displacement -> normals -> moments, the mip pyramid with its odd-size
stop) and the filtered Beckmann-conductor material with its per-hit
provider, against the JAX package on the same inputs.

Tolerances: the Lrep algebra and the maps are a handful of f32 ops (rtol
1e-6); conversions through sqrt and the material's sampled weights at
the f32 tolerances of ``test_torch_render.py`` (directions and weights
1e-4, the pdf rtol 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dj_brdf_tpu.lean import filtered as jfilt
from dj_brdf_tpu.lean import lrep as jlrep
from dj_brdf_tpu.lean import maps as jmaps
from dj_brdf_tpu.microfacet.params import MicrofacetParams as JParams
from dj_brdf_torch import convert
from dj_brdf_torch.lean import filtered as tfilt
from dj_brdf_torch.lean import lrep as tlrep
from dj_brdf_torch.lean import maps as tmaps
from dj_brdf_torch.microfacet.params import MicrofacetParams as TParams

ETA = [0.143, 0.375, 1.442]
K = [3.983, 2.386, 1.603]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def t(x):
    return torch.tensor(np.array(x))


def fields(x, names=("E1", "E2", "E3", "E4", "E5")):
    return [np.asarray(getattr(x, k)) for k in names]


def close_fields(got, want, names=("E1", "E2", "E3", "E4", "E5"),
                 rtol=1e-6, atol=1e-7):
    for k in names:
        np.testing.assert_allclose(np.asarray(getattr(got, k)),
                                   np.asarray(getattr(want, k)), rtol=rtol,
                                   atol=atol, err_msg=k)


def moments(shape, seed):
    rng = np.random.default_rng(seed)
    e1, e2 = rng.normal(0, 0.2, (2,) + shape).astype(np.float32)
    e3 = (e1 * e1 + rng.uniform(0.01, 0.1, shape)).astype(np.float32)
    e4 = (e2 * e2 + rng.uniform(0.01, 0.1, shape)).astype(np.float32)
    e5 = (e1 * e2 + rng.uniform(-0.01, 0.01, shape)).astype(np.float32)
    return e1, e2, e3, e4, e5


def pair(shape, seed):
    m = moments(shape, seed)
    return (jlrep.Lrep(*map(jnp.asarray, m)),
            tlrep.Lrep(*map(torch.from_numpy, m)))


# --------------------------------------------------------------- lrep

@pytest.mark.parametrize("op", ["add", "mul", "rmul", "shear", "scale_xy",
                                "reparameterize", "mean", "identity"])
def test_lrep_algebra_matches_jax(op):
    ja, ta = pair((6, 7), 1)
    jb, tb = pair((6, 7), 2)
    if op == "add":
        want, got = ja + jb, ta + tb
    elif op == "mul":
        want, got = ja * 0.7, ta * 0.7
    elif op == "rmul":
        want, got = 1.3 * ja, 1.3 * ta
    elif op == "shear":
        want, got = ja.shear(0.1, -0.2), ta.shear(0.1, -0.2)
    elif op == "scale_xy":
        want, got = ja.scale_xy(0.5, 2.0), ta.scale_xy(0.5, 2.0)
    elif op == "reparameterize":
        want = ja.reparameterize(0.9, 0.1, -0.2, 1.1)
        got = ta.reparameterize(0.9, 0.1, -0.2, 1.1)
    elif op == "mean":
        close_fields(ta.mean(dim=0), ja.mean(axis=0))
        want, got = ja.mean(), ta.mean()
    else:
        want, got = jlrep.Lrep.identity((3,)), tlrep.Lrep.identity((3,))
    close_fields(got, want)


def test_params_lrep_conversions_match_jax():
    rng = np.random.default_rng(3)
    p = [rng.uniform(0.05, 0.8, 64), rng.uniform(0.05, 0.8, 64),
         rng.uniform(-0.9, 0.9, 64), rng.normal(0, 0.2, 64),
         rng.normal(0, 0.2, 64)]
    p = [x.astype(np.float32) for x in p]
    names = ("ax", "ay", "rho", "txn", "tyn")
    jl = jlrep.params_to_lrep(JParams(*map(jnp.asarray, p)))
    tl = tlrep.params_to_lrep(TParams(*map(torch.from_numpy, p)))
    close_fields(tl, jl)
    close_fields(tlrep.lrep_to_params(tl), jlrep.lrep_to_params(jl), names,
                 rtol=2e-6, atol=1e-6)
    # the validity clamps: degenerate variance, |rho| beyond 0.99
    ja, ta = pair((64,), 4)
    ja = ja.replace(E3=ja.E1 * ja.E1, E5=ja.E5 * 40.0)
    ta = ta.replace(E3=ta.E1 * ta.E1, E5=ta.E5 * 40.0)
    close_fields(tlrep.lrep_to_params(ta), jlrep.lrep_to_params(ja), names,
                 rtol=2e-6, atol=1e-6)


# --------------------------------------------------------------- maps

@pytest.mark.parametrize("clamp", [False, True])
def test_map_builders_match_jax(clamp):
    rng = np.random.default_rng(5)
    dmap = rng.uniform(0, 1, (12, 20)).astype(np.float32)
    want = jmaps.dmap_to_nmap(jnp.asarray(dmap), 0.1, clamp)
    got = tmaps.dmap_to_nmap(t(dmap), 0.1, clamp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    for bias in (0.0, tmaps.LEAN_BIAS):
        jl = jmaps.nmap_to_lean(want, 0.1, bias)
        tl = tmaps.nmap_to_lean(got, 0.1, bias)
        close_fields(tl, jl, rtol=1e-6, atol=1e-5)
        close_fields(tmaps.unbias(tl), jmaps.unbias(jl), rtol=1e-5,
                     atol=1e-4)


@pytest.mark.parametrize("shape,levels", [((16, 16), 5), ((12, 20), 3),
                                          ((8, 3), 1)])
def test_mip_pyramid_matches_jax(shape, levels):
    """2x2 moment means per level; the pyramid stops at 1x1 or at the
    first odd extent (12x20 -> 6x10 -> 3x5)."""
    ja, ta = pair(shape, 6)
    jp = jmaps.build_mip_pyramid(ja)
    tp = tmaps.build_mip_pyramid(ta)
    assert len(tp) == len(jp) == levels
    for g, w in zip(tp, jp):
        assert tuple(g.E1.shape) == w.E1.shape
        close_fields(g, w, rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------- filtered

def materials(shape=(), mip_lod=False, **kw):
    m = moments(shape, 7) if shape else [np.float32(x) for x in
                                         (0.2, 0.1, 0.06, 0.04, 0.04)]
    jm = jfilt.FilteredBeckmannMaterial(
        lean=jlrep.Lrep(*map(jnp.asarray, m)),
        base_params=JParams.isotropic(jnp.float32(0.2)),
        eta=jnp.asarray(ETA), k=jnp.asarray(K), mip_lod=mip_lod, **kw)
    return jm, convert.material_from_jax(jm)


@pytest.mark.parametrize("kw", [{}, {"lean_filtering": False},
                                {"biased": True},
                                {"dmap_scale": jnp.float32(0.6)}])
def test_filtered_params_match_jax(kw):
    jm, tm = materials((5, 6), **kw)
    assert tm.lean_filtering == jm.lean_filtering
    close_fields(tm.params(), jm.params(), ("ax", "ay", "rho", "txn", "tyn"),
                 rtol=2e-6, atol=1e-6)


def directions(n, seed):
    rng = np.random.default_rng(seed)
    th = rng.uniform(0.01, 1.5, (2, n))
    ph = rng.uniform(0, 2 * np.pi, (2, n))
    d = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                  np.cos(th)], -1).astype(np.float32)
    return d[0], d[1], rng.uniform(0, 1, (2, n)).astype(np.float32)


def test_filtered_material_matches_jax():
    """evalp (conductor Fresnel on the Beckmann lobe), pdf, sample and
    evalp_is of the uniform material."""
    jm, tm = materials()
    o, i, u = directions(1024, 8)
    np.testing.assert_allclose(tm.evalp(t(i), t(o)).numpy(),
                               np.asarray(jm.evalp(i, o)), rtol=2e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tm.pdf(t(i), t(o)).numpy(),
                               np.asarray(jm.pdf(i, o)), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(tm.sample(*map(t, u), t(o)).numpy(),
                               np.asarray(jm.sample(*u, o)), atol=1e-4)
    for g, w in zip(tm.evalp_is(*map(t, u), t(o)), jm.evalp_is(*u, o)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("mip_lod", [False, True])
def test_filtered_provider_matches_jax(mip_lod):
    """pvec_provider: the packed moments (the flattened pyramid with
    mip_lod), the texel index at per-lane LODs (round half to even
    included) and the assembled (8, N) pvec."""
    jm, tm = materials((16, 16), mip_lod=mip_lod)
    jp, tp = jm.pvec_provider(), tm.pvec_provider()
    assert tp.wants_lod == jp.wants_lod == mip_lod
    np.testing.assert_array_equal(tp.packed.numpy(), np.asarray(jp.packed))
    np.testing.assert_array_equal(tp.neutral.numpy(), np.asarray(jp.neutral))
    rng = np.random.default_rng(9)
    uu, vv = rng.uniform(0, 1, (2, 512)).astype(np.float32)
    uu[:2], vv[:2] = [0.0, 1.0], [1.0, 0.0]
    lod = rng.uniform(-2, 7, 512).astype(np.float32)
    lod[2:6] = [0.5, 1.5, 2.5, -0.5]
    for lv in (None, lod):
        want = jp.index(jnp.asarray(uu), jnp.asarray(vv),
                        None if lv is None else jnp.asarray(lv))
        got = tp.index(t(uu), t(vv), None if lv is None else t(lv))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rows = np.asarray(jp.packed)[np.asarray(want)]
    np.testing.assert_allclose(tp.assemble(t(rows)).numpy(),
                               np.asarray(jp.assemble(jnp.asarray(rows))),
                               rtol=2e-6, atol=1e-6)


def test_filtered_params_gradient_matches_jax():
    """d/d E1 map of the assembled parameters' sum, against jax.grad."""
    m = moments((4, 5), 10)

    def jf(e1):
        p = jfilt.filtered_params(jlrep.Lrep(e1, *map(jnp.asarray, m[1:])),
                                  JParams.isotropic(jnp.float32(0.2)))
        return (p.ax + 2 * p.ay + 3 * p.rho + p.txn).sum()

    want = jax.grad(jf)(jnp.asarray(m[0]))
    e1 = torch.tensor(m[0], requires_grad=True)
    p = tfilt.filtered_params(tlrep.Lrep(e1, *map(torch.from_numpy, m[1:])),
                              TParams.isotropic(torch.tensor(0.2)))
    (p.ax + 2 * p.ay + 3 * p.rho + p.txn).sum().backward()
    np.testing.assert_allclose(e1.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
