"""Port parity, tabulation: dj_brdf_torch.microfacet.ndf.Tabular,
fit.tabular, fit.moments, fit.batch.tabulate_merl_batch and
cli.merl_params against the JAX package on the same baked MERL tables.
Tolerances are those of the JAX package's own batch-vs-sequential test
(tests/test_batch_ckpt.py): p22 rtol 2e-5, qf atol 1e-6, Fresnel points
rtol 1e-4 atol 1e-5, alphas rtol 1e-5. Tables also get atol 1e-30: the
tail of a Beckmann p22 underflows to f32 denormals (~1e-36), where
there are no relative digits left to compare."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dj_brdf_tpu import fresnel as jfres
from dj_brdf_tpu.cli import merl_params as jcli
from dj_brdf_tpu.fit import batch as jbatch
from dj_brdf_tpu.fit import moments as jmom
from dj_brdf_tpu.fit import tabular as jtab
from dj_brdf_tpu.io import synth as jsynth
from dj_brdf_tpu.io.merl_io import save_merl
from dj_brdf_tpu.microfacet import brdf as jmf
from dj_brdf_tpu.microfacet import ndf as jndf
from dj_brdf_tpu.microfacet.params import MicrofacetParams as JParams
from dj_brdf_tpu.models.merl import Merl as JMerl
from dj_brdf_torch import convert
from dj_brdf_torch.core.pytree import tree_leaves
from dj_brdf_torch.fit import batch as tbatch
from dj_brdf_torch.fit import moments as tmom
from dj_brdf_torch.fit import tabular as ttab
from dj_brdf_torch.microfacet import ndf as tndf
from dj_brdf_torch.models.merl import Merl as TMerl
from dj_brdf_torch.parallel.mesh import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P22_RTOL, QF_ATOL, FRES_RTOL, FRES_ATOL, ALPHA_RTOL = 2e-5, 1e-6, 1e-4, 1e-5, 1e-5
TINY = 1e-30


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


def jax_material(dist, alpha, f0):
    def eval_fn(i, o):
        return jmf.eval(dist, jfres.Schlick(f0=jnp.asarray(f0, jnp.float32)),
                        JParams.isotropic(alpha), i, o)
    return eval_fn


@pytest.fixture(scope="module")
def tables():
    """Raw float32 tables baked by the JAX package: GGX alpha 0.3 and
    Beckmann alpha 0.15, Schlick Fresnel."""
    return np.stack([
        jsynth.bake_merl(jax_material(jndf.GGX(), 0.3, [0.9, 0.6, 0.3])),
        jsynth.bake_merl(jax_material(jndf.Beckmann(), 0.15, [0.5, 0.5, 0.5])),
    ]).astype(np.float32)


def tensor(x):
    """A JAX or numpy array as a torch tensor of its own (JAX's numpy
    views are read-only)."""
    return torch.tensor(np.asarray(x))


def check(got, want, rtol=0.0, atol=TINY):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def random_tabular(rng, res=24):
    p22 = np.concatenate([np.sort(rng.uniform(0.1, 2.0, res - 1))[::-1], [0.0]])
    sigma = np.linspace(1.0, 2.5, res) + rng.uniform(0, 0.1, res)
    cdf = np.concatenate([np.sort(rng.uniform(0, 1, res - 1)), [1.0]])
    qf = np.concatenate([[0.0], np.sort(rng.uniform(0, 1, res - 2)), [1.0]])
    arrays = [a.astype(np.float32) for a in (p22, sigma, cdf, qf)]
    return (jndf.Tabular(*[jnp.asarray(a) for a in arrays]),
            tndf.Tabular(*[torch.from_numpy(a) for a in arrays]))


@pytest.mark.parametrize("query", ["p22_radial", "sigma_std_radial",
                                   "cdf_radial", "qf_radial", "p22_std",
                                   "sigma_std"])
def test_tabular_queries_match_jax(query):
    rng = np.random.default_rng(0)
    jd, td = random_tabular(rng)
    if query in ("p22_std", "sigma_std"):
        x = rng.normal(size=(500, 3)).astype(np.float32)
        x[:, 2] = np.abs(x[:, 2])
        if query == "sigma_std":
            x /= np.linalg.norm(x, axis=-1, keepdims=True)
            args = (x,)
        else:
            args = (x[:, 0], x[:, 1])
    elif query == "sigma_std_radial":
        args = (rng.uniform(-1.0, 1.0, 500).astype(np.float32),)
    elif query == "qf_radial":
        args = (rng.uniform(0.0, 0.999, 500).astype(np.float32),)
    else:
        args = (rng.uniform(0.0, 20.0, 500).astype(np.float32),)
    want = getattr(jd, query)(*[jnp.asarray(a) for a in args])
    got = getattr(td, query)(*[torch.from_numpy(a) for a in args])
    # the radial queries take the same argument in both packages: rtol
    # 1e-6; p22_std/sigma_std first form x*x + y*y (or read k.z), where
    # XLA may contract into an FMA what PyTorch rounds twice: 1e-5
    check(got, want, rtol=1e-6 if query.endswith("radial") else 1e-5,
          atol=1e-7)
    assert td.supports_smith_vndf is False


def test_tabular_stack_answers_per_table():
    rng = np.random.default_rng(1)
    (_, a), (_, b) = random_tabular(rng), random_tabular(rng)
    stack = tndf.Tabular(*(torch.stack([getattr(a, k), getattr(b, k)])
                           for k in ("p22", "sigma", "cdf", "qf")))
    r = torch.rand(7, 5, generator=torch.Generator().manual_seed(0)) * 4
    got = stack.p22_radial(r)
    assert got.shape == (2, 7, 5)
    assert torch.equal(got[0], a.p22_radial(r))
    assert torch.equal(got[1], b.p22_radial(r))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_phi_grid_is_identical(dtype):
    want = jtab._phi_grid(np.dtype(dtype))
    got = ttab._phi_grid(getattr(torch, dtype))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("res", [24, 90])
def test_stages_match_jax(tables, res):
    """Each stage fed the JAX package's output of the stage before it
    (the JAX stages jitted, as build_tabular runs them)."""
    jm, tm = JMerl(table=jnp.asarray(tables[0])), \
        TMerl(table=torch.from_numpy(tables[0]))
    jeval, _ = jtab.as_model_eval(jm)
    teval, _ = ttab.as_model_eval(tm)
    jK = np.asarray(jax.jit(lambda m: jtab._kernel_matrix(jeval, m, res))(jm))
    check(ttab._kernel_matrix(teval, tm, res), jK, rtol=2e-5,
          atol=1e-7 * np.abs(jK).max())
    jraw = jtab._power_iteration(jK)
    check(ttab._power_iteration(torch.tensor(jK)), jraw, rtol=1e-6)
    jp22 = jax.jit(jtab.normalize_p22)(jraw)
    check(ttab.normalize_p22(tensor(jraw)), jp22, rtol=P22_RTOL)
    jsig = jax.jit(jtab.compute_sigma)(jp22)
    check(ttab.compute_sigma(tensor(jp22)), jsig, rtol=P22_RTOL)
    jfres_pts = jax.jit(lambda m, p, s: jtab.compute_fresnel(m, p, s, res))(
        jm, jp22, jsig)
    check(ttab.compute_fresnel(tm, tensor(jp22), tensor(jsig), res),
          jfres_pts, rtol=FRES_RTOL, atol=FRES_ATOL)
    jcdf = jax.jit(jtab.compute_cdf)(jp22)
    check(ttab.compute_cdf(tensor(jp22)), jcdf, rtol=P22_RTOL, atol=1e-7)
    check(ttab.compute_qf(tensor(jcdf)), jax.jit(jtab.compute_qf)(jcdf),
          atol=QF_ATOL)
    # compute_p22_smith is the kernel build plus the iteration
    check(ttab.compute_p22_smith(tm, res), jraw, rtol=P22_RTOL)


@pytest.mark.parametrize("res", [24, 90])
@pytest.mark.parametrize("k", [0, 1], ids=["ggx", "beckmann"])
def test_build_tabular_matches_jax(tables, res, k):
    jd, jf = jtab.build_tabular(JMerl(table=jnp.asarray(tables[k])), res)
    td, tf = ttab.build_tabular(TMerl(table=torch.from_numpy(tables[k])), res)
    got, want = convert.tabular_to_numpy(td), convert.tabular_from_jax(jd)
    check(td.p22, jd.p22, rtol=P22_RTOL)
    check(td.sigma, jd.sigma, rtol=P22_RTOL)
    check(td.cdf, jd.cdf, rtol=P22_RTOL, atol=1e-7)
    check(td.qf, jd.qf, atol=QF_ATOL)
    check(tf.points, jf.points, rtol=FRES_RTOL, atol=FRES_ATOL)
    assert set(got) == {"p22", "sigma", "cdf", "qf"}
    assert torch.equal(want.qf, tensor(jd.qf))
    for fit in ("fit_beckmann_parameters", "fit_ggx_parameters"):
        check(getattr(tmom, fit)(td).ax, getattr(jmom, fit)(jd).ax,
              rtol=ALPHA_RTOL)
        # the moments of the JAX tables, through the port
        check(getattr(tmom, fit)(want).ax, getattr(jmom, fit)(jd).ax,
              rtol=1e-6)


def test_build_tabular_of_an_eval_function_matches_jax():
    """A bare eval function (no tables) tabulates on the device asked for,
    here the CPU."""
    res = 24
    jd, _ = jtab.build_tabular(jtab.microfacet_eval_fn(
        jndf.GGX(), jfres.Schlick(f0=jnp.asarray([0.9, 0.6, 0.3])),
        JParams.isotropic(0.4)), res)
    from dj_brdf_torch import fresnel as tfres
    from dj_brdf_torch.microfacet.params import MicrofacetParams as TParams
    td, _ = ttab.build_tabular(ttab.microfacet_eval_fn(
        tndf.GGX(), tfres.Schlick(f0=torch.tensor([0.9, 0.6, 0.3])),
        TParams.isotropic(0.4)), res, device="cpu")
    check(td.p22, jd.p22, rtol=P22_RTOL)
    check(td.qf, jd.qf, atol=QF_ATOL)


@pytest.mark.parametrize("dist", ["GGX", "Beckmann"])
def test_moments_of_analytic_distributions_match_jax(dist):
    for fit in ("fit_beckmann_parameters", "fit_ggx_parameters"):
        check(getattr(tmom, fit)(getattr(tndf, dist)()).ax,
              getattr(jmom, fit)(getattr(jndf, dist)()).ax, rtol=ALPHA_RTOL)


def test_tabulate_merl_batch_matches_jax(tables):
    res = 90
    jd, jf, jab, jag = jbatch.tabulate_merl_batch(jnp.asarray(tables), res)
    td, tf, tab_, tag = tbatch.tabulate_merl_batch(torch.from_numpy(tables),
                                                   res)
    assert td.p22.shape == (2, res) and tf.shape == (2, res, 3)
    assert tab_.shape == tag.shape == (2,)
    check(td.p22, jd.p22, rtol=P22_RTOL)
    check(td.qf, jd.qf, atol=QF_ATOL)
    check(tf, jf, rtol=FRES_RTOL, atol=FRES_ATOL)
    check(tab_, jab, rtol=ALPHA_RTOL)
    check(tag, jag, rtol=ALPHA_RTOL)
    # the reference behaviour the fits rest on: GGX 0.3 -> 0.2874,
    # Beckmann 0.15 -> 0.1498 (JAX package, CPU)
    np.testing.assert_allclose([tag[0], tab_[1]], [0.2874, 0.1498], atol=5e-4)


def test_tabulate_merl_batch_is_per_table_build_tabular(tables, world_one):
    res = 24
    td, tf, tab_, tag = tbatch.tabulate_merl_batch(torch.from_numpy(tables),
                                                   res)
    for k in range(2):
        d, f = ttab.build_tabular(TMerl(table=torch.from_numpy(tables[k])),
                                  res)
        check(td.p22[k], d.p22, rtol=1e-6)
        check(td.qf[k], d.qf, atol=QF_ATOL)
        check(tf[k], f.points, rtol=1e-6, atol=1e-7)
        check(tag[k], tmom.fit_ggx_parameters(d).ax, rtol=1e-6)
    # the material axis over a world of one (gloo, in-process) gives the
    # same tables bit for bit (2 and 4 ranks: tests/test_torch_mesh.py)
    got = tbatch.tabulate_merl_batch(torch.from_numpy(tables), res,
                                     mesh=world_one)
    for g, w in zip(tree_leaves(got), tree_leaves((td, tf, tab_, tag))):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def merl_files(tables, tmp_path_factory):
    root = tmp_path_factory.mktemp("merl")
    paths = []
    for name, table in zip(("ggx-0.3", "beckmann-0.15"), tables):
        paths.append(str(root / f"{name}.binary"))
        save_merl(paths[-1], table)
    return paths


def run_port_cli(*args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run(
        [sys.executable, "-m", "dj_brdf_torch.cli.merl_params", *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


def read_params(path):
    lines = open(path).read().splitlines()
    assert lines[0] == "# MERL Beckmann GGX"
    return [(n, float(b), float(g)) for n, b, g in
            (line.split() for line in lines[1:])]


def test_cli_matches_jax(merl_files, tmp_path):
    tout, jout = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    r = run_port_cli("--device", "cpu", "-o", tout, *merl_files)
    assert r.returncode == 0, r.stderr
    assert "tabulated 2 materials" in r.stderr
    assert jcli.main(["-o", jout, *merl_files]) == 0
    got, want = read_params(tout), read_params(jout)
    assert [g[0] for g in got] == [w[0] for w in want] == [
        "ggx-0.3", "beckmann-0.15"]
    np.testing.assert_allclose([g[1:] for g in got], [w[1:] for w in want],
                               atol=1e-3 + 1e-9)


@pytest.mark.skipif("torch.cuda.is_available()",
                    reason="checks the refusal on a machine without CUDA")
def test_cli_refuses_a_missing_device_and_mesh(merl_files, tmp_path):
    from dj_brdf_torch.cli import merl_params as tcli

    out = str(tmp_path / "p.txt")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["-o", out, merl_files[0]])      # --device cuda by default
    # a mesh of 2 needs 2 processes, which torchrun starts
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        tcli.main(["--device", "cpu", "--mesh", "2", "-o", out,
                   merl_files[0]])
    assert not os.path.exists(out)
