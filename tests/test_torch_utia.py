"""Port parity, UTIA data: dj_brdf_torch.models.utia, io.utia_io,
io.synth.bake_utia, parallel.integrals and cli.nrm_utia against the JAX
package on the same numpy inputs (f32)."""

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
from dj_brdf_tpu.io import synth as jsynth
from dj_brdf_tpu.io import utia_io as jio
from dj_brdf_tpu.microfacet import brdf as jmf
from dj_brdf_tpu.microfacet import ndf as jndf
from dj_brdf_tpu.microfacet.params import MicrofacetParams as JParams
from dj_brdf_tpu.models import utia as jutia
from dj_brdf_tpu.models.lambert import Lambert as JLambert
from dj_brdf_tpu.parallel import integrals as jint
from dj_brdf_torch import convert
from dj_brdf_torch import fresnel as tfres
from dj_brdf_torch.cli import nrm_utia
from dj_brdf_torch.core.math import from_spherical
from dj_brdf_torch.io import synth as tsynth
from dj_brdf_torch.io import utia_io as tio
from dj_brdf_torch.microfacet import brdf as tmf
from dj_brdf_torch.microfacet import ndf as tndf
from dj_brdf_torch.microfacet.params import MicrofacetParams as TParams
from dj_brdf_torch.models import utia as tutia
from dj_brdf_torch.models.lambert import Lambert as TLambert
from dj_brdf_torch.parallel import integrals as tint
from dj_brdf_torch.parallel.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ELLIPSE = (0.3, 0.15, 0.4)


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


def dirs(rng, n, lo=0.15, hi=1.5):
    """Random directions, theta in [lo, hi], phi over the whole circle
    (atan2's branch cut included); off the pole, where f32 arccos is ill
    conditioned in both packages."""
    th = rng.uniform(lo, hi, n)
    ph = rng.uniform(-np.pi, np.pi, n)
    return np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                     np.cos(th)], -1).astype(np.float32)


def edge_dirs():
    """The pole, below-horizon directions and azimuths at the phi wrap
    (0, just below 2 pi, just above -pi and on the -x axis)."""
    th = np.array([0.0, 1.6, 2.5, 0.7, 0.7, 0.7, 0.7, 1.2, np.pi])
    ph = np.array([0.0, 0.3, -2.0, 0.0, -1e-4, 2 * np.pi - 1e-4,
                   -np.pi + 1e-4, np.pi, 0.0])
    return np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                     np.cos(th)], -1).astype(np.float32)


def close(got, want, rtol, atol_rel, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=rtol,
        atol=atol_rel * max(float(np.abs(want).max()), 1e-30), err_msg=what)


@pytest.fixture(scope="module")
def table():
    return np.random.default_rng(0).uniform(0.0, 0.3, (3, 6, 48, 6, 48)) \
        .astype(np.float32)


def test_pack_corners_bit_for_bit(table):
    got = tutia.pack_corners(torch.from_numpy(table))
    want = np.asarray(jutia.pack_corners(jnp.asarray(table)))
    assert got.shape == (tutia.ROWS, 48)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("packed", [True, False], ids=["built", "unpacked"])
def test_eval_and_evalp_match_jax(table, packed):
    """eval and evalp at random directions and at the pole, below the
    horizon and across the phi wrap: rtol 1e-5, atol 1e-6 of the max
    (arccos/atan2 differ by an ulp between XLA and PyTorch)."""
    rng = np.random.default_rng(1)
    i = np.concatenate([dirs(rng, 2000), edge_dirs()])
    o = np.concatenate([dirs(rng, 2000), edge_dirs()[::-1]])
    ju = jutia.Utia.build(jnp.asarray(table))
    tu = (tutia.Utia.build(torch.from_numpy(table)) if packed
          else tutia.Utia(table=torch.from_numpy(table)))
    ti, to = torch.from_numpy(i), torch.from_numpy(o)
    close(tu.eval(ti, to), ju.eval(jnp.asarray(i), jnp.asarray(o)), 1e-5,
          1e-6, "eval")
    got = tu.evalp(ti, to).numpy()
    close(got, ju.evalp(jnp.asarray(i), jnp.asarray(o)), 1e-5, 1e-6, "evalp")
    below = (i[:, 2] <= 0.0) | (o[:, 2] <= 0.0)
    assert below.sum() >= 3 and (got[below] == 0.0).all()


def test_gradients_match_jax_grad(table):
    """Gradients of the summed evalp w.r.t. the table and both directions
    against jax.grad: rtol 1e-4, atol 1e-4 of the largest."""
    rng = np.random.default_rng(2)
    i, o = dirs(rng, 1024), dirs(rng, 1024)

    def jloss(t, i, o):
        return jutia.Utia.build(t).evalp(i, o).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(table), jnp.asarray(i), jnp.asarray(o))
    leaves = [torch.tensor(x, requires_grad=True) for x in (table, i, o)]
    tutia.Utia.build(leaves[0]).evalp(leaves[1], leaves[2]).sum().backward()
    for name, leaf, w in zip(("table", "i", "o"), leaves, want):
        close(leaf.grad, w, 1e-4, 1e-4, name)
        assert float(leaf.grad.abs().max()) > 0.0


def test_table_takes_the_default_float(table):
    u = tutia.Utia.build(torch.from_numpy(table).double())
    assert u.table.dtype == torch.float32 and u.packed.dtype == torch.float32


def jax_ggx(i, o):
    return jmf.eval(jndf.GGX(), jfres.Ideal(), JParams.elliptic(*ELLIPSE),
                    i, o)


def torch_ggx(i, o):
    return tmf.eval(tndf.GGX(), tfres.Ideal(), TParams.elliptic(*ELLIPSE),
                    i, o)


@pytest.mark.parametrize("model", ["lambert", "ggx"])
def test_bake_utia_matches_jax(model):
    """The raw file-unit table at the UTIA bin centres: a constant
    Lambertian bit for bit, the anisotropic GGX at rtol 1e-5 (atol 1e-6
    of the max)."""
    if model == "lambert":
        want = jsynth.bake_utia(JLambert(
            reflectance=jnp.asarray([0.7, 0.5, 0.3])).eval)
        got = tsynth.bake_utia(TLambert(
            reflectance=torch.tensor([0.7, 0.5, 0.3])).eval, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        want = jsynth.bake_utia(jax_ggx)
        got = tsynth.bake_utia(torch_ggx, device="cpu")
        close(got, want, 1e-5, 1e-6)
    assert got.dtype == torch.float64 and got.shape == tutia.TABLE_SHAPE


def test_save_and_load_utia_match_jax(tmp_path):
    """A table with negative samples written by the port reads back
    through both packages' numpy paths alike (clamp, then 1/140), and
    the JAX package reads what the port writes."""
    raw = np.random.default_rng(3).uniform(-0.5, 3.0, tutia.TABLE_SHAPE)
    path = str(tmp_path / "u.bin")
    tio.save_utia(path, torch.from_numpy(raw))
    got = tio.load_utia(path, use_native=False)
    want = jio.load_utia(path, use_native=False)
    assert got.dtype == np.float32 and got.min() >= 0.0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tio.load_utia(path, dtype=np.float64, use_native=False),
        jio.load_utia(path, dtype=np.float64, use_native=False))
    jio.save_utia(str(tmp_path / "j.bin"), raw)
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "u.bin").read_bytes()


def test_save_and_load_utia_reject_bad_input(tmp_path):
    with pytest.raises(ValueError, match="UTIA table"):
        tio.save_utia(str(tmp_path / "x.bin"), np.zeros((3, 6, 48, 6)))
    short = tmp_path / "short.bin"
    short.write_bytes(np.zeros(100).tobytes())
    with pytest.raises(ValueError, match="truncated"):
        tio.load_utia(str(short), use_native=False)


def test_convert_utia_from_jax(table):
    ju = jutia.Utia.build(jnp.asarray(table))
    tu = convert.utia_from_jax(ju)
    np.testing.assert_array_equal(tu.table.numpy(), table)
    np.testing.assert_array_equal(tu.packed.numpy(), np.asarray(ju.packed))
    assert convert.utia_from_jax({"table": table, "packed": None}).packed \
        is None


def test_furnace_integral_matches_jax(table):
    """The white-furnace integral of 70 outgoing directions (two chunks
    of 64) on a 16x32 incoming grid: rtol 1e-5 (sums in another order)."""
    o = dirs(np.random.default_rng(4), 70, 0.0, 1.5)
    ju, tu = (jutia.Utia.build(jnp.asarray(table)),
              tutia.Utia.build(torch.from_numpy(table)))
    want = jint.furnace_integral(ju.evalp, jnp.asarray(o), 16, 32)
    got = tint.furnace_integral(tu.evalp, torch.from_numpy(o), 16, 32)
    assert got.shape == (70, 3)
    close(got, want, 1e-5, 1e-6)


@pytest.mark.parametrize("albedo", [0.7, 3.0])
def test_furnace_test_matches_jax(albedo):
    """The pass/fail and the max integral over an 8x16 outgoing grid of a
    baked Lambertian, as tests/nrm_utia.cpp runs it: rtol 1e-5."""
    raw = jsynth.bake_utia(JLambert(reflectance=jnp.full(3, albedo)).eval)
    table = np.maximum(raw, 0.0) / 140.0
    want = jint.furnace_test(jutia.Utia.build(jnp.asarray(table,
                                                          jnp.float32)).evalp,
                             8, 16)
    got = tint.furnace_test(tutia.Utia.build(torch.tensor(
        table, dtype=torch.float32)).evalp, 8, 16, device="cpu")
    assert got[0] == want[0] == (albedo < 1.0)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)


def test_mesh_raises(world_one):
    """``mesh=`` over a world of one (gloo, in-process): the integrals
    and the test's verdict equal the unsharded ones bit for bit (2 and 4
    ranks: tests/test_torch_mesh.py); a mesh asked on the card while the
    gloo group lives raises instead of quietly running on the CPU."""
    raw = tsynth.bake_utia(TLambert(reflectance=torch.full((3,), 0.7)).eval,
                           "cpu")
    tu = tutia.Utia.build(torch.clamp(raw, min=0.0).float() / 140.0)
    mesh = world_one
    o = from_spherical(torch.linspace(0.1, 1.4, 5), torch.linspace(0.0, 3.0, 5))
    assert torch.equal(tint.furnace_integral(tu.evalp, o, 8, 16, mesh=mesh),
                       tint.furnace_integral(tu.evalp, o, 8, 16))
    assert tint.furnace_test(tu.evalp, 3, 5, mesh=mesh, device="cpu") == \
        tint.furnace_test(tu.evalp, 3, 5, device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        make_mesh(1, "cuda")


def run_nrm_utia(*args):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "dj_brdf_torch.cli.nrm_utia",
                           *map(str, args)], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=600)


def test_nrm_utia_cli_on_the_cpu(tmp_path):
    """The port's program on a good and a bad Lambertian bake, as
    tests/test_cli.py runs JAX's: exit 0 and "ok", exit 1 and
    "FAILURE"."""
    for name, albedo in (("good", 0.7), ("bad", 3.0)):
        tio.save_utia(str(tmp_path / f"{name}.bin"), tsynth.bake_utia(
            TLambert(reflectance=torch.full((3,), albedo)).eval, "cpu"))
    r = run_nrm_utia("--device", "cpu", tmp_path / "good.bin", "--ntheta", 8,
                     "--nphi", 16)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ok" in r.stdout and "FAILURE" not in r.stdout
    r = run_nrm_utia("--device", "cpu", tmp_path / "bad.bin", "--ntheta", 8,
                     "--nphi", 16)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "FAILURE" in r.stdout


def test_nrm_utia_mesh_and_missing_card_raise(tmp_path):
    path = str(tmp_path / "good.bin")
    tio.save_utia(path, np.zeros(tutia.TABLE_SHAPE))
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 3"):
        nrm_utia.main(["--device", "cpu", "--mesh", "3", path])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            nrm_utia.main([path])
