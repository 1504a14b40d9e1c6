"""Port parity, distribution: every ``mesh=`` path of the port run by 2
and by 4 gloo ranks on the CPU, against the port's unsharded call and
the JAX package's call on ``make_mesh(8)`` (the test process's 8 virtual
CPU devices).

One group of worker processes a world size runs every sharded case
once (this file, run as a script with ``--worker``) and writes its
results to an ``.npz`` a rank; the tests compare those. Sizes do not
divide the world sizes (M = 5 and 3 materials, N = 1001 samples,
n = 105 kernel columns, 13 and 35 outgoing directions, 81 pixels), so
padding and short trailing blocks run. Where the JAX package needs a
multiple of its 8 devices, its inputs are padded with copies (per-item
work), or the JAX call takes another size (``fit_lsq``: N = 1000) or a
mesh of 5 of its devices (``fit_materials``: padding would change its
objective).

Tolerances: bit for bit where the shards only split independent work
(materials, outgoing directions, pixels: at these sizes every lane
takes the same CPU code path in both runs, although a transcendental in
a vector's scalar tail, libm's against Sleef's, could move one by an
ulp at other block sizes); rtol 1e-6 where a reduction
runs in another order (the fit's all-reduced sums, the power
iteration's blocks); against JAX, the JAX tests' own tolerances
(tests/test_render_fit_parallel.py, tests/test_batch_ckpt.py) or, where
they compare only JAX with itself, the port's parity tests'.

Run a worker group by hand:
    python tests/test_torch_mesh.py --worker DIR RANK WORLD INIT_METHOD
"""

import contextlib
import io
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
N_FIT, N_LSQ, N_LSQ_JAX = 600, 1001, 1000
ALPHAS = (0.15, 0.3, 0.45, 0.6, 0.25)
F0S = ((0.9, 0.6, 0.3), (0.5, 0.5, 0.5), (0.2, 0.4, 0.8), (0.7, 0.7, 0.1),
       (0.95, 0.64, 0.54))
TAB_ALPHAS = (0.2, 0.35, 0.5)
TAB_RES = 12
ANISO = (8, 15)                    # n = 7 * 15 = 105 kernel columns
RES, SPP, BOUNCES = 9, 8, 2        # 81 pixels, 648 rays
LIGHT, LIGHT_RAD, SKY = (0.3, 0.4, 0.8), (4.0, 4.0, 4.0), (0.3, 0.35, 0.4)
STEPS = 20
WORKER_TIMEOUT = 420


# ------------------------------------------------------------- inputs

def hemi(rng, n):
    th = rng.uniform(0.05, 1.45, n)
    ph = rng.uniform(0.0, 2 * np.pi, n)
    return np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                     np.cos(th)], -1).astype(np.float32)


def make_inputs(root):
    """Every case's inputs from a numpy seed (and the JAX package's
    uniforms, which the port takes as ``u``), written to ``root``."""
    import jax

    from dj_brdf_torch.io import merl_io, synth, utia_io
    from dj_brdf_torch.models.lambert import Lambert

    rng = np.random.default_rng(0)
    inp = {"i": hemi(rng, N_FIT), "o": hemi(rng, N_FIT),
           "li": hemi(rng, N_LSQ), "lo": hemi(rng, N_LSQ),
           "fo": hemi(rng, 13)}
    inp["targets"] = ggx_targets(ALPHAS, F0S, inp["i"], inp["o"])
    inp["ltarget"] = ggx_targets([0.25], [(0.9, 0.6, 0.3)], inp["li"],
                                 inp["lo"])[0]
    key = jax.random.PRNGKey(0)
    n_rays = RES * RES * SPP
    inp["u"] = np.asarray(jax.random.uniform(key, (BOUNCES, n_rays, 2)))
    inp["u_env"] = np.asarray(jax.random.uniform(
        jax.random.fold_in(key, 0xE57), (BOUNCES, n_rays, 3)))
    inp["env"] = (np.ones((4, 8, 3)) + np.linspace(0, 1, 8)[None, :, None]
                  ).astype(np.float32)
    np.savez(os.path.join(root, "inputs.npz"), **inp)

    tables = np.stack([synth.bake_merl(tabular_eval(a), device="cpu").numpy()
                       for a in TAB_ALPHAS]).astype(np.float32)
    np.save(os.path.join(root, "tables.npy"), tables)
    for k, table in enumerate(tables[:2]):
        merl_io.save_merl(os.path.join(root, f"m{k}.binary"), table)
    utia_io.save_utia(os.path.join(root, "good.bin"), synth.bake_utia(
        Lambert(reflectance=torch.full((3,), 0.7)).eval, "cpu"))


def ggx_targets(alphas, f0s, i, o):
    from dj_brdf_torch import fresnel
    from dj_brdf_torch.microfacet import brdf
    from dj_brdf_torch.microfacet.ndf import GGX
    from dj_brdf_torch.microfacet.params import MicrofacetParams

    return np.stack([brdf.evalp(
        GGX(), fresnel.Schlick(f0=torch.tensor(f0)),
        MicrofacetParams.isotropic(torch.tensor(a)), torch.from_numpy(i),
        torch.from_numpy(o)).numpy() for a, f0 in zip(alphas, f0s)])


def tabular_eval(alpha):
    from dj_brdf_torch import fresnel
    from dj_brdf_torch.fit.tabular import microfacet_eval_fn
    from dj_brdf_torch.microfacet.ndf import GGX
    from dj_brdf_torch.microfacet.params import MicrofacetParams

    return microfacet_eval_fn(
        GGX(), fresnel.Schlick(f0=torch.full((3,), 0.7)),
        MicrofacetParams.isotropic(torch.tensor(alpha)))


def aniso_eval():
    from dj_brdf_torch import fresnel
    from dj_brdf_torch.fit.tabular import microfacet_eval_fn
    from dj_brdf_torch.microfacet.ndf import GGX
    from dj_brdf_torch.microfacet.params import MicrofacetParams

    return microfacet_eval_fn(GGX(), fresnel.Ideal(), MicrofacetParams.elliptic(
        torch.tensor(0.5), torch.tensor(0.25), torch.tensor(0.6)))


def scene(kind, f0=None):
    """The port's (sphere, floor): "mixed" a GGX sphere over a Beckmann
    floor (the fused loop with the deduplicated first bounce), "generic"
    the same sphere over a Lambertian floor (the generic loop)."""
    from dj_brdf_torch import fresnel
    from dj_brdf_torch.microfacet.ndf import GGX, Beckmann
    from dj_brdf_torch.microfacet.params import MicrofacetParams
    from dj_brdf_torch.models.lambert import Lambert
    from dj_brdf_torch.render import materials

    f0 = torch.tensor([0.9, 0.6, 0.3]) if f0 is None else f0
    sphere = materials.MicrofacetMaterial(
        dist=GGX(), fres=fresnel.Schlick(f0=f0),
        params=MicrofacetParams.elliptic(torch.tensor(0.3),
                                         torch.tensor(0.15),
                                         torch.tensor(0.7)))
    if kind == "generic":
        floor = materials.CosineMaterial(
            model=Lambert(reflectance=torch.tensor([0.4, 0.4, 0.4])))
    else:
        floor = materials.MicrofacetMaterial(
            dist=Beckmann(), fres=fresnel.Schlick(
                f0=torch.tensor([0.3, 0.3, 0.3])),
            params=MicrofacetParams.isotropic(torch.tensor(0.5)))
    return sphere, floor


# -------------------------------------------------------------- cases
# Each case runs the call with ``mesh`` (a worker) or without (the
# unsharded reference, in the test process) and returns numpy arrays.

def case_fit_materials(mesh, inp, d):
    from dj_brdf_torch.fit import batch
    p, f, losses = batch.fit_materials(
        torch.from_numpy(inp["targets"]), torch.from_numpy(inp["i"]),
        torch.from_numpy(inp["o"]), steps=STEPS, mesh=mesh)
    return {"ax": p.ax, "ay": p.ay, "rho": p.rho, "f0": f.f0,
            "losses": losses}


def case_tabulate(mesh, inp, d):
    from dj_brdf_torch.fit import batch
    tables = torch.from_numpy(np.load(os.path.join(d, "tables.npy")))
    dists, fres, ab, ag = batch.tabulate_merl_batch(tables, TAB_RES,
                                                    mesh=mesh)
    return {"p22": dists.p22, "sigma": dists.sigma, "cdf": dists.cdf,
            "qf": dists.qf, "fres": fres, "ab": ab, "ag": ag}


def case_fit_lsq(mesh, inp, d):
    from dj_brdf_torch.fit import lsq
    from dj_brdf_torch.microfacet.ndf import GGX
    out = {}
    for name, n in (("uneven", N_LSQ), ("jax", N_LSQ_JAX)):
        for fused in ("auto", "never"):
            p, f, losses = lsq.fit_lsq(
                GGX(), torch.from_numpy(inp["li"][:n]),
                torch.from_numpy(inp["lo"][:n]),
                torch.from_numpy(inp["ltarget"][:n]), steps=STEPS,
                fused=fused, mesh=mesh)
            out.update({f"{name}_{fused}_{k}": v for k, v in (
                ("ax", p.ax), ("ay", p.ay), ("rho", p.rho), ("txn", p.txn),
                ("tyn", p.tyn), ("f0", f.f0), ("losses", losses))})
    return out


def case_aniso(mesh, inp, d):
    from dj_brdf_torch.fit.tabular_aniso import build_tabular_anisotropic
    dist, fres = build_tabular_anisotropic(aniso_eval(), *ANISO, mesh=mesh,
                                           device="cpu")
    out = {name: getattr(dist, name) for name in (
        "p22", "sigma", "pdf1", "cdf1", "qf1_table", "pdf2", "cdf2",
        "qf2_table")}
    out["fres"] = fres.points
    if mesh is not None:
        from dj_brdf_torch.parallel.power import aniso_p22_sharded
        out["p22_raw"] = aniso_p22_sharded(aniso_eval(), *ANISO, mesh)
    return out


def furnace_fn():
    from dj_brdf_torch import fresnel
    from dj_brdf_torch.microfacet import brdf
    from dj_brdf_torch.microfacet.ndf import GGX
    from dj_brdf_torch.microfacet.params import MicrofacetParams
    params = MicrofacetParams.isotropic(torch.tensor(0.5))
    return lambda i, o: brdf.evalp(GGX(), fresnel.Ideal(), params, i, o)


def case_furnace(mesh, inp, d):
    from dj_brdf_torch.parallel import integrals
    vals = integrals.furnace_integral(furnace_fn(),
                                      torch.from_numpy(inp["fo"]), mesh=mesh)
    ok, max_val = integrals.furnace_test(furnace_fn(), 5, 7, mesh=mesh,
                                         device="cpu")
    return {"integral": vals, "test": np.asarray([float(ok), max_val])}


def case_render(mesh, inp, d):
    from dj_brdf_torch.render import pathtrace
    from dj_brdf_torch.render.envmap import EnvMap
    u = torch.from_numpy(inp["u"])
    kw = dict(res=RES, spp=SPP, max_bounces=BOUNCES, u=u, mesh=mesh)
    out = {}
    for kind in ("mixed", "generic"):
        out[kind] = pathtrace.render(*scene(kind), LIGHT, LIGHT_RAD, SKY,
                                     **kw)
    em = EnvMap.build(torch.from_numpy(inp["env"]), device="cpu")
    out["envmap"] = pathtrace.render(
        *scene("mixed"), LIGHT, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), envmap=em,
        u_env=torch.from_numpy(inp["u_env"]), **kw)
    out["jitter"] = pathtrace.render(
        *scene("mixed"), LIGHT, LIGHT_RAD, SKY, jitter=True,
        generator=torch.Generator().manual_seed(1),
        **dict(kw, u=None))
    # a backward through the frame w.r.t. the sphere's f0
    f0 = torch.tensor([0.9, 0.6, 0.3], requires_grad=True)
    img = pathtrace.render(*scene("mixed", f0), LIGHT, LIGHT_RAD, SKY, **kw)
    (img * torch.linspace(0.5, 1.5, 3)).sum().backward()
    out["grad_f0"] = f0.grad
    return out


def case_dryrun(mesh, inp, d):
    from dj_brdf_torch.entry import dryrun_multichip
    dryrun_multichip(1 if mesh is None else mesh.size, "cpu")
    return {"ran": np.ones(1)}


def case_collectives(mesh, inp, d):
    """tests/test_distributed.py's check: a sum over ranks of rank-local
    data, and one data-parallel fit gradient on sample-sharded data."""
    from dj_brdf_torch.fit import lsq
    from dj_brdf_torch.microfacet.ndf import GGX
    out = {}
    if mesh is not None:
        local = torch.full((4,), float(mesh.rank + 1))
        out["total"] = mesh.all_reduce_sum(local.sum())
        out["gathered"] = mesh.all_gather(local)
    i, o = torch.from_numpy(inp["li"]), torch.from_numpy(inp["lo"])
    t = torch.from_numpy(inp["ltarget"])
    vg, data = lsq.fit_step(GGX(), i, o, t, fused="never", mesh=mesh)
    val, grads = vg(lsq.raw_init(device="cpu"), *data)
    out["loss"] = val
    out.update({f"g_{k}": g for k, g in zip(lsq.RawFit._fields, grads)})
    return out


def case_cli(mesh, inp, d):
    from dj_brdf_torch.cli import merl_params, nrm_utia
    rank = 0 if mesh is None else mesh.rank
    tag = "plain" if mesh is None else f"w{mesh.size}r{rank}"
    extra = [] if mesh is None else ["--mesh", str(mesh.size)]
    params = os.path.join(d, f"params_{tag}.txt")
    src = os.path.realpath(os.path.join(d, "inputs.npz"))
    src = os.path.dirname(src)       # the inputs' own directory
    rc_m = merl_params.main(["--device", "cpu", "--res", "24", "-o", params,
                             *extra, os.path.join(src, "m0.binary"),
                             os.path.join(src, "m1.binary")])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_n = nrm_utia.main(["--device", "cpu", "--ntheta", "8", "--nphi",
                              "16", *extra, os.path.join(src, "good.bin")])
    with open(os.path.join(d, f"nrm_{tag}.txt"), "w") as fh:
        fh.write(buf.getvalue())
    return {"rc": np.asarray([rc_m, rc_n])}


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def run_cases(mesh, d):
    torch.set_num_threads(1)
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    out = {}
    for name, fn in CASES.items():
        for k, v in fn(mesh, inp, d).items():
            out[f"{name}/{k}"] = (v.detach().numpy()
                                  if isinstance(v, torch.Tensor) else v)
    return out


def worker(d, rank, world, init_method):
    from dj_brdf_torch.parallel.mesh import init_distributed, make_mesh
    init_distributed("cpu", init_method, world_size=world, rank=rank)
    mesh = make_mesh(world, "cpu")
    assert (mesh.rank, mesh.size) == (rank, world)
    np.savez(os.path.join(d, f"rank{rank}.npz"), **run_cases(mesh, d))
    import torch.distributed as dist
    dist.destroy_process_group()


# ------------------------------------------------------------ fixtures

def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh"))
    make_inputs(d)
    return d


@pytest.fixture(scope="module")
def plain(workdir):
    """The port's unsharded calls on the same inputs."""
    return run_cases(None, workdir)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def sharded(request, workdir):
    """One group of ``world`` gloo workers, started once, with a timeout
    of its own and a free localhost port: each rank's results."""
    world = request.param
    d = os.path.join(workdir, f"w{world}")
    os.makedirs(d)
    for name in os.listdir(workdir):
        if not os.path.isdir(os.path.join(workdir, name)):
            os.symlink(os.path.join(workdir, name), os.path.join(d, name))
    rcs, logs = run_group(d, world)
    if any(rcs) and any("address already in use" in log.lower()
                        for log in logs):
        rcs, logs = run_group(d, world)    # another process took the port
    for rc, log in zip(rcs, logs):
        assert rc == 0, log[-3000:]
    return world, d, [dict(np.load(os.path.join(d, f"rank{r}.npz")))
                      for r in range(world)]


def run_group(d, world):
    """Start ``world`` worker processes on a free localhost port and wait
    for them (``WORKER_TIMEOUT`` s for the group, then killed): their exit
    codes and logs."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", d, str(r),
         str(world), init], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=ROOT) for r in range(world)]
    logs, deadline = [], time.monotonic() + WORKER_TIMEOUT
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], logs


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def same(got, want, keys):
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def keys_of(res, case):
    return sorted(k for k in res if k.startswith(case + "/"))


# --------------------------------------------------- sharded = unsharded

def test_every_rank_returns_the_same(sharded):
    """Collectives return the whole result to every rank."""
    _, _, ranks = sharded
    for res in ranks[1:]:
        assert sorted(res) == sorted(ranks[0])
        same(res, ranks[0], list(res))


@pytest.mark.parametrize("case", ["fit_materials", "tabulate", "furnace"])
def test_per_item_work_is_bit_for_bit(sharded, plain, case):
    """Materials and outgoing directions split into independent work:
    the sharded result equals the unsharded call bit for bit."""
    _, _, ranks = sharded
    keys = keys_of(plain, case)
    assert keys
    same(ranks[0], plain, keys)


def test_fit_lsq_sharded_matches_unsharded(sharded, plain):
    """The 9 sums (fused) or the gradient (layered) all-reduced: another
    order of the same f32 sums, rtol 1e-6 (over 20 Adam steps)."""
    _, _, ranks = sharded
    for k in keys_of(plain, "fit_lsq"):
        np.testing.assert_allclose(ranks[0][k], plain[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_aniso_sharded_matches_unsharded(sharded, plain):
    """Stage 1 in float32 column blocks against the unsharded builder,
    which iterates n = 105 in float64: the JAX test's tolerances
    (tests/test_render_fit_parallel.py:165-188)."""
    _, _, ranks = sharded
    for k in keys_of(plain, "aniso"):
        a, b = plain[k], ranks[0][k]
        atol = 1e-4 if k.endswith("fres") else 2e-4 * np.abs(a).max()
        np.testing.assert_allclose(b, a, rtol=2e-3, atol=atol, err_msg=k)


def test_power_blocks_match_the_whole_matrix(sharded):
    """The column-sharded power iteration against the whole kernel
    matrix iterated in float32 by the unsharded device path: the blocks
    sum in another order, rtol 1e-6."""
    from dj_brdf_torch.fit import tabular_aniso as ta
    _, _, ranks = sharded
    A = ta.kernel_matrix(aniso_eval(), *ANISO, dtype=torch.float32,
                         device="cpu")
    want = ta._device_power_table(A, *ANISO).numpy()
    np.testing.assert_allclose(ranks[0]["aniso/p22_raw"], want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["mixed", "generic", "envmap", "jitter"])
def test_render_sharded_equals_unsharded(sharded, plain, kind):
    """Pixels are independent: each rank traces every sample of its
    pixels from the globally drawn numbers, bit for bit."""
    _, _, ranks = sharded
    same(ranks[0], plain, [f"render/{kind}"])
    assert np.isfinite(plain[f"render/{kind}"]).all()


def test_render_backward_sharded_equals_unsharded(sharded, plain):
    """A backward through the sharded frame: the gathered image's
    gradient reaches every rank's pixels and the replicated material's
    gradient is the mean of the ranks' (each loss is the whole frame's),
    the unsharded gradient up to the order of its sums, rtol 1e-5."""
    _, _, ranks = sharded
    want = plain["render/grad_f0"]
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(ranks[0]["render/grad_f0"], want, rtol=1e-5)


def test_collectives_and_data_parallel_gradient(sharded, plain):
    """tests/test_distributed.py's two-process check, ported with gloo:
    a sum over ranks of rank-local data, and the loss and gradient of a
    data-parallel fit step equal the unsharded ones (rtol 1e-6)."""
    world, _, ranks = sharded
    r0 = ranks[0]
    assert float(r0["collectives/total"]) == 4 * world * (world + 1) / 2
    np.testing.assert_array_equal(
        r0["collectives/gathered"], np.repeat(np.arange(1, world + 1), 4))
    for k in keys_of(plain, "collectives"):
        np.testing.assert_allclose(r0[k], plain[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)


def test_dryrun_multichip_runs(sharded):
    _, _, ranks = sharded
    assert all(float(r["dryrun/ran"][0]) == 1.0 for r in ranks)


def test_cli_mesh_matches_unsharded(sharded, plain, workdir):
    """``merl_params --mesh`` and ``nrm_utia --mesh``: rank 0 writes the
    unsharded program's output, no other rank writes, all exit alike."""
    world, d, ranks = sharded
    for res in ranks:
        np.testing.assert_array_equal(res["cli/rc"], plain["cli/rc"])
    want = open(os.path.join(workdir, "params_plain.txt")).read()
    assert open(os.path.join(d, f"params_w{world}r0.txt")).read() == want
    want = open(os.path.join(workdir, "nrm_plain.txt")).read()
    assert open(os.path.join(d, f"nrm_w{world}r0.txt")).read() == want
    for r in range(1, world):
        assert not os.path.exists(os.path.join(d, f"params_w{world}r{r}.txt"))
        assert open(os.path.join(d, f"nrm_w{world}r{r}.txt")).read() == ""


# ------------------------------------------------ against JAX's mesh(8)

@pytest.fixture(scope="module")
def jax_mesh():
    from dj_brdf_tpu.parallel.mesh import make_mesh
    return make_mesh(8)


def pad8(x):
    """Copies of leading items up to a multiple of 8 (per-item work)."""
    n = x.shape[0]
    return np.concatenate([x, x[np.arange(-n % 8) % n]])


def test_fit_materials_matches_jax_mesh(sharded, workdir):
    """JAX's ``fit_materials`` on a mesh of its first 5 devices, one
    material each (it shards only multiples of its devices, and padding
    would change its objective, the mean over M): the port's parity
    tolerances (tests/test_torch_fit.py), rtol 1e-3 on losses and
    alphas, with the JAX test's atol 1e-6 on losses
    (tests/test_batch_ckpt.py:35-47)."""
    import jax.numpy as jnp
    from dj_brdf_tpu.fit import batch
    from dj_brdf_tpu.parallel.mesh import make_mesh
    _, _, ranks = sharded
    inp = np.load(os.path.join(workdir, "inputs.npz"))
    p, _, losses = batch.fit_materials(
        jnp.asarray(inp["targets"]), jnp.asarray(inp["i"]),
        jnp.asarray(inp["o"]), steps=STEPS, mesh=make_mesh(len(ALPHAS)))
    np.testing.assert_allclose(ranks[0]["fit_materials/losses"], losses,
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(ranks[0]["fit_materials/ax"], p.ax,
                               rtol=1e-3)


def test_tabulate_matches_jax_mesh(sharded, workdir, jax_mesh):
    """JAX's ``tabulate_merl_batch(mesh=make_mesh(8))`` (it pads 3 -> 8):
    the port's parity tolerances (tests/test_torch_tabular.py)."""
    import jax.numpy as jnp
    from dj_brdf_tpu.fit import batch
    _, _, ranks = sharded
    tables = np.load(os.path.join(workdir, "tables.npy"))
    d, fres, ab, ag = batch.tabulate_merl_batch(jnp.asarray(tables), TAB_RES,
                                                mesh=jax_mesh)
    r0 = ranks[0]
    np.testing.assert_allclose(r0["tabulate/p22"], d.p22, rtol=2e-5)
    np.testing.assert_allclose(r0["tabulate/qf"], d.qf, atol=1e-6)
    np.testing.assert_allclose(r0["tabulate/fres"], fres, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(r0["tabulate/ab"], ab, rtol=1e-5)
    np.testing.assert_allclose(r0["tabulate/ag"], ag, rtol=1e-5)


def test_fit_lsq_matches_jax_mesh(sharded, workdir, jax_mesh):
    """JAX's ``fit_lsq(in_shardings=...)`` over ``make_mesh(8)`` at
    N = 1000 (JAX shards only multiples of its 8 devices): the port's
    trajectory tolerances (tests/test_torch_fit.py), rtol 1e-4."""
    import jax.numpy as jnp
    from dj_brdf_tpu.fit import lsq
    from dj_brdf_tpu.microfacet.ndf import GGX
    from dj_brdf_tpu.parallel.mesh import data_sharding
    _, _, ranks = sharded
    inp = np.load(os.path.join(workdir, "inputs.npz"))
    n = N_LSQ_JAX
    for fused in ("auto", "never"):
        p, f, losses = lsq.fit_lsq(
            GGX(), jnp.asarray(inp["li"][:n]), jnp.asarray(inp["lo"][:n]),
            jnp.asarray(inp["ltarget"][:n]), steps=STEPS, fused=fused,
            in_shardings=data_sharding(jax_mesh))
        r0 = ranks[0]
        np.testing.assert_allclose(r0[f"fit_lsq/jax_{fused}_losses"],
                                   losses, rtol=1e-4, atol=1e-7)
        for k in ("ax", "ay", "rho", "txn", "tyn"):
            np.testing.assert_allclose(r0[f"fit_lsq/jax_{fused}_{k}"],
                                       getattr(p, k), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(r0[f"fit_lsq/jax_{fused}_f0"], f.f0,
                                   rtol=1e-4)


def test_aniso_matches_jax_mesh(sharded, jax_mesh):
    """JAX's ``build_tabular_anisotropic(mesh=make_mesh(8))``: both run
    stage 1 in float32 column blocks; the JAX test's tolerances
    (tests/test_render_fit_parallel.py:165-188)."""
    from dj_brdf_tpu import fresnel as jfres
    from dj_brdf_tpu.fit import tabular, tabular_aniso
    from dj_brdf_tpu.microfacet.ndf import GGX
    from dj_brdf_tpu.microfacet.params import MicrofacetParams
    _, _, ranks = sharded
    eval_fn = tabular.microfacet_eval_fn(
        GGX(), jfres.Ideal(), MicrofacetParams.elliptic(0.5, 0.25, 0.6))
    dist, fres = tabular_aniso.build_tabular_anisotropic(eval_fn, *ANISO,
                                                         mesh=jax_mesh)
    for name in ("p22", "sigma", "pdf1", "cdf1", "qf1_table", "pdf2",
                 "cdf2", "qf2_table"):
        a = np.asarray(getattr(dist, name))
        np.testing.assert_allclose(ranks[0][f"aniso/{name}"], a, rtol=2e-3,
                                   atol=2e-4 * np.abs(a).max(), err_msg=name)
    np.testing.assert_allclose(ranks[0]["aniso/fres"], fres.points,
                               rtol=2e-3, atol=1e-4)


def test_furnace_matches_jax_mesh(sharded, workdir, jax_mesh):
    """JAX's ``furnace_integral(mesh=make_mesh(8))`` on the 13 outgoing
    directions padded to 16, rtol 1e-5 (its own sharded test's); its
    ``furnace_test`` on the 5x7 grid, which it shards only by multiples
    of 8, unsharded."""
    import jax.numpy as jnp
    from dj_brdf_tpu import fresnel as jfres
    from dj_brdf_tpu.microfacet import brdf as jbrdf
    from dj_brdf_tpu.microfacet.ndf import GGX
    from dj_brdf_tpu.microfacet.params import MicrofacetParams
    from dj_brdf_tpu.parallel import integrals
    _, _, ranks = sharded
    fo = np.load(os.path.join(workdir, "inputs.npz"))["fo"]
    params = MicrofacetParams.isotropic(0.5)

    def fn(i, o):
        return jbrdf.evalp(GGX(), jfres.Ideal(), params, i, o)

    want = integrals.furnace_integral(fn, jnp.asarray(pad8(fo)),
                                      mesh=jax_mesh)
    np.testing.assert_allclose(ranks[0]["furnace/integral"],
                               np.asarray(want)[:13], rtol=1e-5)
    ok, max_val = integrals.furnace_test(fn, 5, 7)
    got = ranks[0]["furnace/test"]
    assert bool(got[0]) == ok
    np.testing.assert_allclose(got[1], max_val, rtol=1e-5)


def test_render_matches_jax_mesh(sharded, jax_mesh):
    """JAX's ``render(mesh=make_mesh(8))`` of the mixed scene, whose
    uniforms the port took: the render parity tolerances
    (tests/test_torch_render.py, rtol and atol 1e-4 a pixel)."""
    import jax.numpy as jnp
    from dj_brdf_tpu import fresnel as jfres
    from dj_brdf_tpu.microfacet.ndf import GGX, Beckmann
    from dj_brdf_tpu.microfacet.params import MicrofacetParams
    from dj_brdf_tpu.render import materials, pathtrace
    _, _, ranks = sharded
    sphere = materials.MicrofacetMaterial(
        dist=GGX(), fres=jfres.Schlick(f0=jnp.asarray([0.9, 0.6, 0.3])),
        params=MicrofacetParams.elliptic(0.3, 0.15, 0.7))
    floor = materials.MicrofacetMaterial(
        dist=Beckmann(), fres=jfres.Schlick(f0=jnp.asarray([0.3, 0.3, 0.3])),
        params=MicrofacetParams.isotropic(0.5))
    want = pathtrace.render(sphere, floor, jnp.asarray(LIGHT, jnp.float32),
                            jnp.asarray(LIGHT_RAD), jnp.asarray(SKY),
                            res=RES, spp=SPP, max_bounces=BOUNCES,
                            mesh=jax_mesh)
    np.testing.assert_allclose(ranks[0]["render/mixed"], np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_cli_mesh_matches_jax_mesh(sharded, workdir):
    """The JAX programs with ``--mesh 8`` on the same files: the
    ``merl_params`` alphas within 1e-3 (tests/test_torch_tabular.py's
    CLI tolerance), the same ``nrm_utia`` verdict and max integral."""
    from dj_brdf_tpu.cli import merl_params, nrm_utia
    world, d, _ = sharded
    out = os.path.join(d, "params_jax.txt")
    files = [os.path.join(workdir, f"m{k}.binary") for k in range(2)]
    assert merl_params.main(["--res", "24", "--mesh", "8", "-o", out,
                             *files]) == 0

    def rows(path):
        return [line.split() for line in open(path).read().splitlines()[1:]]

    got, want = rows(os.path.join(d, f"params_w{world}r0.txt")), rows(out)
    assert [g[0] for g in got] == [w[0] for w in want]
    np.testing.assert_allclose([[float(x) for x in g[1:]] for g in got],
                               [[float(x) for x in w[1:]] for w in want],
                               atol=1e-3 + 1e-9)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = nrm_utia.main(["--ntheta", "8", "--nphi", "16", "--mesh", "8",
                            os.path.join(workdir, "good.bin")])
    got = open(os.path.join(d, f"nrm_w{world}r0.txt")).read().splitlines()
    want = buf.getvalue().splitlines()
    assert rc == 0 and [g.split()[1] for g in got[1:]] == [
        w.split()[1] for w in want[1:]]
    np.testing.assert_allclose(float(got[-1].split()[-1].rstrip(")")),
                               float(want[-1].split()[-1].rstrip(")")),
                               atol=1e-4 + 1e-9)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
