"""The port's bench (``dj_brdf_torch/bench.py``): its self-validation
machinery with a fake clock (bench.py's own tests, ported), its headline
step against the JAX package's fused fit step, its metric names against
bench.py's, and whole runs on the CPU at tiny sizes. On the CPU every
fit step runs the kernel's plain version, so no timing here says
anything about a card.

Tolerances: the headline step against JAX's ``ggx_lsq_value_and_grad``
(interpret mode, as tests/test_ops.py runs it) at that test's f32
tolerances: loss rtol 1e-4, gradient rtol 3e-4 atol 1e-6.

The cases that need the card skip here; on the card's machine, which has
no JAX, run ``python -m pytest --noconftest tests/test_torch_bench.py``
(the JAX case skips there)."""

import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from dj_brdf_torch import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every metric at a size the CPU runs in a few seconds
TINY_ENV = {"BENCH_N": "4096", "BENCH_ITERS": "2"}
TINY = {
    "fit_batch_step_evals_per_s": {"m": 2},
    "pathtrace_samples_per_s": {"res": 8, "spp": 2},
    "pathtrace_ggx_samples_per_s": {"res": 8, "spp": 2},
    "pathtrace_envmap_samples_per_s": {"h": 8, "w": 16, "res": 8, "spp": 2},
    "pathtrace_envmap_1024x2048_samples_per_s": {"h": 16, "w": 32, "res": 8,
                                                 "spp": 2},
    "pathtrace_matpreview_samples_per_s": {"h": 16, "w": 32, "tex": 16,
                                           "res": 8, "spp": 2},
    "power_iteration_matvecs_per_s_n8010": {"rows": 64},
    "batch_tabulate_res90_materials_per_s": {"m": 2, "res": 8},
    "scaling_efficiency_cpu8_pct": {"devices": 1, "n": 4096, "iters": 2},
    "aniso_fit90_wall_seconds": {"res": 8},
}


def _fake_clock(durations):
    """perf_counter sequence: each timing round reads the clock twice
    (start, end); rounds last the given durations."""
    times = []
    t = 0.0
    for d in durations:
        times.append(t)          # round start
        t += d
        times.append(t)          # round end
    it = iter(times + [t] * 100)
    return lambda: next(it)


@pytest.mark.parametrize("durations, max_rounds, rounds, agreed", [
    # 1.0 then 1.5 (no agreement), 1.04 agrees with 1.0 -> stop
    ([1.0, 1.5, 1.2, 1.04], 8, 4, True),
    # never agrees: strictly growing durations -> stops at max_rounds
    ([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], 5, 5, False),
    ([1.0, 1.01, 1.02], 8, 3, True),
], ids=["agreement_rerounds", "cap", "immediate_agreement"])
def test_timeit_stats(monkeypatch, durations, max_rounds, rounds, agreed):
    monkeypatch.setattr(bench.time, "perf_counter", _fake_clock(durations))
    run = bench.Run("cpu")
    st = bench._timeit_stats(run, lambda: 0.0, iters=1, rounds=3,
                             max_rounds=max_rounds)
    assert st["rounds"] == rounds
    assert st["agreed"] == agreed
    assert abs(st["best"] - 1.0) < 1e-9
    assert run.last_stats == st
    if rounds == 4:
        assert min(abs(st["median"] - x) for x in (1.2, 1.04)) < 1e-9
        assert abs(st["median_best3"] - 1.04) < 1e-9
        assert st["cv"] > 0.0


def test_metric_records_spread(monkeypatch, capsys):
    monkeypatch.setattr(bench.time, "perf_counter",
                        _fake_clock([1.0, 1.01, 1.02]))
    run = bench.Run("cpu")

    def fn():
        bench._timeit(run, lambda: 0.0, iters=1)
        run.share_of_bound(1.0, 2.0)
        return 42.0

    assert bench._metric(run, "demo_metric", fn, unit="u") == 42.0
    err = capsys.readouterr().err
    rec = json.loads(err.strip().splitlines()[-1])
    assert rec["value"] == 42.0 and rec["unit"] == "u"
    assert rec["rounds_agreed_10pct"] is True and "spread_cv" in rec
    # the bound is the card's: no share on the CPU
    assert rec["share_of_bound"] is None
    assert rec["launches"] == {"fused_fit": 0, "merl_lookup": 0}
    assert run.secondary == {"demo_metric": 42.0} and run.failed == []


@pytest.fixture(scope="module")
def jnp():
    """JAX on the CPU (the card's machine has no JAX: these cases skip
    there)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy
    return jax.numpy


def test_headline_step_matches_jax(jnp):
    from dj_brdf_tpu.core.math import from_spherical
    from dj_brdf_tpu.ops import soa as jsoa
    from dj_brdf_tpu.ops.fused_fit import ggx_lsq_value_and_grad

    rng = np.random.default_rng(0)
    n = 4096
    th = rng.uniform(0.02, 1.5, (2, n)).astype(np.float32)
    ph = rng.uniform(0.0, 2 * np.pi, (2, n)).astype(np.float32)
    i = np.asarray(from_spherical(jnp.asarray(th[0]), jnp.asarray(ph[0])))
    o = np.asarray(from_spherical(jnp.asarray(th[1]), jnp.asarray(ph[1])))
    jcomp = jsoa.split_dirs(jnp.asarray(i), jnp.asarray(o))
    jt = jsoa.ggx_evalp_soa(jnp.asarray(bench.PVEC_TRUE, jnp.float32), *jcomp)
    jp = jnp.asarray(bench.PVEC_START, jnp.float32)
    want_val, want_grad = ggx_lsq_value_and_grad(jp, *jcomp, *jt,
                                                 block_rows=32,
                                                 interpret=True)

    comp = tuple(torch.from_numpy(np.array(c)) for c in jcomp)
    tgts = tuple(torch.from_numpy(np.array(t)) for t in jt)
    pvec = torch.tensor(bench.PVEC_START)
    got = bench.headline_step(pvec, comp, tgts)()
    val, grad = bench.ff.ggx_lsq_value_and_grad(pvec, *comp, *tgts)
    np.testing.assert_allclose(float(val), float(want_val), rtol=1e-4)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                               rtol=3e-4, atol=1e-6)
    np.testing.assert_allclose(float(got),
                               float(want_val) + float(want_grad[0]),
                               rtol=3e-4)


def test_metric_names_are_bench_pys():
    with open(os.path.join(ROOT, "bench.py")) as fh:
        src = fh.read()
    names = re.findall(r'_metric\("(\w+)"', src)
    assert len(names) == len(set(names)) == 20
    assert set(bench.METRICS) == set(names)
    assert f'"metric": "{bench.HEADLINE}"' in src


def _tiny_main(monkeypatch, capsys, **env):
    for k, v in {**TINY_ENV, **env}.items():
        monkeypatch.setenv(k, v)
    rc = bench.main(["--device", "cpu"], sizes=TINY)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1, out
    return rc, lines[0], json.loads(lines[0]), err


def test_whole_bench_on_cpu_at_tiny_sizes(monkeypatch, capsys):
    rc, line, rec, err = _tiny_main(monkeypatch, capsys)
    assert rc == 0, err
    assert len(line) < 2000
    assert rec["metric"] == bench.HEADLINE and rec["unit"] == "evals/s"
    assert rec["failed"] == []
    assert set(rec["secondary"]) == set(bench.METRICS)
    for v in (rec["value"], rec["median_of_best3"],
              *rec["secondary"].values()):
        assert math.isfinite(v) and v > 0
    assert rec["share_of_bound"] is None          # a CPU run: no device bound
    assert rec["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert isinstance(rec["consistent_vs_fit_step"], bool)
    # every metric's record on stderr, with the launches it made (none: the
    # CPU runs the plain versions)
    recs = [json.loads(ln) for ln in err.splitlines() if ln.startswith("{")]
    assert {r["metric"] for r in recs} == {bench.HEADLINE, *bench.METRICS}
    assert all(r["launches"] == {"fused_fit": 0, "merl_lookup": 0}
               for r in recs)


def test_failed_metric_exits_1_and_is_named(monkeypatch, capsys):
    def broken(*args, **kwargs):
        raise RuntimeError("broken on purpose")

    monkeypatch.setattr(bench, "matvec_rate", broken)
    rc, _, rec, err = _tiny_main(monkeypatch, capsys, BENCH_BATCH="0",
                                 BENCH_SCALING="0", BENCH_ANISO="0")
    assert rc == 1
    assert rec["failed"] == ["power_iteration_matvecs_per_s_n8010"]
    assert "power_iteration_matvecs_per_s_n8010" not in rec["secondary"]
    assert "broken on purpose" in err


@pytest.mark.skipif("torch.cuda.is_available()")
def test_without_a_card_the_default_device_fails():
    env = dict(os.environ, PYTHONPATH=ROOT, BENCH_SECONDARY="0")
    proc = subprocess.run([sys.executable, "-m", "dj_brdf_torch.bench"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


@pytest.mark.skipif("not torch.cuda.is_available()")
def test_bench_on_the_card_launches_the_kernels(monkeypatch, capsys):
    for k, v in {**TINY_ENV, "BENCH_N": str(1 << 16), "BENCH_SCALING": "0"
                 }.items():
        monkeypatch.setenv(k, v)
    assert bench.main([], sizes=TINY) == 0
    out, err = capsys.readouterr()
    rec = json.loads(out)
    assert rec["device"]["platform"] == "gpu" and rec["share_of_bound"] > 0
    recs = {r["metric"]: r for r in map(json.loads, (
        ln for ln in err.splitlines() if ln.startswith("{")))}
    for name, kernel in ((bench.HEADLINE, "fused_fit"),
                         ("fit_step_beckmann_evals_per_s", "fused_fit"),
                         ("fit_batch_step_evals_per_s", "fused_fit"),
                         ("merl_eval_evals_per_s", "merl_lookup")):
        assert recs[name]["launches"][kernel] > 0, name
