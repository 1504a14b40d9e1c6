"""The port's tools against the JAX system's: ``dj_brdf_torch.tools.
bench_scaling`` (data-parallel fit step over gloo ranks on the CPU,
started with ``torch.distributed.run``) and ``dj_brdf_torch.tools.
validate_merl_fits`` (MERL roughness fits against a pinned table).

Tolerances: each world's all-reduced loss and gradient against the
unsharded step at rtol 1e-6 (the ranks' sums are added in another
order), with an atol of 1e-6 of the gradient's largest entry for entries
that nearly cancel; the unsharded step against the JAX tool's step
(``jax.value_and_grad`` of ``soa.ggx_lsq_loss_soa``) at
tests/test_ops.py's hand-adjoint tolerances (loss rtol 2e-5, gradient
rtol 2e-4 atol 1e-7); the fitted alphas against the JAX tool's at
tests/test_torch_tabular.py's rtol 1e-5.

The cases that need the card skip here; on the card's machine, which has
no JAX, run ``python -m pytest --noconftest tests/test_torch_tools.py``
(the JAX cases skip there)."""

import argparse
import contextlib
import filecmp
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from dj_brdf_torch.tools import bench_scaling as bs
from dj_brdf_torch.tools import validate_merl_fits as vmf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SCALING = 4096


@pytest.fixture(scope="module")
def jax():
    """JAX on the CPU (the card's machine has no JAX: these cases skip
    there)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    return jax


def _jax_tool(name):
    """The JAX system's ``tools/<name>.py``, imported from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ bench_scaling

@pytest.fixture(scope="module")
def scaling_run(tmp_path_factory):
    """One run of the tool at worlds of 1 and 2 gloo ranks: its exit
    status, its stdout and the worlds' results (``--out``)."""
    out = tmp_path_factory.mktemp("scaling") / "worlds.json"
    with contextlib.redirect_stdout(io.StringIO()) as stdout:
        rc = bs.main(["--cpu", "--devices", "2", "--n", str(N_SCALING),
                      "--iters", "2", "--out", str(out)])
    with open(out) as fh:
        return rc, stdout.getvalue(), json.load(fh)


def test_bench_scaling_prints_the_jax_tools_keys(scaling_run):
    rc, stdout, worlds = scaling_run
    assert rc == 0
    line = json.loads(stdout.strip().splitlines()[-1])
    assert set(line) == {"metric", "per_device", "efficiency_at_max"}
    assert line["metric"] == "dp_scaling_efficiency"
    assert set(line["per_device"]) == set(worlds) == {"1", "2"}
    for d, rate in line["per_device"].items():
        assert np.isfinite(rate) and rate > 0 and rate == worlds[d]["rate"]
    assert line["efficiency_at_max"] == pytest.approx(
        line["per_device"]["2"] / (2 * line["per_device"]["1"]))


@pytest.mark.parametrize("world", ["1", "2"])
def test_bench_scaling_worlds_match_the_unsharded_step(scaling_run, world):
    rec = scaling_run[2][world]
    pvec, comp, targets = bs.make_inputs(N_SCALING, "cpu")
    loss, grad = bs.unsharded_step(pvec, comp, targets)
    np.testing.assert_allclose(rec["loss"], float(loss), rtol=1e-6)
    np.testing.assert_allclose(rec["grad"], grad.numpy(), rtol=1e-6,
                               atol=1e-6 * float(grad.abs().max()))


def test_bench_scaling_step_matches_the_jax_tools(jax):
    import jax.numpy as jnp

    from dj_brdf_tpu.ops import soa as jsoa

    pvec, comp, targets = bs.make_inputs(N_SCALING, "cpu")
    loss, grad = bs.unsharded_step(pvec, comp, targets)
    args = [jnp.asarray(t.numpy()) for t in (pvec, *comp, *targets)]
    want_loss, want_grad = jax.value_and_grad(jsoa.ggx_lsq_loss_soa)(*args)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=2e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                               rtol=2e-4, atol=1e-7)


@pytest.mark.parametrize("cpu, preset, want", [
    (True, None, bs.CPU_MALLOC_ENV["MALLOC_MMAP_THRESHOLD_"]),
    (True, "65536", "65536"),
    (False, None, None),
], ids=["cpu_ranks_fixed", "environment_wins", "card_ranks_untouched"])
def test_bench_scaling_fixes_malloc_thresholds_of_cpu_ranks(
        monkeypatch, tmp_path, cpu, preset, want):
    """The environment a world's ranks start with: glibc's thresholds
    fixed for gloo ranks unless the caller set them, untouched for
    NCCL ranks."""
    seen = {}

    def fake_run(cmd, env, **kw):
        seen.update(env)
        (tmp_path / "r.json").write_text(json.dumps({"rate": 1.0}))
        return argparse.Namespace(returncode=0, stderr="")

    monkeypatch.delenv("MALLOC_MMAP_THRESHOLD_", raising=False)
    if preset is not None:
        monkeypatch.setenv("MALLOC_MMAP_THRESHOLD_", preset)
    monkeypatch.setattr(bs.subprocess, "run", fake_run)
    args = argparse.Namespace(n=8, iters=1, cpu=cpu)
    assert bs.run_world(1, args, str(tmp_path / "r.json")) == {"rate": 1.0}
    assert seen.get("MALLOC_MMAP_THRESHOLD_") == want


@pytest.mark.skipif("not torch.cuda.is_available()")
def test_bench_scaling_world_one_on_the_card_is_bit_for_bit(tmp_path):
    out = tmp_path / "worlds.json"
    n = 1 << 20
    assert bs.main(["--devices", "1", "--n", str(n), "--iters", "2",
                    "--out", str(out)]) == 0
    with open(out) as fh:
        rec = json.load(fh)["1"]
    loss, grad = bs.unsharded_step(*bs.make_inputs(n, "cuda"))
    assert rec["loss"] == float(loss) and rec["grad"] == grad.tolist()


# ------------------------------------------------------- validate_merl_fits

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The synthetic corpus baked on the CPU into a directory of its own
    (the tool's own bake writes into the checkout's build/)."""
    return vmf.bake_synthetic_corpus(str(tmp_path_factory.mktemp("merl")),
                                     device="cpu")


def test_our_fits_match_the_jax_tools(jax, corpus):
    res = 32
    got = vmf.our_fits(corpus, res, device="cpu")
    want = _jax_tool("validate_merl_fits").our_fits(corpus, res)
    assert set(got) == set(want) == {
        "synth-ggx-rough", "synth-ggx-smooth", "synth-beckmann-mid"}
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5)


def _validate(corpus, *extra):
    return vmf.main(["--data", os.path.dirname(corpus[0]), "--device", "cpu",
                     *extra])


def test_validate_exits_0_with_every_material_pinned_ok(corpus, capsys):
    assert _validate(corpus) == 0
    out = capsys.readouterr().out
    assert out.count("pinned ok") == 3 and "MISMATCH" not in out


def test_validate_exits_1_on_a_tampered_pinned_table(corpus, tmp_path,
                                                     monkeypatch, capsys):
    with open(vmf.PINNED) as fh:
        pinned = json.load(fh)
    pinned["synth-ggx-rough"]["ggx"] *= 1.01
    tampered = tmp_path / "pinned.json"
    tampered.write_text(json.dumps(pinned))
    monkeypatch.setattr(vmf, "PINNED", str(tampered))
    assert _validate(corpus) == 1
    out = capsys.readouterr().out
    assert out.count("PINNED MISMATCH") == 1 and out.count("pinned ok") == 2


def test_validate_exits_2_with_nothing_to_validate(tmp_path, monkeypatch):
    monkeypatch.setattr(vmf, "bake_synthetic_corpus", lambda *a, **k: [])
    assert vmf.main(["--data", str(tmp_path), "--device", "cpu"]) == 2


def test_validate_bakes_into_its_own_directory(tmp_path, monkeypatch,
                                               capsys):
    build = os.path.join(ROOT, "build")
    assert os.path.commonpath([vmf.SYNTH_DIR, build]) == build
    assert ".synth_merl" not in vmf.SYNTH_DIR.split(os.sep)
    # with no --data the tool bakes into SYNTH_DIR and validates that
    monkeypatch.setattr(vmf, "SYNTH_DIR", str(tmp_path / "synth"))
    monkeypatch.delenv("DJ_MERL_DATA", raising=False)
    assert vmf.main(["--device", "cpu", "--res", "16"]) == 0
    assert sorted(os.listdir(tmp_path / "synth")) == [
        "synth-beckmann-mid.binary", "synth-ggx-rough.binary",
        "synth-ggx-smooth.binary"]
    assert capsys.readouterr().out.count("not pinned") == 3


def test_pinned_copy_is_the_jax_tools():
    assert vmf.PINNED == os.path.join(ROOT, "dj_brdf_torch", "tools", "data",
                                      "expected_merl_alphas.json")
    jax_pinned = os.path.join(ROOT, "tools", "expected_merl_alphas.json")
    assert filecmp.cmp(vmf.PINNED, jax_pinned, shallow=False)


@pytest.mark.skipif("not torch.cuda.is_available()")
def test_validate_on_the_card(corpus, capsys):
    assert vmf.main(["--data", os.path.dirname(corpus[0])]) == 0
    assert capsys.readouterr().out.count("pinned ok") == 3
