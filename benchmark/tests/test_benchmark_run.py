"""The command's refusals, and the trace's reading on a made-up trace."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest

from benchmark import trace
from conftest import ROOT


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "merl100.fit",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, text=True, capture_output=True, timeout=300, env=env)


def test_no_card_no_result():
    """Without a card (or with the program missing) the command exits
    non-zero and prints no result line."""
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and benchmark/ gives no
    result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _ev(cat, name, ts, dur, corr=None):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {} if corr is None else {"correlation": corr}}


@pytest.fixture
def made_up():
    """A window of 100 us: a render span (10-60) launching two kernels
    (20-40, 30-50 on the device), a readback span (60-90) with one copy
    (70-80)."""
    return trace.Trace([
        _ev("user_annotation", "window", 0, 100),
        _ev("user_annotation", "render", 10, 50),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 14, 1, 2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 61, 1, 3),
        _ev("kernel", "k_a", 20, 20, 1),
        _ev("kernel", "k_b", 30, 20, 2),
        _ev("user_annotation", "readback", 60, 30),
        _ev("gpu_memcpy", "Memcpy DtoH", 70, 10, 3),
        _ev("cpu_op", "aten::mul", 11, 1),
    ])


def test_trace_busy_idle_and_launches(made_up):
    assert made_up.window_s == pytest.approx(100e-6)
    assert made_up.busy_s == pytest.approx(40e-6)
    assert made_up.idle_pct() == pytest.approx(60.0)
    assert made_up.launches_in("render") == 2
    assert made_up.launches_in("readback") == 0
    assert made_up.busy_of("render") == pytest.approx(30e-6)
    assert made_up.busy_of("readback") == pytest.approx(10e-6)


def test_trace_breakdown(made_up):
    b = made_up.breakdown()
    assert b["device_ops"][0] == ["k_a", pytest.approx(20e-6)]
    gaps = dict(b["idle_gaps"])
    # 0-20 (harness 0-10, but a gap is named by its start: harness),
    # 50-70 (render until 60: named render), 80-100 (readback)
    assert gaps["harness"] == pytest.approx(20e-6)
    assert gaps["render"] == pytest.approx(20e-6)
    assert gaps["readback"] == pytest.approx(20e-6)


def test_roofline_reader_bounded(made_up):
    """The fit's roofline reader reads nothing where no fit ran."""
    from benchmark import harness

    reader = harness.load_module(ROOT / "benchmark" / "metrics"
                                 / "fit.kernels_roofline_pct.py", "r")
    assert reader.read(made_up, None, None) is None


def test_reservoir_keeps_units_from_the_whole_window():
    """The answers kept for the check span the window, not its start,
    and the same seed keeps the same units."""
    from benchmark.harness import Reservoir

    def kept(seed, n=600, k=3):
        r = Reservoir(seed, 7, k)
        for unit in range(n):
            r.offer(unit, unit * 10)
        assert len(r.kept) == min(k, n) and all(v == u * 10
                                        for u, v in r.kept.items())
        return sorted(r.kept)

    assert kept(2**31 + 9) == kept(2**31 + 9)
    units = [u for s in range(200) for u in kept(s)]
    assert 250 < sum(units) / len(units) < 350
    assert sum(u >= 300 for u in units) > 0.4 * len(units)
    assert kept(5, n=2) == [0, 1]
