"""The readers of the per-layer metrics that read the program's own
spans (``dj.*``, opened inside ``dj_brdf_torch``), on made-up traces:
spans nested in the benchmark's and in each other, launch calls inside
them, and device operations that run after their span has closed on
the host, found by their launch call's correlation."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness, trace
from conftest import ROOT

METRICS = ROOT / "benchmark" / "metrics"
CONFIG = {"materials": 100, "directions": 1458000}
CTX = SimpleNamespace(cell=SimpleNamespace(config=CONFIG, traffic={}),
                      log=lambda msg: None)


def reader(name):
    return harness.load_module(METRICS / f"{name}.py",
                               f"benchmark_metric_{name}")


class Events:
    """A made-up trace's events (us); each launch call gets the next
    correlation id, and its kernel runs on the device when asked."""

    def __init__(self):
        self.events = [self.ev("user_annotation", "window", 0, 10_000)]
        self.corr = 0

    @staticmethod
    def ev(cat, name, ts, dur, corr=None):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {} if corr is None else {"correlation": corr}}

    def span(self, name, ts, dur):
        self.events.append(self.ev("user_annotation", name, ts, dur))

    def launch(self, ts, kernel_at=None, kernel_us=0.0):
        self.corr += 1
        self.events.append(self.ev("cuda_runtime", "cudaLaunchKernel", ts,
                                   1, self.corr))
        if kernel_at is not None:
            self.events.append(self.ev("kernel", f"k{self.corr}", kernel_at,
                                       kernel_us, self.corr))

    def trace(self):
        return trace.Trace(self.events)


@pytest.fixture
def fit_trace():
    """One job: two fit steps inside ``fit_materials``, each holding
    one fused kernel call whose kernel runs after the step has closed
    (100 us and 80 us), Adam's own range nested in the first step; a
    launch between the steps; one lookup of two overlapping kernels
    (30 us together) inside ``merl_targets``."""
    e = Events()
    e.span("merl_targets", 10, 80)
    e.span("dj.merl.lookup", 20, 50)
    e.launch(25, kernel_at=700, kernel_us=10)
    e.launch(30, kernel_at=705, kernel_us=25)
    e.span("fit_materials", 100, 400)
    e.span("dj.fit.step", 110, 100)
    e.launch(115)
    e.span("dj.fit.kernel", 118, 20)
    e.launch(120, kernel_at=800, kernel_us=100)
    e.launch(150)
    e.span("Optimizer.step#Adam.step", 160, 40)
    e.launch(170)
    e.launch(250)
    e.span("dj.fit.step", 300, 100)
    e.launch(305)
    e.span("dj.fit.kernel", 308, 20)
    e.launch(310, kernel_at=900, kernel_us=80)
    e.launch(340)
    return e.trace()


@pytest.fixture
def tabulate_trace():
    """Two calls: the Fresnel stage launches 3 then 5 (2 of them inside
    a nested lookup each time), the moment fits 2 then 4."""
    e = Events()
    for t0, fres, mom in ((0, 3, 2), (1000, 5, 4)):
        e.span("tabulate_merl_batch", t0, 900)
        e.span("dj.tab.kernel_matrix", t0 + 10, 80)
        e.launch(t0 + 20)
        e.span("dj.tab.fresnel", t0 + 100, 300)
        e.span("dj.merl.lookup", t0 + 110, 50)
        e.launch(t0 + 120)
        e.launch(t0 + 130)
        for k in range(fres - 2):
            e.launch(t0 + 200 + 10 * k)
        e.span("dj.tab.moments", t0 + 500, 300)
        for k in range(mom):
            e.launch(t0 + 510 + 10 * k)
    return e.trace()


@pytest.fixture
def frame_trace():
    """Two frames of three bounces, each bounce launching 10 calls: 4
    inside a BSDF span, 1 inside an intersection, and under the map 2
    inside an environment span whose kernels run 30 us each after the
    frame's host work; 1 launch outside the bounces a frame."""
    def frames(envmap):
        e = Events()
        for f in range(2):
            t0 = 3000 * f
            e.span("render", t0, 1000)
            for b in range(3):
                tb = t0 + 10 + 300 * b
                e.span("dj.render.bounce", tb, 250)
                e.span("dj.render.intersect", tb + 1, 20)
                e.launch(tb + 2)
                e.span("dj.render.bsdf", tb + 30, 100)
                for k in range(4):
                    e.launch(tb + 31 + k)
                if envmap:
                    e.span("dj.render.envmap", tb + 150, 50)
                    for k in range(2):
                        e.launch(tb + 151 + k,
                                 kernel_at=t0 + 1100 + 200 * b + 50 * k,
                                 kernel_us=30)
                for k in range(10 - 5 - 2 * envmap):
                    e.launch(tb + 210 + k)
            e.launch(t0 + 950)
        return e.trace()
    return frames


def test_fit_readers(fit_trace):
    """Launches a step (4 in the first, 3 in the second), the fused
    kernel's share of its bound over the kernels launched in its spans
    (180 us), the lookup's device time (30 us)."""
    counts = harness.load_module(METRICS / "_counts.py", "benchmark_counts")
    assert reader("fit.step_launches").read(fit_trace, CTX, None) == 3.5
    bound = counts.fit_step_bound_s(100, 1458000)
    assert reader("fit.fused_kernel_roofline_pct").read(
        fit_trace, CTX, None) == pytest.approx(100.0 * 2 * bound / 180e-6)
    assert reader("fit.lookup_device_ms").read(
        fit_trace, CTX, None) == pytest.approx(0.030)


def test_tabulate_readers(tabulate_trace):
    assert reader("tabulate.fresnel_launches").read(
        tabulate_trace, CTX, None) == 4.0
    assert reader("tabulate.moments_launches").read(
        tabulate_trace, CTX, None) == 3.0


@pytest.mark.parametrize("envmap", (False, True))
def test_frame_readers(frame_trace, envmap):
    t = frame_trace(envmap)
    assert reader("frame.bounce_launches").read(t, CTX, None) == 10.0
    assert reader("frame.bsdf_launches").read(t, CTX, None) == 12.0
    ms = reader("frame.envmap_device_ms").read(t, CTX, None)
    if envmap:
        # 3 bounces x 2 kernels x 30 us a frame, none overlapping
        assert ms == pytest.approx(0.180)
    else:
        assert ms is None


READERS = ("fit.step_launches", "fit.fused_kernel_roofline_pct",
           "fit.lookup_device_ms", "tabulate.fresnel_launches",
           "tabulate.moments_launches", "frame.bounce_launches",
           "frame.bsdf_launches", "frame.envmap_device_ms")


@pytest.mark.parametrize("name", READERS)
def test_reader_without_its_span(name):
    """A program without the spans (the parent of the change that
    added them) gives no reading, and no error: a trace of the
    benchmark's own spans, launches and kernels alone."""
    e = Events()
    for unit in ("merl_targets", "fit_materials", "tabulate_merl_batch",
                 "render"):
        e.span(unit, 100, 500)
    e.launch(200, kernel_at=300, kernel_us=50)
    assert reader(name).read(e.trace(), CTX, None) is None
