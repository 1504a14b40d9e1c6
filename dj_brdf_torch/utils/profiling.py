"""Tracing and throughput observability.

The reference's only observability is DJB_LOG printf's
(dj_brdf.h:557-560); here ``trace()`` captures a ``torch.profiler``
trace of the kernels (host and CUDA activity) into a Chrome trace file,
``span()`` names the program's own stages inside such a trace, and
``Throughput`` is the items/s counter used around hot loops.

Counterpart of ``dj_brdf_tpu/utils/profiling.py``: ``jax.profiler.trace``
becomes ``torch.profiler``, ``jax.block_until_ready`` a synchronise of
the tensor's CUDA device.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write ``trace.json`` (Chrome
    trace format, viewable in Perfetto or chrome://tracing) into
    ``logdir``, with the program's :data:`SPANS` among its events.
    Yields the profiler, whose ``key_averages()`` sum the kernels by
    name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


#: every span the program opens (:func:`span`), by name: a fit step
#: (``fit/lsq.py::adam_loop``) and its fused kernel call
#: (``ops/fused_fit.py::fwdbwd_sums``); a MERL lookup
#: (``models/merl.py``); the tabulation's stages
#: (``fit/tabular.py::build_tabular``) and its moment fits
#: (``fit/batch.py::tabulate_merl_batch``); a path tracer's bounce, its
#: BSDF evaluations and samples, its intersections and its environment
#: map's draws, lookups and MIS weights (``render/pathtrace.py``). Each
#: starts with ``dj.``, so that none equals a span a caller opens
#: around its calls into the package.
SPANS = ("dj.fit.step", "dj.fit.kernel", "dj.merl.lookup",
         "dj.tab.kernel_matrix", "dj.tab.power", "dj.tab.sigma",
         "dj.tab.fresnel", "dj.tab.cdf", "dj.tab.moments",
         "dj.render.bounce", "dj.render.bsdf", "dj.render.intersect",
         "dj.render.envmap")

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` (one of :data:`SPANS`)
    while a profiler records on this thread, else a shared context that
    does nothing.

    The range is the profiler's own ``user_annotation`` event, in the
    same trace and on the same clock as the device's kernels, so
    ``trace()``'s file shows each span beside the kernels launched
    inside it, nested in the spans open around it. With no profiler
    running a span costs a check of the profiler's state and an empty
    ``with``, under 1 us, where an idle ``record_function`` costs
    ~12 us."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class Throughput:
    """Minimal steady-state items/s meter with device sync.

    >>> meter = Throughput(items_per_call=n)
    >>> with meter:  # repeatedly
    ...     out = step(...)
    ...     meter.sync(out)
    >>> meter.rate()
    """

    def __init__(self, items_per_call: int):
        self.items_per_call = items_per_call
        self.calls = 0
        self.elapsed = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def sync(self, out) -> None:
        """Wait for the device that computes ``out`` (a tensor, or a
        tuple or list of them): a CUDA tensor's device is synchronised,
        a CPU tensor is already done."""
        tensors = out if isinstance(out, (tuple, list)) else (out,)
        for dev in {t.device for t in tensors if isinstance(t, torch.Tensor)
                    and t.device.type == "cuda"}:
            torch.cuda.synchronize(dev)

    def __exit__(self, *exc):
        self.elapsed += time.perf_counter() - self._t0
        self.calls += 1
        return False

    def rate(self) -> float:
        return self.items_per_call * self.calls / max(self.elapsed, 1e-12)
