"""Tracing and throughput observability.

The reference's only observability is DJB_LOG printf's
(dj_brdf.h:557-560); here ``trace()`` captures a ``torch.profiler``
trace of the kernels (host and CUDA activity) into a Chrome trace file,
and ``Throughput`` is the items/s counter used around hot loops.

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
    ``logdir``. Yields the profiler, whose ``key_averages()`` sum the
    kernels by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
