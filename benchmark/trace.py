"""The traced run: the cell's loop in three passes, and the reading of
the traces.

1. A plain pass, unprofiled, as long as an untraced run's window: the
   host's seconds a unit as an untraced run spends them (over a shorter
   pass they swing with the host, by a fifth between 2 s slices).
2. A host pass of ``trace_units`` units under ``torch.profiler``
   recording the host's operators and runtime calls and the device's
   kernels, copies and sets (CUPTI): spans, launches, the device time
   of what a span launched, the breakdown.
3. A device pass of as many units recording the device's activity
   alone: its busy time over that pass's length on the host's clock,
   from a synchronize before its first unit to one after its last
   (``busy_s``, ``window_s``).

Recording slows a host-bound loop: a unit of the host pass, which
records every operator, took 1.5-2.1 times a plain one on an H100's
host, and of the device pass, by CUPTI's record of each launch,
1.15-1.8 times. So the
device's idle share is read against the plain pass: one minus the
device pass's busy time a unit over the plain pass's seconds a unit.

Each trace is exported once to a temporary file (in ``TMPDIR``), read
back as plain events and deleted. What the readers under ``metrics/``
get is a :class:`Trace` of the host pass:

- ``ops``: the device's operations (kernels, copies, sets);
- ``launches``: the host's kernel- and graph-launch calls;
- ``spans``: the benchmark's own spans (``record_function`` ranges
  named as in the drivers: ``window``, ``make_inputs``,
  ``merl_targets``, ``fit_materials``, ``tabulate_merl_batch``,
  ``render``, ``readback``);

each with start and length in seconds on the trace's one clock; and
``device``, the device pass's (busy, length, units), and
``plain_unit_s``, the plain pass's seconds a unit.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass

import torch

from benchmark.harness import BENCH_DIR, Window, load_module, measure

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_WORDS = ("LaunchKernel", "GraphLaunch", "LaunchCooperativeKernel")


def union(intervals) -> list[tuple[float, float]]:
    """Merged (start, end) intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(intervals) -> float:
    return sum(b - a for a, b in union(intervals))


@dataclass
class Op:
    name: str
    start: float
    length: float
    corr: int | None


class Trace:
    """The events of one traced window (seconds)."""

    @staticmethod
    def device_ops(events) -> list[Op]:
        """The device's operations among the trace's ``events``."""
        return [Op(ev.get("name", ""), float(ev["ts"]) * 1e-6,
                   float(ev.get("dur", 0.0)) * 1e-6, None)
                for ev in events
                if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS]

    def __init__(self, events):
        self.ops: list[Op] = []
        self.launches: list[Op] = []
        self.spans: list[Op] = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            args = ev.get("args") or {}
            op = Op(ev.get("name", ""), float(ev["ts"]) * 1e-6,
                    float(ev.get("dur", 0.0)) * 1e-6,
                    args.get("correlation"))
            if cat in DEVICE_CATS:
                self.ops.append(op)
            elif cat in ("cuda_runtime", "cuda_driver"):
                if any(w in op.name for w in LAUNCH_WORDS):
                    self.launches.append(op)
            elif cat == "user_annotation":
                self.spans.append(op)
        self.ops.sort(key=lambda o: o.start)
        self.launches.sort(key=lambda o: o.start)
        self.spans.sort(key=lambda o: o.start)
        self._launch_at = {o.corr: o.start for o in self.launches
                           if o.corr is not None}
        win = [s for s in self.spans if s.name == "window"]
        if not win:
            raise ValueError("the trace holds no 'window' span")
        self.window = (win[0].start, win[0].start + win[0].length)
        #: (busy, length, units) of the pass that recorded the device
        #: alone, and the plain pass's seconds a unit (None where there
        #: was no such pass: this trace's own window stands in)
        self.device: tuple[float, float, int] | None = None
        self.plain_unit_s: float | None = None

    # -- the window --------------------------------------------------
    def window_ops(self):
        a, b = self.window
        return [(max(o.start, a), min(o.start + o.length, b))
                for o in self.ops if o.start < b and o.start + o.length > a]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return covered(self.window_ops())

    def device_busy_window(self) -> tuple[float, float]:
        """(busy, length) of the device's window in seconds."""
        return self.device[:2] if self.device else (self.busy_s,
                                                    self.window_s)

    def idle_pct(self) -> float | None:
        """The device's idle share in %: of a plain unit's seconds,
        where there was a plain pass; else of this trace's window."""
        if self.device and self.plain_unit_s:
            busy, _, units = self.device
            if busy <= 0.0:
                return None
            return 100.0 * (1.0 - busy / units / self.plain_unit_s)
        busy, wall = self.device_busy_window()
        return None if busy <= 0.0 else 100.0 * (1.0 - busy / wall)

    # -- spans -------------------------------------------------------
    def named(self, name: str) -> list[Op]:
        return [s for s in self.spans if s.name == name]

    def launches_per(self, name: str, per_span: int = 1) -> float | None:
        """The launch calls inside the spans ``name`` over the spans
        times ``per_span`` (None where there is no such span)."""
        spans = len(self.named(name))
        return (None if spans == 0
                else self.launches_in(name) / (spans * per_span))

    def launches_in(self, name: str) -> int:
        """The launch calls made while a span ``name`` was open."""
        starts = [o.start for o in self.launches]
        n = 0
        for s in self.named(name):
            n += (bisect.bisect_right(starts, s.start + s.length)
                  - bisect.bisect_left(starts, s.start))
        return n

    def ops_of(self, name: str) -> list[Op]:
        """The device operations launched while a span ``name`` was
        open (by their launch call's correlation; by their own start
        where the trace holds no launch call for them)."""
        spans = [(s.start, s.start + s.length) for s in self.named(name)]
        starts = [a for a, _ in spans]

        def inside(t):
            j = bisect.bisect_right(starts, t) - 1
            return j >= 0 and t <= spans[j][1]

        return [o for o in self.ops
                if inside(self._launch_at.get(o.corr, o.start))]

    def busy_of(self, name: str) -> float:
        return covered((o.start, o.start + o.length)
                       for o in self.ops_of(name))

    def host_at(self, t: float) -> str:
        """The innermost benchmark span open at ``t`` other than the
        window ("harness" where none is)."""
        best = None
        for s in self.spans:
            if s.start > t:
                break
            if s.name != "window" and s.start + s.length >= t and (
                    best is None or s.start >= best.start):
                best = s
        return best.name if best is not None else "harness"

    # -- the breakdown -------------------------------------------------
    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, by name, and
        the device's idle time inside the window by what the host was
        doing when each gap began."""
        by_op: dict[str, float] = defaultdict(float)
        a, b = self.window
        for o in self.ops:
            if a <= o.start < b:
                by_op[o.name[:120]] += o.length
        gaps: dict[str, float] = defaultdict(float)
        last = a
        for s, e in union(self.window_ops()) + [(b, b)]:
            if s > last:
                gaps[self.host_at(last)] += s - last
            last = max(last, e)
        order = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order],
                "idle_gaps": [[k, v] for k, v in idle]}


def _profiled(ctx, acts, body):
    """Run ``body()`` under the profiler recording ``acts``; returns its
    value and the trace's events."""
    with torch.profiler.profile(activities=acts, record_shapes=False,
                                with_stack=False) as prof:
        value = body()
        ctx.spans.sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return value, events


def traced_window(ctx, state, seconds: float, units: int):
    """Run the loop plain for ``seconds``, then ``units`` units (at most
    ``seconds``) under the profiler with the host's activity, then as
    many with the device's alone;
    returns the records of all three and the :class:`Trace` of the host
    pass with the device pass's window and the plain pass's seconds a
    unit."""
    cuda = ctx.device.type == "cuda"
    host = [torch.profiler.ProfilerActivity.CPU]
    ctx.spans.sync()
    plain = measure(ctx, state, seconds)
    ctx.spans.profiling = True
    window, events = _profiled(
        ctx, host + [torch.profiler.ProfilerActivity.CUDA] if cuda else host,
        lambda: measure(ctx, state, seconds, units,
                        first=len(plain.records)))
    ctx.spans.profiling = False
    trace = Trace(events)

    def device_pass():
        ctx.spans.sync()
        t0 = time.perf_counter()
        second = measure(ctx, state, seconds, units,
                         first=len(plain.records) + len(window.records))
        ctx.spans.sync()
        return second, time.perf_counter() - t0

    (second, wall), events = _profiled(
        ctx, [torch.profiler.ProfilerActivity.CUDA] if cuda else host,
        device_pass)
    busy = covered((o.start, o.start + o.length)
                   for o in Trace.device_ops(events))
    n0, n1, n2 = len(plain.records), len(window.records), len(second.records)
    trace.device = (busy, wall, n2)
    trace.plain_unit_s = plain.seconds / n0
    ctx.log(f"trace: seconds a unit, plain {plain.seconds / n0!r} over "
            f"{n0}, host pass {window.seconds / n1!r} over {n1}, device "
            f"pass {wall / n2!r} over {n2}; the device busy "
            f"{busy / n2!r} s a unit")
    records = plain.records + window.records + second.records
    return Window(records, plain.seconds + window.seconds
                  + second.seconds), trace


def reader_path(name: str):
    """The reader of the per-layer metric ``name``: ``metrics/<name>.py``,
    or, where there is none, the reader that the cells' groups of a
    split quantity share, ``metrics/<name after its first dot>.py``
    (``fit.device_idle_pct`` -> ``device_idle_pct.py``)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        path = BENCH_DIR / "metrics" / f"{name.split('.', 1)[1]}.py"
    return path


def per_layer(ctx, trace: Trace, window) -> dict:
    """Each per-layer metric of the cell from its reader (see
    :func:`reader_path`); a reader that finds nothing to read returns
    None and its metric is left out."""
    out = {}
    for metric in ctx.cell.per_layer:
        reader = load_module(reader_path(metric["name"]),
                             f"benchmark_metric_{metric['name']}")
        value = reader.read(trace, ctx, window)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out
