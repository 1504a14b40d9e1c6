"""The benchmark's harness: finds a cell's files by the names in
``BENCHMARK.json``, runs its set-up, warm-up and measured window, reads
the traced window, has the cell's driver judge the answers against the
plain reference, and assembles the result line.

What is general lives here; what belongs to one configuration, one
traffic mix or one per-layer metric lives in files of its own:

- ``configs/<config>.json``: the deployment's sizes, its source and
  what was assumed (the ``file`` of the configuration's entry);
- ``traffic/<traffic>.json``: one traffic mix's parameters, among them
  the ``driver`` that runs it, its end-to-end statistics, the answers
  sampled for the check and each compared number's limit;
- ``drivers/<driver>.py``: one kind of unit of work (a fit job, a
  tabulation call, a frame) with its set-up, warm-up, unit and check;
- ``reference/<config>.py``: the configuration's plain reference;
- ``metrics/<metric>.py``: one per-layer metric's reader of the trace.

A new cell is new files plus new entries in ``BENCHMARK.json``; no file
here needs an edit.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: modules that no process of the benchmark may hold, compared by their
#: whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "dj_brdf_tpu")


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module named ``name``."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """The forbidden top-level names that ``sys.modules`` holds."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one stream, drawn from the run's ``seed`` and
    the stream's ``keys`` (a unit's index, a purpose)."""
    ss = np.random.SeedSequence([seed % (1 << 64), *keys])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, *keys: int, device="cuda") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *keys))


class Reservoir:
    """``k`` units kept uniformly from a window whose length is not
    known in advance (reservoir sampling), the draws from the seed: the
    kept units span the whole window, not its start."""

    def __init__(self, seed: int, purpose: int, k: int):
        self.rng = np.random.default_rng(sub_seed(seed, purpose))
        self.k = k
        self.kept: dict[int, object] = {}
        self.seen = 0

    def offer(self, unit: int, answer) -> None:
        if self.seen < self.k:
            self.kept[unit] = answer
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                del self.kept[sorted(self.kept)[j]]
                self.kept[unit] = answer
        self.seen += 1


def sample_indices(seed: int, purpose: int, population: int, k: int):
    """``k`` distinct indices of ``range(population)`` drawn from the
    seed (all of them where ``k`` is not smaller), sorted."""
    rng = np.random.default_rng(sub_seed(seed, purpose))
    k = min(k, population)
    return sorted(int(x) for x in rng.choice(population, k, replace=False))


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    driver: object = None
    reference: object = None


def resolve(spec: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` of the ``BENCHMARK.json`` content
    ``spec``, its configuration, traffic, driver, reference and the
    metrics it reports."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json")
                         .read_text())

    def reports(metric):
        return workload in metric.get("workloads", [workload])

    end_to_end = [m for m in spec["end_to_end"] if reports(m)]
    e2e_names = {m["name"] for m in end_to_end}
    per_layer = [m for m in spec["per_layer"] if reports(m)
                 and m["moves"] in e2e_names]
    cell = Cell(workload, int(w["chips"]), config, traffic, end_to_end,
                per_layer)
    driver = traffic["driver"]
    cell.driver = load_module(BENCH_DIR / "drivers" / f"{driver}.py",
                              f"benchmark_driver_{driver}")
    cell.reference = load_module(BENCH_DIR / "reference"
                                 / f"{w['config']}.py",
                                 f"benchmark_reference_{w['config']}")
    return cell


class Spans:
    """The benchmark's own spans around its calls into the program: in a
    traced window ``record_function`` ranges, which the trace's readers
    find by name; a span may end in a synchronize."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.profiling = False

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = False):
        ctx = (torch.profiler.record_function(name) if self.profiling
               else contextlib.nullcontext())
        with ctx:
            yield
            if sync:
                self.sync()


@dataclass
class Context:
    """What a driver gets: the cell, the run's seed, the device, the
    spans, and whether the control takes the program's place."""
    cell: Cell
    seed: int
    device: torch.device
    spans: Spans
    control: bool = False
    trace: bool = False
    log: object = field(default=lambda msg: print(msg, file=sys.stderr,
                                                  flush=True))


@dataclass
class Window:
    """The records of a window's units and its length in seconds."""
    records: list
    seconds: float


def measure(ctx: Context, state, seconds: float, units: int | None = None,
            first: int = 0):
    """The closed loop: one unit after another (numbered from
    ``first``), each started only when the last one's answer is back,
    until ``seconds`` have passed (or ``units`` have run). The window
    ends when the last unit's answer is back, so a rate counts all the
    work and all the time."""
    driver = ctx.cell.driver
    records = []
    t0 = time.perf_counter()
    with ctx.spans("window"):
        k = first
        while time.perf_counter() - t0 < seconds and (
                units is None or k - first < units):
            records.append(driver.unit(ctx, state, k))
            k += 1
    return Window(records, time.perf_counter() - t0)


def end_to_end(cell: Cell, window: Window, setup_s: float) -> dict:
    """The cell's end-to-end metrics from the window's records: a rate
    is the items of every unit over the whole window, a percentile that
    of every unit's latency."""
    items = sum(r["items"] for r in window.records)
    lat_ms = [1e3 * r["latency_s"] for r in window.records]
    out = {}
    for metric in cell.end_to_end:
        name = metric["name"]
        if name == "setup_s":
            value = setup_s
        else:
            stat = cell.traffic["end_to_end"][name]
            if stat["kind"] == "rate":
                value = items / window.seconds
            elif stat["kind"] == "latency_percentile":
                value = float(np.percentile(lat_ms, stat["q"]))
            else:
                raise ValueError(f"unknown statistic {stat['kind']!r}")
        out[name] = {"value": value, "unit": metric["unit"]}
    return out


def judge(cell: Cell, numbers: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit (from the traffic file);
    correct when every number is finite and within its limit."""
    limits = cell.traffic["limits"]
    if set(numbers) != set(limits):
        raise KeyError(f"compared {sorted(numbers)}, limits for "
                       f"{sorted(limits)}")
    checks = {name: {"value": float(numbers[name]),
                     "limit": float(limits[name])} for name in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def device_record(device, chips: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0)),
            "power_limit_w": power_limit_w()}


def power_limit_w() -> float | None:
    """The first card's power limit, as ``nvidia-smi`` reads it (None
    where it cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: bool = False, log=None) -> dict:
    """One run of the cell: set-up and warm-up (``setup_s`` counts from
    ``t_start``), the window, the trace's readers, the check. Returns the
    result line's object."""
    device = torch.device(device)
    spans = Spans(device)
    ctx = Context(cell, seed, device, spans, control=control, trace=trace)
    if log is not None:
        ctx.log = log
    driver = cell.driver
    t0 = time.perf_counter()
    state = driver.setup(ctx)
    spans.sync()
    t1 = time.perf_counter()
    driver.warmup(ctx, state)
    spans.sync()
    setup_s = time.perf_counter() - t_start
    ctx.log(f"set-up: {setup_s!r} s, of which {t0 - t_start!r} before the "
            f"driver, {t1 - t0!r} in its set-up, {time.perf_counter() - t1!r}"
            f" in its warm-up")

    if trace:
        from benchmark import trace as trace_mod

        window, traced = trace_mod.traced_window(
            ctx, state, seconds, cell.traffic["trace_units"])
    else:
        window = measure(ctx, state, seconds)
    dev = device_record(device, cell.chips)
    result = {"correct": False, "attempted": len(window.records),
              "failed": 0, "metrics": {}, "device": dev}
    if trace:
        result["metrics"] = trace_mod.per_layer(ctx, traced, window)
        dev["busy_s"], dev["window_s"] = traced.device_busy_window()
        result["breakdown"] = traced.breakdown()
    else:
        result["metrics"] = end_to_end(cell, window, setup_s)

    inputs = driver.release(ctx, state)
    del state
    t_check = time.perf_counter()
    numbers, failed = driver.check(ctx, inputs, window.records)
    ctx.log(f"check: {time.perf_counter() - t_check!r} s for "
            f"{len(window.records)} units")
    ok, checks = judge(cell, numbers)
    result["failed"] = failed
    result["correct"] = bool(ok and failed == 0)
    result["checks"] = checks
    return result
