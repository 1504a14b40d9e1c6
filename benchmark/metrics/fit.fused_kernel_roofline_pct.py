"""``fit.fused_kernel_roofline_pct``: the frozen bound of one GGX fit
step (``_counts.fit_step_bound_s``) times the program's
``dj.fit.kernel`` spans (one a step, around the fused kernel's call in
``ops/fused_fit.py::fwdbwd_sums``), over the device's busy time of the
operations launched inside them, in %: the fused kernel alone, without
the step's glue."""

from pathlib import Path

from benchmark.harness import load_module


def read(trace, ctx, window):
    calls = len(trace.named("dj.fit.kernel"))
    busy = trace.busy_of("dj.fit.kernel")
    if calls == 0 or busy <= 0.0:
        return None
    cfg = ctx.cell.config
    counts = load_module(Path(__file__).with_name("_counts.py"),
                         "benchmark_counts")
    bound = counts.fit_step_bound_s(cfg["materials"], cfg["directions"])
    return 100.0 * bound * calls / busy
