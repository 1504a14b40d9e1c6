"""``fit.kernels_roofline_pct``: the frozen bound of one GGX fit step
(``_counts.fit_step_bound_s``) times the steps run, over the device's
busy time (the union of its operations' intervals) of the operations
launched inside the benchmark's ``fit_materials`` spans, in %."""

from pathlib import Path

from benchmark.harness import load_module


def read(trace, ctx, window):
    jobs = len(trace.named("fit_materials"))
    busy = trace.busy_of("fit_materials")
    if jobs == 0 or busy <= 0.0:
        return None
    cfg = ctx.cell.config
    steps = jobs * ctx.cell.traffic["steps"]
    counts = load_module(Path(__file__).with_name("_counts.py"),
                         "benchmark_counts")
    bound = counts.fit_step_bound_s(cfg["materials"], cfg["directions"])
    return 100.0 * bound * steps / busy
