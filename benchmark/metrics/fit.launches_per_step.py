"""``fit.launches_per_step``: the host's kernel- and graph-launch calls
inside the benchmark's ``fit_materials`` spans, over the steps run."""


def read(trace, ctx, window):
    return trace.launches_per("fit_materials", ctx.cell.traffic["steps"])
