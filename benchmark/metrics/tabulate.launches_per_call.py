"""``tabulate.launches_per_call``: the host's kernel- and graph-launch
calls inside the benchmark's ``tabulate_merl_batch`` spans, over the
calls."""


def read(trace, ctx, window):
    return trace.launches_per("tabulate_merl_batch")
