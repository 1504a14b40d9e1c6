"""``tabulate.moments_launches``: the host's kernel- and graph-launch
calls inside the program's ``dj.tab.moments`` spans (both moment fits of
``fit/batch.py::tabulate_merl_batch``), over those spans (one a
call)."""


def read(trace, ctx, window):
    return trace.launches_per("dj.tab.moments")
