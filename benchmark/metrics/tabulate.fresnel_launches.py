"""``tabulate.fresnel_launches``: the host's kernel- and graph-launch
calls inside the program's ``dj.tab.fresnel`` spans (the Fresnel points
stage of ``fit/tabular.py::build_tabular``), over those spans (one a
call)."""


def read(trace, ctx, window):
    return trace.launches_per("dj.tab.fresnel")
