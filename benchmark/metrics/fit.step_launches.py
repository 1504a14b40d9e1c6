"""``fit.step_launches``: the host's kernel- and graph-launch calls
inside the program's ``dj.fit.step`` spans (one around each Adam step
of ``fit/lsq.py::adam_loop``), over those spans: a step's launches
without the job's set-up around the steps."""


def read(trace, ctx, window):
    return trace.launches_per("dj.fit.step")
