"""``frame.bounce_launches``: the host's kernel- and graph-launch calls
inside the program's ``dj.render.bounce`` spans (one around each bounce
of the path tracer's loop, ``render/pathtrace.py``), over those spans."""


def read(trace, ctx, window):
    return trace.launches_per("dj.render.bounce")
