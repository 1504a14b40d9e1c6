"""``frame.launches_per_frame``: the host's kernel- and graph-launch
calls inside the benchmark's ``render`` spans, over the frames."""


def read(trace, ctx, window):
    return trace.launches_per("render")
