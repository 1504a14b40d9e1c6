"""``frame.bsdf_launches``: the host's kernel- and graph-launch calls
inside the program's ``dj.render.bsdf`` spans (the fused BSDF
evaluations and samples of ``render/pathtrace.py``), over the frames
(the benchmark's ``render`` spans)."""


def read(trace, ctx, window):
    frames = len(trace.named("render"))
    if frames == 0 or not trace.named("dj.render.bsdf"):
        return None
    return trace.launches_in("dj.render.bsdf") / frames
