"""``frame.envmap_device_ms``: the device's busy time of the operations
launched inside the program's ``dj.render.envmap`` spans (the map's
draws, cell lookups, row gathers and MIS weights in
``render/pathtrace.py``), over the frames (the benchmark's ``render``
spans), in ms."""


def read(trace, ctx, window):
    frames = len(trace.named("render"))
    busy = trace.busy_of("dj.render.envmap")
    if frames == 0 or busy <= 0.0:
        return None
    return 1e3 * busy / frames
