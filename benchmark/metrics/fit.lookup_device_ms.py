"""``fit.lookup_device_ms``: the device's busy time of the operations
launched inside the program's ``dj.merl.lookup`` spans (its index maths
and lookup kernels, ``models/merl.py::Merl._lookup``), over those
spans, in ms: the lookup's device time, without the host's."""


def read(trace, ctx, window):
    spans = len(trace.named("dj.merl.lookup"))
    busy = trace.busy_of("dj.merl.lookup")
    if spans == 0 or busy <= 0.0:
        return None
    return 1e3 * busy / spans
