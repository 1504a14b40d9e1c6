"""``fit.targets_ms``: the median length of the benchmark's
``merl_targets`` spans (each ends in a synchronize in a traced run), in
ms; the median and the count are logged."""

import statistics


def read(trace, ctx, window):
    spans = trace.named("merl_targets")
    if not spans:
        return None
    ms = statistics.median(1e3 * s.length for s in spans)
    ctx.log(f"fit.targets_ms: median {ms!r} ms of {len(spans)} spans")
    return ms
