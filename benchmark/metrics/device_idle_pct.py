"""``<group>.device_idle_pct``, the reader that every cell's group of
the split quantity shares: the device's idle share of an untraced
unit, in %: one minus the device's busy time a unit (from the pass that
records the device alone) over the seconds a unit of the plain,
unprofiled pass, so that the profiler's host cost does not read as
idle (``trace.Trace.idle_pct``)."""


def read(trace, ctx, window):
    return trace.idle_pct()
