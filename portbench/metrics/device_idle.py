"""The share of the traced window in which no operation ran on the device
(the window minus the union of the profiler's device activity), in %."""

from harness.trace import busy_s


def read(ctx):
    w = ctx.trace.window_s
    return 100.0 * (w - busy_s(ctx.trace)) / w if w > 0 else None
