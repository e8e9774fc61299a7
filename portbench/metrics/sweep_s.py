"""Sweep turnaround: all the window's sweep seconds (host clock, the
device synchronised at each sweep's start and end) over its completed
sweeps."""


def read(ctx):
    return sum(s["wall_s"] for s in ctx.sweeps) / len(ctx.sweeps)
