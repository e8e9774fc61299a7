"""Seconds a sweep spends in the forward pass and its operand layout, from
the benchmark's synchronised ``portbench/forward`` span; the window's
mean."""


def read(ctx):
    return sum(s["forward_s"] for s in ctx.sweeps) / len(ctx.sweeps)
