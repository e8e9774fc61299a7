"""The chain kernel's share of its roofline: the least operations of the
chains the traced sweeps need (``counts/k6_chain.py``) over its device
seconds in the trace, in %."""

from harness.trace import roofline


def read(ctx):
    return roofline(ctx, "k6_chain")
