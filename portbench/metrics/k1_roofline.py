"""The router kernel's share of its roofline: the traced sweeps' least
bytes (``counts/k1_router.py``) at the HBM rate over its device seconds
in the trace, in %."""

from harness.trace import roofline


def read(ctx):
    return roofline(ctx, "k1_router")
