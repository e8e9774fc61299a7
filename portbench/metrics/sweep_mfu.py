"""The whole sweep's share of the card's peak: the least time of the
window's counted work at the published peaks (``counts/forward.py``,
``k1_router.py``, ``k6_chain.py``; each stage bounded alone, as the sweep
runs them one after another) over the sweeps' seconds, in %."""

from harness.cells import load_module

COUNTS = ("forward", "k1_router", "k6_chain")


def read(ctx):
    mods = [load_module("counts", c) for c in COUNTS]
    least = sum(m.least_seconds(ctx, s) for s in ctx.sweeps for m in mods)
    wall = sum(s["wall_s"] for s in ctx.sweeps)
    return 100.0 * least / wall if wall > 0 else None
