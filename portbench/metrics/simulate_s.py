"""Seconds a sweep spends in its request and result drains: ``run_sweep``'s
own synchronised stage spans; the window's mean."""


def read(ctx):
    return sum(s["stats"]["simulate_s"]
               + (s["stats"].get("result_simulate_s") or 0.0)
               for s in ctx.sweeps) / len(ctx.sweeps)
