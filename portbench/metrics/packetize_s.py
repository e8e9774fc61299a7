"""Seconds a sweep spends ordering and packetizing (request and result
phases): ``run_sweep``'s own synchronised stage spans; the window's
mean."""


def read(ctx):
    return sum(s["stats"]["packetize_s"]
               + (s["stats"].get("result_packetize_s") or 0.0)
               for s in ctx.sweeps) / len(ctx.sweeps)
