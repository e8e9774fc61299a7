"""Least bytes of the router-cycle kernel (``router_step.cu``, K1) over a
sweep's drains, counted per lane and not per launch: every flit a lane
injects is read once (its payload lanes and one sideband word), and each
lane's per-link BT and flit counters and per-stream NI BT are written
once. The routing state can live on the chip for the whole drain, so no
byte is counted per cycle. Divided by the HBM rate."""

PEAK = "hbm_bytes_per_s"
KERNEL = "router_cycles"
_PORTS = 5


def _routers(mesh: str) -> int:
    rows, rest = mesh.split("x", 1)
    return int(rows) * int(rest.split("_", 1)[0])


def least_bytes(rows, lanes: int = 16) -> int:
    """Bytes of one sweep's request and result lanes (one row a lane)."""
    total = 0
    for r in rows:
        nr = _routers(r["mesh"])
        for flits in (r["flits"], r.get("result_flits")):
            if flits is None:
                continue
            total += 4 * flits * (lanes + 1) + 4 * (2 * nr * _PORTS + nr)
    return total


def least_seconds(ctx, sweep) -> float:
    return least_bytes(sweep["rows"]) / ctx.peaks[PEAK]
