"""Least work of the min-Hamming chains (``chain_greedy.cu``, K6) a sweep
needs: one chain a packet window for each precision and each of O3 (the
inputs and the weights chained alone, one plane each) and O3a (the pairs,
two planes), whatever the tiebreak, compression or mesh, which do not
change the order. A window of ``k`` values is padded to a multiple of 8
lanes, W; ``live`` counts its non-zero slots (zeros are partitioned to
the tail). Each of the W - 1 steps of each of the S = 8 starts needs, for
each of the beam = 2 candidates, a distance pass over the live lanes (P
XORs, P popcounts, P - 1 adds a lane), the zero region's distance once
(2P - 1 a window), a compare a live lane for the lookahead minimum, and W
+ (beam - 1) * ceil(log2 W) compares to select the beam: one count a step
whatever the kernel's tier or launch form. Divided by the 32-bit ALU rate
(peaks.json says why that rate)."""

import torch

PEAK = "int32_ops_per_s"
KERNEL = "chain_greedy"
STARTS = 8
BEAM = 2
HALF = 8


def chain_ops(planes) -> int:
    """Operations to chain every row of the (n, k) planes (1 or 2)."""
    p = len(planes)
    n, k = planes[0].shape
    if n == 0 or k == 0:
        return 0
    w = -(-k // HALF) * HALF
    nz = planes[0] != 0
    for q in planes[1:]:
        nz = nz | (q != 0)
    live = int(nz.sum())
    beam = min(BEAM, w)
    select = w + (beam - 1) * max(w - 1, 0).bit_length()
    return (w - 1) * STARTS * (beam * (3 * p * live + (2 * p - 1) * n)
                               + n * select)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def least_ops(ctx, layers) -> int:
    """Chain work of one inference's operand rows under the cell's grid."""
    from reference.ordering import QUANTIZERS, subsample
    trs = [t for t in ("O3", "O3a") if t in ctx.grid["transforms"]]
    if not trs:
        return 0
    total = 0
    for prec in ctx.grid["precisions"]:
        q = QUANTIZERS[prec]
        for inp, wgt in layers:
            inp, wgt = subsample(inp, wgt, ctx.grid["max_packets_per_layer"])
            qi, qw = (inp, wgt) if q is None else (q(inp), q(wgt))
            qi, qw = _bits(qi), _bits(qw)
            if "O3" in trs:
                total += chain_ops([qi]) + chain_ops([qw])
            if "O3a" in trs:
                total += chain_ops([qi, qw])
    return total


def least_seconds(ctx, sweep) -> float:
    if not any(t in ctx.grid["transforms"] for t in ("O3", "O3a")):
        return 0.0
    return least_ops(ctx, ctx.layers_of(sweep)) / ctx.peaks[PEAK]
