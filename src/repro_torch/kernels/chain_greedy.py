"""Hopper chain kernel (``csrc/chain_greedy.cu``): every step of every O3
chain of a chain call in one launch.

Replaces the scan of ``repro/kernels/min_hamming.py`` ``_greedy_from``
(vmapped over starts and windows), whose distance + select body
``chain_select_pallas`` computes on a TPU. One warp a chain, in one of two
tiers that :func:`tier_of` picks from the shape alone:

* ``register`` (W <= 1,024, beam <= 2; the main path's beam is 2): a
  lane's plane words, penalties and distances sit in registers; a step is
  one pass that computes every candidate's distances and lookahead minima
  at once, the winner's vector is the next step's distances, and a 32-bit
  key that embeds the lane index makes each minimum one warp reduction. A
  block runs eight (window, start) chains.
* ``wide`` (any other W up to ``_MAX_WINDOW``, or a larger beam): one block
  a window, the planes and each warp's visited mask in shared memory,
  every pass recomputing its distances from there.

Bound: ``beam`` distance passes over the live lanes a step (P XORs, P
popcounts, P - 1 adds a lane), a compare a live lane for each lookahead
minimum and W + (beam - 1) * ceil(log2 W) for the beam selection; integer
operations, not bytes, bound it (counted against 67 TOP/s, the published
float32 rate: the source note says why). The result equals
:func:`repro_torch.kernels.ref.chain_greedy_ref` bit for bit in both
tiers; a tier that fails to launch raises. Rows wider than the int32 score
encoding allows (``_MAX_WINDOW``) or than a block's shared memory holds
raise, naming the width.
"""
from __future__ import annotations

import torch

from ._build import I32, P, CudaKernel, check_arg, check_fits, stream

__all__ = ["KERNEL", "chain_greedy", "tier_of", "TIERS", "WARPS",
           "REG_MAX_WINDOW", "REG_MAX_BEAM"]

KERNEL = CudaKernel(
    "chain_greedy", "chain_greedy.cu", "chain_greedy",
    [P, P, P, P, P, I32, I32, I32, I32, I32, I32, P],
    replaces="src/repro/kernels/min_hamming.py:135 _greedy_from (its scan; "
             "chain_select_pallas :288 is the step body)")

# Warps a block in both tiers; csrc/chain_greedy.cu kWarps.
WARPS = 8
# The register tier's widest row and largest beam (kRegMaxWindow,
# kRegMaxBeam).
REG_MAX_WINDOW = 1024
REG_MAX_BEAM = 2
TIERS = ("register", "wide")


def tier_of(w: int, beam: int) -> str:
    """The tier that chains rows of width ``w`` with ``beam``: ``register``
    up to ``REG_MAX_WINDOW`` lanes and ``REG_MAX_BEAM``, else ``wide``."""
    return ("register" if w <= REG_MAX_WINDOW and beam <= REG_MAX_BEAM
            else "wide")


def chain_greedy(q: torch.Tensor, z: torch.Tensor, start: torch.Tensor,
                 beam: int, *, tier: str | None = None):
    """(orders (R, S, W), costs (R, S)) int32 of the greedy beam-lookahead
    chains over partitioned (P, R, W) int32 planes (P = 1 or 2) with (R,)
    live counts ``z`` from (R, S) int32 start positions, on the card.

    ``tier`` (default :func:`tier_of`'s) is for timing the wide tier
    against the register tier at a shape both take; the result is the
    same."""
    from .min_hamming import _MAX_WINDOW
    if q.dim() != 3 or q.shape[0] not in (1, 2):
        raise ValueError(f"chain_greedy: q must be (P, R, W) with P in "
                         f"(1, 2), got {tuple(q.shape)}")
    p, r, w = q.shape
    if w > _MAX_WINDOW:
        raise ValueError(f"chain_greedy: a row of width {w} exceeds the "
                         f"int32 score encoding bound ({_MAX_WINDOW})")
    if start.dim() != 2:
        raise ValueError(f"chain_greedy: start must be (R, S), got "
                         f"{tuple(start.shape)}")
    s = start.shape[1]
    if w and not 1 <= beam <= w:
        raise ValueError(f"chain_greedy: beam must be in [1, {w}], got {beam}")
    tier = tier_of(w, beam) if tier is None else tier
    if tier not in TIERS:
        raise ValueError(f"chain_greedy: tier must be one of {TIERS}, got "
                         f"{tier!r}")
    if tier == "register" and tier_of(w, beam) != "register":
        raise ValueError(f"chain_greedy: the register tier takes W <= "
                         f"{REG_MAX_WINDOW} and beam <= {REG_MAX_BEAM}, got "
                         f"W = {w}, beam {beam}")
    if tier == "wide":
        check_fits("chain_greedy", w, p,
                   extra=4 * min(s, WARPS) * -(-w // 32))
    check_arg("chain_greedy", "q", q, (p, r, w))
    check_arg("chain_greedy", "z", z, (r,))
    check_arg("chain_greedy", "start", start, (r, s))
    orders = torch.empty((r, s, w), dtype=torch.int32, device=q.device)
    costs = torch.empty((r, s), dtype=torch.int32, device=q.device)
    if r and s and w:
        KERNEL.launch(q.data_ptr(), z.data_ptr(), start.data_ptr(),
                      orders.data_ptr(), costs.data_ptr(), p, r, s, w,
                      int(beam), TIERS.index(tier), stream())
    return orders, costs
