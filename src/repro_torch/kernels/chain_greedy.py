"""Hopper chain kernel (``csrc/chain_greedy.cu``): every step of every O3
chain of a chain call in one launch.

Replaces the scan of ``repro/kernels/min_hamming.py`` ``_greedy_from``
(vmapped over starts and windows), whose distance + select body
``chain_select_pallas`` computes on a TPU. One block a window, one warp a
start: the window's planes sit in shared memory, each warp keeps its
visited set as a bit mask there, and a step's beam selection, lookahead and
score argmin are warp reductions, with no block barrier in the step loop.
The result equals :func:`repro_torch.kernels.ref.chain_greedy_ref` bit for
bit. Rows wider than the int32 score encoding allows (``_MAX_WINDOW``) or
than a block's shared memory holds raise, naming the width.
"""
from __future__ import annotations

import torch

from ._build import I32, P, CudaKernel, check_arg, check_fits, stream

__all__ = ["KERNEL", "chain_greedy", "WARPS"]

KERNEL = CudaKernel(
    "chain_greedy", "chain_greedy.cu", "chain_greedy",
    [P, P, P, P, P, I32, I32, I32, I32, I32, P],
    replaces="src/repro/kernels/min_hamming.py:135 _greedy_from (its scan; "
             "chain_select_pallas :288 is the step body)")

# Starts (warps) a block; csrc/chain_greedy.cu kWarps.
WARPS = 8


def chain_greedy(q: torch.Tensor, z: torch.Tensor, start: torch.Tensor,
                 beam: int):
    """(orders (R, S, W), costs (R, S)) int32 of the greedy beam-lookahead
    chains over partitioned (P, R, W) int32 planes (P = 1 or 2) with (R,)
    live counts ``z`` from (R, S) int32 start positions, on the card."""
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
    check_arg("chain_greedy", "q", q, (p, r, w))
    check_arg("chain_greedy", "z", z, (r,))
    check_arg("chain_greedy", "start", start, (r, s))
    if w and not 1 <= beam <= w:
        raise ValueError(f"chain_greedy: beam must be in [1, {w}], got {beam}")
    check_fits("chain_greedy", w, p, extra=4 * min(s, WARPS) * -(-w // 32))
    orders = torch.empty((r, s, w), dtype=torch.int32, device=q.device)
    costs = torch.empty((r, s), dtype=torch.int32, device=q.device)
    if r and s and w:
        KERNEL.launch(q.data_ptr(), z.data_ptr(), start.data_ptr(),
                      orders.data_ptr(), costs.data_ptr(), p, r, s, w,
                      int(beam), stream())
    return orders, costs
