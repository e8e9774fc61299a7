"""Hopper chain-select kernel (``csrc/chain_select.cu``): the distance +
select body of one O3 chain step.

Replaces ``repro/kernels/min_hamming.py`` ``chain_select_pallas`` (body
``_make_select_kernel``). For each row of one or two XOR planes it returns
``dvec`` (the summed ``__popc`` distance per lane) and ``order`` (the lane
indices sorted stably ascending by ``dvec * k2 + idx + penalty``, int32
arithmetic that wraps as the plain version's does) - the order of the
reference's ``_select_beam`` for any penalty, ties and ``INT32_MIN``
included (the Pallas kernel's negated, unstable network is not; ROADMAP
C10). Rows up to 1,024 lanes are sorted by one warp in registers: each
element packs (key, lane) into one word - 32 bits when the bits that vary
across the row's keys and the lane index fit, else 64 - and the bitonic
network's cross-lane substages are warp shuffles, with no block barrier.
Wider rows, up to 16,384 lanes, take the shared-memory network of
``csrc/bitonic.cuh`` on (key, lane); wider ones raise, naming the width.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ._build import I32, I64, P, CudaKernel, check_arg, check_fits, stream

__all__ = ["KERNEL", "chain_select"]

KERNEL = CudaKernel(
    "chain_select", "chain_select.cu", "chain_select",
    [P, P, P, P, P, I64, I32, I32, I32, P],
    replaces="src/repro/kernels/min_hamming.py:288 chain_select_pallas")


def chain_select(planes: Sequence[torch.Tensor], penalty: torch.Tensor,
                 k2: int):
    """(dvec, order), both (R, W) int32, from 1-2 (R, W) int32 XOR planes
    and an (R, W) int32 penalty on the card."""
    if len(planes) not in (1, 2):
        raise ValueError(f"chain_select: 1 or 2 planes, got {len(planes)}")
    if penalty.dim() != 2:
        raise ValueError(f"chain_select: penalty must be (R, W), got "
                         f"{tuple(penalty.shape)}")
    r, w = penalty.shape
    for i, p in enumerate(planes):
        check_arg("chain_select", f"plane {i}", p, (r, w))
    check_arg("chain_select", "penalty", penalty, (r, w))
    wp = 1 << max(w - 1, 0).bit_length()
    check_fits("chain_select", wp, 2)
    dvec = torch.empty_like(penalty)
    order = torch.empty_like(penalty)
    if r and w:
        x1 = planes[1].data_ptr() if len(planes) > 1 else None
        KERNEL.launch(planes[0].data_ptr(), x1, penalty.data_ptr(),
                      dvec.data_ptr(), order.data_ptr(), r, w, len(planes),
                      int(k2), stream())
    return dvec, order
