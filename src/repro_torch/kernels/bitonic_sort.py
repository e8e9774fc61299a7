"""Hopper window-sort kernel (``csrc/bitonic_sort.cu``): descending
bitonic key sort of each row, 0-2 payloads riding the swaps.

Replaces ``repro/kernels/bitonic_sort.py`` ``sort_windows_pallas``. The
network (``csrc/bitonic.cuh``, shared with the ordering-unit and
chain-select kernels) is the reference's stage for stage, with the same
strict comparisons, so the output equals the Pallas kernel's bit for bit on
ties too. Whole rows are sorted in shared memory, one thread per
compare-exchange pair, one block barrier per substage; the bytes bound it
on paper, the chain of barrier-separated substages in practice.
"""
from __future__ import annotations

import torch

from ._build import I32, I64, P, CudaKernel, check_arg, check_fits, stream

__all__ = ["KERNEL", "sort_windows"]

KERNEL = CudaKernel(
    "bitonic_sort", "bitonic_sort.cu", "sort_windows",
    [P, P, P, P, P, P, I64, I32, I32, P],
    replaces="src/repro/kernels/bitonic_sort.py:80 sort_windows_pallas")


def sort_windows(keys: torch.Tensor, *payloads: torch.Tensor):
    """Sort each row of (R, W) int32 ``keys`` descending on the card, with
    up to two (R, W) int32 payloads; W a power of two. Returns
    ``(keys, *payloads)`` sorted, as new tensors."""
    if keys.dim() != 2:
        raise ValueError(f"sort_windows: keys must be (R, W), got "
                         f"{tuple(keys.shape)}")
    r, w = keys.shape
    if w & (w - 1):
        raise ValueError(f"sort_windows: width must be a power of two, "
                         f"got {w}")
    if len(payloads) > 2:
        raise ValueError(f"sort_windows: at most 2 payloads, got "
                         f"{len(payloads)}")
    check_arg("sort_windows", "keys", keys, (r, w))
    for i, p in enumerate(payloads):
        check_arg("sort_windows", f"payload {i}", p, (r, w))
    check_fits("sort_windows", w, 1 + len(payloads))
    outs = tuple(torch.empty_like(t) for t in (keys, *payloads))
    if r and w:
        absent = [None] * (2 - len(payloads))
        ptrs = [t.data_ptr() if t is not None else None
                for t in [keys, *payloads, *absent, *outs, *absent]]
        KERNEL.launch(*ptrs, r, w, len(payloads), stream())
    return outs
