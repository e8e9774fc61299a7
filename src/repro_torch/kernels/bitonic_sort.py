"""Hopper window-sort kernel (``csrc/bitonic_sort.cu``): descending
bitonic key sort of each row, 0-2 payloads riding the swaps.

Replaces ``repro/kernels/bitonic_sort.py`` ``sort_windows_pallas``. The
network is the reference's stage for stage, with the same strict
comparisons, so the output equals the Pallas kernel's bit for bit on ties
too. Rows of 32 to 1,024 keys are sorted in registers (``warp_bitonic`` in
``csrc/bitonic.cuh``), a warp a row below W = 256 and two from 256, with no
block barrier: the int32 keys compared signed, each element's index riding
beside its key when there are payloads, and the payloads gathered from
shared memory by the final index. Other widths run the shared-memory
network, one block barrier a substage.
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
