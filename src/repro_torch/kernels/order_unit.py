"""Hopper ordering-unit kernel (``csrc/order_unit.cu``): popcount keys and
the descending bitonic sort of each row in one pass (the paper's Fig. 14).

Replaces ``repro/kernels/order_unit.py`` ``order_unit_pallas``. Each key is
one ``__popc`` taken as the row is loaded (the TPU ran a SWAR popcount);
the network is the reference's, substage for substage, with (value, lane
index) riding the swaps, so ordered values and the window-local
permutation equal the reference's bit for bit, ties included. Rows of 32
to 1,024 words are sorted in registers (``warp_bitonic`` in
``csrc/bitonic.cuh``), a warp a row below W = 256 and two from 256: the
(popcount, index) pair of an element is one word, compare-exchanged inside
a thread or by shuffles, with no block barrier (two warps meet at a named
barrier of their own), and the values are gathered by the final indices.
Other widths run in shared memory, one barrier a substage. The keys never
reach device memory: 4 bytes read and 8 written a lane.
"""
from __future__ import annotations

import torch

from ._build import I32, I64, P, CudaKernel, check_arg, check_fits, stream

__all__ = ["KERNEL", "order_unit_words"]

KERNEL = CudaKernel(
    "order_unit", "order_unit.cu", "order_unit", [P, P, P, I64, I32, P],
    replaces="src/repro/kernels/order_unit.py:51 order_unit_pallas")


def order_unit_words(words: torch.Tensor):
    """(R, W) int32-carried 32-bit words on the card, W a power of two ->
    (words ordered by popcount descending, window permutation int32)."""
    if words.dim() != 2:
        raise ValueError(f"order_unit: words must be (R, W), got "
                         f"{tuple(words.shape)}")
    r, w = words.shape
    check_arg("order_unit", "words", words, (r, w))
    if w & (w - 1):
        raise ValueError(f"order_unit: width must be a power of two, got {w}")
    check_fits("order_unit", w, 3)
    out = torch.empty_like(words)
    perm = torch.empty_like(words)
    if r and w:
        KERNEL.launch(words.data_ptr(), out.data_ptr(), perm.data_ptr(), r, w,
                      stream())
    return out, perm
