"""Hopper BT-counter kernel (``csrc/bt_count.cu``): bit transitions at each
flit boundary of an (F, L) word stream.

Replaces ``repro/kernels/bt_count.py`` ``bt_boundaries_pallas``, which took
two row-shifted (8k, 128k)-padded views so TPU tiles never overlapped. On
Hopper one warp owns one boundary: its lanes XOR and ``__popc`` the two rows
and a warp-shuffle sum writes one int32. Bound on the card: memory (each
word read, one int32 written per boundary; the second read of a row hits
L2), one XOR, one popcount and one add per word. The no-NoC recorder
(``core/bt.bt_stream``, ``core/wire.measure``, Table I) goes through it.
"""
from __future__ import annotations

import torch

from ._build import I32, P, CudaKernel, stream

__all__ = ["KERNEL", "bt_boundaries"]

KERNEL = CudaKernel(
    "bt_count", "bt_count.cu", "bt_boundaries", [P, P, I32, I32, P],
    replaces="src/repro/kernels/bt_count.py:36 bt_boundaries_pallas")


def bt_boundaries(words: torch.Tensor) -> torch.Tensor:
    """Transitions per flit boundary of an (F, L) int32 CUDA word stream ->
    (F-1,) int32."""
    if words.device.type != "cuda":
        raise ValueError(f"bt_count kernel needs a CUDA tensor, got "
                         f"{words.device}")
    if words.dtype != torch.int32 or words.dim() != 2:
        raise TypeError(f"bt_count kernel takes (F, L) int32 words, got "
                        f"{tuple(words.shape)} {words.dtype}")
    if not words.is_contiguous():
        raise ValueError("bt_count kernel needs a contiguous tensor")
    f, lanes = words.shape
    out = torch.empty((max(f - 1, 0),), dtype=torch.int32,
                      device=words.device)
    if f > 1:
        KERNEL.launch(words.data_ptr(), out.data_ptr(), f, lanes, stream())
    return out
