"""Hopper popcount kernel (``csrc/popcount.cu``): '1'-bit count per word.

Replaces ``repro/kernels/popcount.py`` ``popcount_words_pallas``. The TPU
kernel ran a SWAR reduction over (8k, 128k) tiles because the TPU vector
unit has no popcount; Hopper has ``__popc``, so the kernel is one load, one
instruction and one store per word. Bound on the card: memory (8 bytes per
word against one integer op), so the design is 16-byte vector loads and
stores, no padding. ``core/bits.popcount`` on CUDA tensors goes through
it. No path of the port's main run needs the counts in device memory: the
orderings' counts go through ``popcount_order`` and the expected BT's
through ``bt_count.bt_measure``, which never write them out.
"""
from __future__ import annotations

import torch

from ._build import I64, P, CudaKernel, stream

__all__ = ["KERNEL", "popcount_words"]

KERNEL = CudaKernel(
    "popcount", "popcount.cu", "popcount_words", [P, P, I64, P],
    replaces="src/repro/kernels/popcount.py:34 popcount_words_pallas")


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Popcount of each int32-carried uint32 word of a CUDA tensor -> int32,
    same shape."""
    if words.device.type != "cuda":
        raise ValueError(f"popcount kernel needs a CUDA tensor, got "
                         f"{words.device}")
    if words.dtype != torch.int32:
        raise TypeError(f"popcount kernel takes int32 words, got "
                        f"{words.dtype}")
    if not words.is_contiguous():
        raise ValueError("popcount kernel needs a contiguous tensor")
    out = torch.empty_like(words)
    if words.numel():
        KERNEL.launch(words.data_ptr(), out.data_ptr(), words.numel(),
                      stream())
    return out
