"""Hopper BT-counter kernel (``csrc/bt_count.cu``): bit transitions of an
(F, L) word stream - the count at each flit boundary, the stream's int32
total, or both - in one launch; and, as a second entry point
(:func:`bt_measure`), the total with the two popcount sums of Eq. 3 in one
launch.

Replaces ``repro/kernels/bt_count.py`` ``bt_boundaries_pallas``, which took
two row-shifted (8k, 128k)-padded views so TPU tiles never overlapped, and
the ``jnp.sum`` that XLA fused behind it. On Hopper the work is one flat
stream of words, each against the word L further on, in 16-byte chunks
where L allows: every lane works at any L, the counts come from segmented
warp scans (a warp a boundary for rows wider than 32 words), and the total
from one accumulator that the last block to finish reads out. Bound on the
card: bytes (each word read once, one int32 written per boundary).
``core/bt.bt_stream`` takes its total: one launch and no separate sum.

The no-NoC recorder (``core/wire.measure``, Table I) takes
:func:`bt_measure`: the same walk over the word pairs also takes both
words' popcounts x and y and sums x + y and x y in 64 bits, so the expected
BT of Eq. 3 needs no count array, no elementwise launches and no second
read: one launch and one read a measure.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ._build import I32, I64, P, CudaKernel, stream

__all__ = ["KERNEL", "MEASURE", "KERNELS", "bt_count", "bt_boundaries",
           "bt_total", "bt_measure"]

KERNEL = CudaKernel(
    "bt_count", "bt_count.cu", "bt_count", [P, P, P, P, I64, I32, P],
    replaces="src/repro/kernels/bt_count.py:36 bt_boundaries_pallas")
MEASURE = CudaKernel(
    "bt_measure", "bt_count.cu", "bt_measure", [P, P, P, I64, I32, P],
    replaces="src/repro/kernels/popcount.py:34 popcount_words_pallas (the "
             "Eq. 3 counts) with src/repro/kernels/bt_count.py:36 "
             "bt_boundaries_pallas (the total)")
KERNELS = (KERNEL, MEASURE)

# The kernels' workspace, one a (device, stream): tickets drawn, the 32-bit
# total, then S1 and S2 as 64-bit words (bt_measure). Zeroed once here, left
# zero by every launch that uses it.
_WORKSPACES: Dict[Tuple[int, int], torch.Tensor] = {}


def _workspace(device: torch.device, handle: int) -> torch.Tensor:
    key = (device.index, handle)
    ws = _WORKSPACES.get(key)
    if ws is None:
        ws = _WORKSPACES[key] = torch.zeros(8, dtype=torch.int32,
                                            device=device)
    return ws


def _check_words(words: torch.Tensor) -> None:
    if words.device.type != "cuda":
        raise ValueError(f"bt_count kernel needs a CUDA tensor, got "
                         f"{words.device}")
    if words.dtype != torch.int32 or words.dim() != 2:
        raise TypeError(f"bt_count kernel takes (F, L) int32 words, got "
                        f"{tuple(words.shape)} {words.dtype}")
    if not words.is_contiguous():
        raise ValueError("bt_count kernel needs a contiguous tensor")


def bt_count(words: torch.Tensor, counts: bool = True, total: bool = True):
    """``(counts, total)`` of an (F, L) int32 CUDA word stream in one
    launch: the (F-1,) int32 transitions at each boundary and their int32
    sum (wrapping as an int32 sum does), each None when not asked for."""
    _check_words(words)
    if not (counts or total):
        raise ValueError("bt_count: ask for the counts, the total or both")
    f, lanes = words.shape
    dev = words.device
    out = (torch.empty((max(f - 1, 0),), dtype=torch.int32, device=dev)
           if counts else None)
    tot = torch.empty((), dtype=torch.int32, device=dev) if total else None
    if total or f > 1:
        handle = stream()
        ws = _workspace(dev, handle) if total else None
        KERNEL.launch(words.data_ptr(),
                      out.data_ptr() if counts else None,
                      tot.data_ptr() if total else None,
                      ws.data_ptr() if total else None, f, lanes, handle)
    return out, tot


def bt_boundaries(words: torch.Tensor) -> torch.Tensor:
    """Transitions per flit boundary of an (F, L) int32 CUDA word stream ->
    (F-1,) int32."""
    return bt_count(words, counts=True, total=False)[0]


def bt_total(words: torch.Tensor) -> torch.Tensor:
    """Total transitions over an (F, L) int32 CUDA word stream -> int32
    scalar."""
    return bt_count(words, counts=False, total=True)[1]


def bt_measure(words: torch.Tensor) -> torch.Tensor:
    """``[total, S1, S2]`` (int64) of an (F, L) int32 CUDA word stream in one
    launch: the BT total as the int32 sum wraps, and over the (F-1) L word
    pairs (a, b) = (w[i, j], w[i+1, j]), S1 = sum(x + y) and S2 = sum(x y)
    with x, y the pair's popcounts."""
    _check_words(words)
    f, lanes = words.shape
    out = torch.empty((3,), dtype=torch.int64, device=words.device)
    handle = stream()
    MEASURE.launch(words.data_ptr(), out.data_ptr(),
                   _workspace(words.device, handle).data_ptr(), f, lanes,
                   handle)
    return out
