"""Bit-level primitives on PyTorch tensors: unsigned views, popcount,
transition counts.

Word representation: torch has no usable ``uint32`` (no shifts, no
comparisons on the CPU), so a 32-bit word travels as ``torch.int32``
carrying the uint32 bit pattern; 16-bit words as ``torch.int16`` and 8-bit
words as ``torch.uint8``. Every right shift of a carrier is made logical
with a mask (:func:`srl`), and anything that orders words as unsigned widens
them to int64 first (:func:`widen_unsigned`).

``popcount`` on a CUDA tensor goes through the hand-written popcount kernel
(``repro_torch.kernels.popcount``); on a CPU tensor it is the SWAR form
below, the same circuit as the reference's ``repro.core.bits.popcount``.
"""
from __future__ import annotations

import torch

__all__ = [
    "unsigned_view",
    "widen_unsigned",
    "words32",
    "from_words32",
    "srl",
    "popcount",
    "popcount32",
    "popcount8",
    "bit_width",
    "bits_of",
    "transitions",
]

# value dtype -> carrier dtype of its bit pattern
_CARRIER = {
    torch.float32: torch.int32,
    torch.int32: torch.int32,
    torch.uint32: torch.int32,
    torch.bfloat16: torch.int16,
    torch.float16: torch.int16,
    torch.int16: torch.int16,
    torch.int8: torch.uint8,
    torch.uint8: torch.uint8,
}


def bit_width(dtype: torch.dtype) -> int:
    """Number of bits in one element of ``dtype``."""
    return dtype.itemsize * 8


def unsigned_view(values: torch.Tensor) -> torch.Tensor:
    """Reinterpret ``values`` as its same-width word carrier (a bitcast).

    float32/int32/uint32 -> int32, bf16/fp16/int16 -> int16, int8/uint8 -> uint8.
    The float32 ``-0.0`` maps to the carrier of ``0x80000000``.
    """
    if values.dtype not in _CARRIER:
        raise TypeError(f"no unsigned view for dtype {values.dtype}")
    target = _CARRIER[values.dtype]
    return values if values.dtype == target else values.view(target)


def widen_unsigned(words: torch.Tensor) -> torch.Tensor:
    """Carrier words -> int64 holding the unsigned value (zero-extended)."""
    u = unsigned_view(words)
    mask = (1 << bit_width(u.dtype)) - 1
    return u.to(torch.int64) & mask


def words32(values: torch.Tensor) -> torch.Tensor:
    """Bit patterns zero-extended into int32-carried uint32 words (what the
    popcount and BT kernels take)."""
    u = unsigned_view(values)
    nbits = bit_width(u.dtype)
    if nbits == 32:
        return u
    return u.to(torch.int32) & ((1 << nbits) - 1)


def from_words32(words: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`words32`: int32-carried words back to ``dtype``
    (the low ``bit_width(dtype)`` bits of each word)."""
    carrier = _CARRIER[dtype]
    u = words if carrier == torch.int32 else words.to(carrier)
    return u if u.dtype == dtype else u.view(dtype)


def srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32-carried uint32 words."""
    return (x >> k) & ((1 << (32 - k)) - 1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int32-carried uint32 words -> int32 in [0, 32]."""
    x = x.to(torch.int32)
    x = x - (srl(x, 1) & 0x55555555)
    x = (x & 0x33333333) + (srl(x, 2) & 0x33333333)
    x = (x + srl(x, 4)) & 0x0F0F0F0F
    # Byte sums by shift-and-add; no int32 multiply that would overflow.
    x = x + srl(x, 8)
    x = x + srl(x, 16)
    return x & 0x3F


def popcount8(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of uint8 words -> uint8 in [0, 8]."""
    x = x.to(torch.uint8)
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def popcount(values: torch.Tensor) -> torch.Tensor:
    """'1'-bit count of each element via its bit pattern -> int32, same shape.

    CUDA tensors go through the popcount kernel; CPU tensors through the
    SWAR form.
    """
    from repro_torch.kernels import ops
    return ops.popcount(values)


def bits_of(values: torch.Tensor) -> torch.Tensor:
    """Expand each element into its bits, MSB first -> uint8
    ``values.shape + (nbits,)``."""
    u = unsigned_view(values)
    nbits = bit_width(u.dtype)
    w = u.to(torch.int32)
    shifts = torch.arange(nbits - 1, -1, -1, dtype=torch.int32,
                          device=values.device)
    # (w >> s) & 1 reads bit s whatever the sign-extension above it.
    return ((w[..., None] >> shifts) & 1).to(torch.uint8)


def transitions(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-element count of toggling bits between ``a`` and ``b`` (int32)."""
    return popcount(unsigned_view(a) ^ unsigned_view(b))
