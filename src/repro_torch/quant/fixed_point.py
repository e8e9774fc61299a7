"""Fixed-point-8 quantization (the paper's fixed-8 data format).

Symmetric per-tensor fixed point with a power-of-two scale, as in
``repro.quant.fixed_point``: f = 7 - ceil(log2(max|x|)) clamped to [0, 7],
values rounded half-to-even (``torch.round``, like ``jnp.round``) after a
float32 ``exp2`` scale.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["FixedPointParams", "quantize_fixed8", "dequantize_fixed8"]


class FixedPointParams(NamedTuple):
    values: torch.Tensor     # int8 payload (two's complement on the wire)
    frac_bits: torch.Tensor  # scalar int32: number of fractional bits


def quantize_fixed8(x: torch.Tensor) -> FixedPointParams:
    """Quantize float data to Q(7-f).f fixed point, f chosen per tensor."""
    amax = x.abs().max() if x.numel() else torch.zeros((), dtype=x.dtype,
                                                        device=x.device)
    amax = torch.clamp(amax.to(torch.float32), min=1e-12)
    int_bits = torch.ceil(torch.log2(amax)).to(torch.int32)
    frac_bits = torch.clamp(7 - int_bits, 0, 7)
    scale = torch.exp2(frac_bits.to(torch.float32))
    q = torch.clamp(torch.round(x.to(torch.float32) * scale), -128, 127)
    return FixedPointParams(q.to(torch.int8), frac_bits)


def dequantize_fixed8(p: FixedPointParams) -> torch.Tensor:
    scale = torch.exp2(-p.frac_bits.to(torch.float32))
    return p.values.to(torch.float32) * scale
