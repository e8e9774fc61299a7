"""Flit packing: turning value streams into link flits.

A flit stream is a ``(num_flits, lanes)`` tensor of word carriers (see
``core/bits``), one row per flit: row ``i`` is what the wires hold on cycle
``i``. The paper uses 16 float-32 values on 512-bit links and 16 fixed-8
values on 128-bit links; the no-NoC study (Tab. I) uses 8-value flits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .bits import bit_width, unsigned_view

__all__ = ["FlitStream", "pack", "pack_paired", "unpack", "num_flits"]


class FlitStream(NamedTuple):
    """words: (num_flits, lanes) carrier words; lanes: values per flit;
    value_bits: bits of one value (32 for float-32, 8 for fixed-8)."""

    words: torch.Tensor
    lanes: int
    value_bits: int

    @property
    def flit_bits(self) -> int:
        return self.lanes * self.value_bits


def num_flits(n_values: int, lanes: int) -> int:
    return -(-n_values // lanes)


def pack(values: torch.Tensor, lanes: int) -> FlitStream:
    """Pack a flat value stream into ``lanes``-wide flits, zero-padded."""
    u = unsigned_view(values.reshape(-1))
    n = u.shape[0]
    nf = num_flits(n, lanes)
    u = F.pad(u, (0, nf * lanes - n))
    return FlitStream(u.reshape(nf, lanes), lanes, bit_width(u.dtype))


def pack_paired(inputs: torch.Tensor, weights: torch.Tensor,
                lanes: int) -> FlitStream:
    """Pack (input, weight) pairs: inputs in the left half-flit, weights in
    the right (the paper's Fig. 2 layout)."""
    if lanes % 2:
        raise ValueError("paired packing needs an even lane count")
    half = lanes // 2
    ui = unsigned_view(inputs.reshape(-1))
    uw = unsigned_view(weights.reshape(-1))
    if ui.shape != uw.shape:
        raise ValueError("inputs and weights must have the same element count")
    if ui.dtype != uw.dtype:
        raise ValueError("inputs and weights must share a dtype")
    n = ui.shape[0]
    nf = num_flits(n, half)
    pad = nf * half - n
    ui = F.pad(ui, (0, pad)).reshape(nf, half)
    uw = F.pad(uw, (0, pad)).reshape(nf, half)
    words = torch.cat([ui, uw], dim=1)
    return FlitStream(words, lanes, bit_width(words.dtype))


def unpack(stream: FlitStream, n_values: int, dtype: torch.dtype) -> torch.Tensor:
    """Invert :func:`pack` - recover the first ``n_values`` values."""
    flat = stream.words.reshape(-1)[:n_values]
    return flat if flat.dtype == dtype else flat.view(dtype)
