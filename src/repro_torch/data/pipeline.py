"""Procedural glyph images for LeNet (the port of ``repro.data.glyph_batch``).

Same procedure as the reference - a 7-segment-style digit glyph upsampled
by nearest neighbour, centred, shifted by up to +-2 px, scaled by a random
contrast in [0.7, 1), plus 0.15 Gaussian noise, clipped to [0, 1] - drawn
from a ``torch.Generator``, so the numbers differ from the JAX key's.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device

__all__ = ["glyph_batch", "GLYPHS"]

# 7-segment-style glyph templates for the 10 classes (rows of 5x3 cells).
_SEGS = {
    0: "111101101101111", 1: "010010010010010", 2: "111001111100111",
    3: "111001111001111", 4: "101101111001001", 5: "111100111001111",
    6: "111100111101111", 7: "111001001001001", 8: "111101111101111",
    9: "111101111001111",
}
GLYPHS = np.stack([
    np.array([int(c) for c in _SEGS[d]], np.float32).reshape(5, 3)
    for d in range(10)])


def glyph_batch(generator: torch.Generator, batch: int, hw: int = 32,
                channels: int = 1, device: DeviceLike = None):
    """Procedural digit-like images -> (images (B, hw, hw, channels) float32
    in [0, 1], labels (B,) int64). ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    labels = torch.randint(0, 10, (batch,), generator=generator, device=dev)
    glyphs = torch.as_tensor(GLYPHS, device=dev)[labels]          # (B, 5, 3)
    up = hw // 8
    img = glyphs.repeat_interleave(up, dim=1).repeat_interleave(up, dim=2)
    ph, pw = hw - 5 * up, hw - 3 * up
    img = F.pad(img, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    shifts = torch.randint(-2, 3, (batch, 2), generator=generator,
                           device=dev).tolist()
    img = torch.stack([torch.roll(im, (sy, sx), dims=(0, 1))
                       for im, (sy, sx) in zip(img, shifts)])
    contrast = torch.rand((batch, 1, 1), generator=generator, device=dev)
    img = img * (0.7 + 0.3 * contrast)
    img = img + 0.15 * torch.randn(img.shape, generator=generator, device=dev)
    img = torch.clamp(img, 0.0, 1.0)[..., None]
    if channels > 1:
        img = img.repeat_interleave(channels, dim=-1)
    return img.to(torch.float32), labels
