"""The image stream a cell's sweeps infer on, made from the seed.

7-segment-style digit glyphs (rows of 5 x 3 cells) upsampled by nearest
neighbour to ``hw // 8`` a cell, centred, rolled by up to +-2 pixels,
scaled by a contrast in [0.7, 1), plus 0.15 Gaussian noise, clipped to
[0, 1]: the procedure the trained models were trained on, drawn here from
a ``torch.Generator`` on the device. Every seed gives images of the same
shape, so every seed's sweeps do the same amount of drain work.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_SEGS = ("111101101101111", "010010010010010", "111001111100111",
         "111001111001111", "101101111001001", "111100111001111",
         "111100111101111", "111001001001001", "111101111101111",
         "111101111001111")
GLYPHS = np.stack([np.array([int(c) for c in s], np.float32).reshape(5, 3)
                   for s in _SEGS])


def glyph_images(seed: int, count: int, hw: int, channels: int,
                 device) -> torch.Tensor:
    """(count, hw, hw, channels) float32 images in [0, 1] from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    labels = torch.randint(0, 10, (count,), generator=gen, device=device)
    img = torch.as_tensor(GLYPHS, device=device)[labels]
    up = hw // 8
    img = img.repeat_interleave(up, dim=1).repeat_interleave(up, dim=2)
    ph, pw = hw - 5 * up, hw - 3 * up
    img = F.pad(img, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    shifts = torch.randint(-2, 3, (count, 2), generator=gen,
                           device=device).tolist()
    img = torch.stack([torch.roll(im, (sy, sx), dims=(0, 1))
                       for im, (sy, sx) in zip(img, shifts)])
    contrast = torch.rand((count, 1, 1), generator=gen, device=device)
    img = img * (0.7 + 0.3 * contrast)
    img = img + 0.15 * torch.randn(img.shape, generator=gen, device=device)
    img = torch.clamp(img, 0.0, 1.0)[..., None]
    if channels > 1:
        img = img.repeat_interleave(channels, dim=-1)
    return img.to(torch.float32).contiguous()
