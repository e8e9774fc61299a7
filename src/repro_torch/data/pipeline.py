"""Deterministic synthetic data: the LM token stream and procedural glyph
images (the port of ``repro.data.pipeline``).

:class:`TokenStream` keeps the reference's contract: the global batch is a
pure function of ``(seed, step)`` and a shard is a row slice of it, so any
host can regenerate any other host's shard and the shard COUNT does not
change the data. Its Zipf-distributed tokens come from the reference's
inverse-CDF transform (:func:`zipf_tokens`) applied to uniforms that a
``torch.Generator`` on the host draws, seeded from ``(seed, step)``: the
same batches on every device, so a restart on the card sees the CPU's
batches. The draws differ from the reference's ``jax.random`` counters,
which torch cannot reproduce (ROADMAP C22); given the reference's own
uniforms, :func:`zipf_tokens` gives its tokens up to float32 ``exp`` /
``log`` rounding at integer boundaries (one rank, rarely).

:func:`glyph_batch` is the reference's procedure - a 7-segment-style digit
glyph upsampled by nearest neighbour, centred, shifted by up to +-2 px,
scaled by a random contrast in [0.7, 1), plus 0.15 Gaussian noise, clipped
to [0, 1] - drawn from a ``torch.Generator``, so the numbers differ from
the JAX key's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device

__all__ = ["TokenStream", "zipf_tokens", "glyph_batch", "GLYPHS"]

_UNIFORM_MIN = 1e-6


def zipf_tokens(u: torch.Tensor, vocab: int, zipf_a: float = 1.2):
    """The reference's inverse-CDF Zipf transform of float32 uniforms in
    [1e-6, 1): rank ``exp(log(u) * -1/(a-1))``, truncated, minus one,
    clipped to the vocab (int32). Ranks beyond the vocab are clamped
    before the cast, as the reference's saturating cast leaves them."""
    ranks = torch.exp(torch.log(u) * (-1.0 / (zipf_a - 1.0)))
    ranks = torch.clamp(ranks, max=float(vocab))
    return torch.clamp(ranks.to(torch.int64) - 1, 0,
                       vocab - 1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class TokenStream:
    """Zipf-ish LM token stream with next-token targets."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2

    def uniforms(self, step: int) -> torch.Tensor:
        """The global batch's float32 uniforms in [1e-6, 1), (global_batch,
        seq_len + 1), drawn on the host from a generator seeded by
        ``(seed, step)``."""
        key = np.random.SeedSequence([self.seed, step]).generate_state(
            1, np.uint64)[0]
        gen = torch.Generator().manual_seed(int(key))
        r = torch.rand((self.global_batch, self.seq_len + 1), generator=gen)
        return torch.clamp(r * (1.0 - _UNIFORM_MIN) + _UNIFORM_MIN,
                           min=_UNIFORM_MIN)

    def batch(self, step: int, shard: int = 0, num_shards: int = 1,
              device: DeviceLike = None):
        """(tokens, targets, mask) for one shard of one step on ``device``
        (the card unless the caller asks for the CPU): int32 tokens and
        targets (B, S), float32 mask of ones, B = global_batch /
        num_shards. The global batch is a pure function of (seed, step);
        a shard is a row slice of it."""
        if self.global_batch % num_shards:
            raise ValueError("global_batch must divide by num_shards")
        dev = resolve_device(device)
        b = self.global_batch // num_shards
        toks = zipf_tokens(self.uniforms(step), self.vocab, self.zipf_a)
        toks = toks[shard * b:(shard + 1) * b].to(dev)
        tokens, targets = toks[:, :-1], toks[:, 1:]
        mask = torch.ones(targets.shape, dtype=torch.float32, device=dev)
        return tokens, targets, mask

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
