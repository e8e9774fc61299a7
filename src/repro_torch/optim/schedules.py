"""LR schedules (the port of ``repro.optim.schedules``). WSD
(warmup-stable-decay) is the MiniCPM schedule the minicpm-2b config calls
for; cosine is the default elsewhere.

Each schedule maps a step (an int or a tensor) to a 0-d float32 tensor on
the step's device, computed in float32 from the step as the reference
computes it: each Python constant enters an operation as a float32 scalar
(torch's rule for a Python number beside a float32 tensor, JAX's for a
weakly typed one), never as float64 arithmetic on the host. No tensor is
made from a host value, so a schedule runs inside a captured CUDA graph.
"""
from __future__ import annotations

import math

import torch

__all__ = ["wsd", "cosine", "constant"]

_F32 = torch.float32


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(_F32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=_F32)


def cosine(lr: float, total_steps: int, warmup: int = 100,
           min_ratio: float = 0.1):
    def fn(step):
        step = _step(step)
        warm = lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                        0.0, 1.0)
        cos = lr * (min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return fn


def wsd(lr: float, total_steps: int, warmup: int = 100,
        decay_frac: float = 0.1, min_ratio: float = 0.01):
    """Warmup-Stable-Decay (MiniCPM): linear warmup, long stable plateau,
    sharp exponential-style decay over the final ``decay_frac`` of steps."""
    decay_start = int(total_steps * (1 - decay_frac))

    def fn(step):
        step = _step(step)
        warm = lr * step / max(warmup, 1)
        t = torch.clamp((step - decay_start)
                        / max(total_steps - decay_start, 1), 0.0, 1.0)
        decay = lr * torch.pow(min_ratio, t)
        stable = torch.full_like(step, lr)
        return torch.where(step < warmup, warm,
                           torch.where(step < decay_start, stable, decay))
    return fn
