"""Global-norm gradient clipping, the norm accumulated in float32 (the port
of ``repro.optim.clip``)."""
from __future__ import annotations

import torch

from ..tree import leaves, map_leaves

__all__ = ["clip_by_global_norm", "global_norm"]

_F32 = torch.float32


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares (a
    0-d float32 tensor)."""
    sq = sum(torch.sum(torch.square(g.to(_F32))) for g in leaves(tree))
    return torch.sqrt(sq)


def clip_by_global_norm(tree, max_norm: float):
    """(``tree`` scaled by min(1, max_norm / norm), each leaf back in its own
    dtype; the norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return map_leaves(lambda g: (g.to(_F32) * scale).to(g.dtype),
                      tree), norm
