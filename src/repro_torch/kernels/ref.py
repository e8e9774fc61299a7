"""Plain-PyTorch versions of the port's kernels.

Each is the semantic ground truth its Hopper kernel is held to (exact
equality: these are integer and bit operations). They are also what the
port runs on CPU tensors.
"""
from __future__ import annotations

import torch

from ..core.bits import popcount32, words32

__all__ = ["popcount_ref", "bt_boundaries_ref", "router_step_ref"]


def popcount_ref(values: torch.Tensor) -> torch.Tensor:
    """'1'-bit count per element (int32), any dtype with an unsigned view."""
    return popcount32(words32(values))


def bt_boundaries_ref(words: torch.Tensor) -> torch.Tensor:
    """Bit transitions at each flit boundary of an (F, L) word stream ->
    (F-1,) int32 (the paper's Fig. 8 recorder)."""
    w = words32(words)
    return popcount32(w[:-1] ^ w[1:]).sum(dim=-1, dtype=torch.int32)


def router_step_ref(state, wire, mc_nodes: torch.Tensor, cycles: int,
                    mesh_key, count_headers: bool):
    """``cycles`` applications of the plain step (``noc.sim.plain_step``);
    returns the new state."""
    from ..noc.sim import plain_step
    for _ in range(cycles):
        state = plain_step(state, wire, mc_nodes, mesh_key, count_headers)
    return state
