"""Dispatch between the port's Hopper kernels and their plain versions.

A CUDA tensor goes to the kernel (which raises on anything it cannot
take); a CPU tensor goes to the plain version in ``ref.py``. There is no
fallback from a failed build or launch to the plain version.
"""
from __future__ import annotations

import torch

from ..core.bits import words32
from . import bt_count, popcount as _popcount, ref, router_step as _router
from ._build import build_all as _build_all

__all__ = ["popcount", "bt_boundaries", "router_step", "KERNELS",
           "reset_launch_counts", "build_all"]

KERNELS = (_router.KERNEL, _popcount.KERNEL, bt_count.KERNEL)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def build_all():
    """Build every kernel of the port (one ``nvcc`` per source, in
    parallel); returns the seconds each build took."""
    return _build_all(KERNELS)


def popcount(values: torch.Tensor) -> torch.Tensor:
    """'1'-bit count per element -> int32 of the same shape."""
    if values.device.type != "cuda":
        return ref.popcount_ref(values)
    words = words32(values).contiguous()
    return _popcount.popcount_words(words)


def bt_boundaries(words: torch.Tensor) -> torch.Tensor:
    """Bit transitions at each boundary of an (F, L) flit stream -> (F-1,)."""
    if words.device.type != "cuda":
        return ref.bt_boundaries_ref(words)
    return bt_count.bt_boundaries(words32(words).contiguous())


def router_step(state, wire, mc_nodes, cycles: int, mesh_key,
                count_headers: bool):
    """``cycles`` router cycles: the kernel for CUDA state (updated in
    place), the plain step for CPU state."""
    if state.fifo.device.type != "cuda":
        return ref.router_step_ref(state, wire, mc_nodes, cycles, mesh_key,
                                   count_headers)
    return _router.router_step(state, wire, mc_nodes, cycles, mesh_key,
                               count_headers)
