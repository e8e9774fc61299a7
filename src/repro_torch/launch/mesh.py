"""Mesh construction (the port of ``repro.launch.mesh``).

Deliberately functions, not module-level constants: importing this module
touches no device.

The production meshes are the reference's: TPU v5e pods of 256 chips
arranged (data=16, model=16), and the multi-pod mesh with a leading 'pod'
axis, (pod=2, data=16, model=16) = 512 chips. Here they are
:class:`~repro_torch.dist.sharding.LocalMesh` descriptions over the meta
device (one device repeated): the dry run reads their axis names and
sizes, and no process group is created. :func:`make_one_card_mesh` is the
dry run's third mesh, one card as (data=1, model=1). :func:`make_host_mesh`
is a mesh over the cards this host has.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..dist.sharding import LocalMesh

__all__ = ["make_production_mesh", "make_one_card_mesh", "make_host_mesh"]


def _meta_mesh(shape, axes) -> LocalMesh:
    return LocalMesh(np.full(shape, "meta", dtype=object), axes)


def make_production_mesh(*, multi_pod: bool = False) -> LocalMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _meta_mesh(shape, axes)


def make_one_card_mesh() -> LocalMesh:
    """One card, described over the meta device: every spec replicates."""
    return _meta_mesh((1, 1), ("data", "model"))


def make_host_mesh(device: DeviceLike = None) -> LocalMesh:
    """The cards this host has, ("data", "model") shaped (n, 1); with
    ``device="cpu"``, the host itself as (1, 1). Raises without a card
    unless the CPU is asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        return LocalMesh([[f"cuda:{i}"] for i in range(n)],
                         ("data", "model"))
    return LocalMesh([[dev]], ("data", "model"))
