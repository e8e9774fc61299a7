"""Parameter specs: shapes + logical axes, before any tensor exists (the
port of ``repro.models.spec``).

Each model describes its parameters as a dict (nested dicts allowed) of
:class:`ParamSpec`; :func:`init_params` materialises one with a
``torch.Generator`` (the port's own random init: the reference draws from
``jax.random``, so the numbers differ and are never a parity input),
:func:`axes_tree` gives the logical axes, and :func:`param_count` /
:func:`param_bytes` size it.

Logical axis vocabulary (the reference's, ``repro/dist/sharding.py``):
    batch seq embed mlp heads kv_heads head_dim vocab experts layers
    conv_in conv_out state
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device

__all__ = ["ParamSpec", "init_params", "abstract_params", "axes_tree",
           "is_spec", "param_count", "param_bytes"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]    # logical axis per dim (None: replicated)
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"               # normal | zeros | ones | embed
    scale: float = 1.0                 # stddev multiplier for normal

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank "
                             "mismatch")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def _map(fn: Callable, specs):
    """``fn`` over every spec of a (nested) dict, keeping its structure."""
    if is_spec(specs):
        return fn(specs)
    return {k: _map(fn, v) for k, v in specs.items()}


def _leaves(specs):
    if is_spec(specs):
        return [specs]
    return [s for v in specs.values() for s in _leaves(v)]


def _init_one(spec: ParamSpec, generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init in ("normal", "embed"):
        # Fan-in scaled normal: the last axis is the output dim (x @ w with
        # w (in, out)); embed, and 1-D specs, take the scale itself.
        if spec.init == "embed" or len(spec.shape) < 2:
            std = spec.scale
        else:
            std = spec.scale / max(math.prod(spec.shape[:-1]), 1) ** 0.5
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * std).to(spec.dtype)
    raise ValueError(f"unknown init {spec.init}")


def init_params(specs, generator: torch.Generator,
                device: DeviceLike = None):
    """Materialise a spec dict into tensors on ``device``, leaf by leaf in
    the dict's order from one ``generator`` (which must live on that
    device)."""
    dev = resolve_device(device)
    return _map(lambda s: _init_one(s, generator, dev), specs)


def abstract_params(specs):
    """Shape-only parameters for a dry run (the reference's
    ShapeDtypeStruct tree): tensors on the meta device, each of its spec's
    shape and dtype, with no storage behind them."""
    return _map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                specs)


def axes_tree(specs):
    """Logical axes, in the structure of the specs."""
    return _map(lambda s: s.axes, specs)


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for s in _leaves(specs))


def param_bytes(specs) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize for s in _leaves(specs))
