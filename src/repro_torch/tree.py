"""Parameter and gradient trees: nested dicts, lists and tuples of tensors.

The reference flattens its pytrees with ``jax.tree.leaves``: a dict's keys
in sorted order, lists and tuples in order, ``None`` dropped. PyTorch's own
pytree flattening keeps a dict's insertion order, so a tree built with its
keys in another order would stream its leaves in another order; the port
flattens with :func:`leaves`, in the reference's order, and
:func:`unflatten` fills a tree back in that order. :func:`from_numpy`
carries a reference tree (numpy arrays: ``init_params`` or ``jax.grad``
trees through ``np.asarray``) across as tensors on a device.
:func:`leaves_with_path` names each leaf as the reference's checkpoints
do (``jax.tree_util.tree_flatten_with_path`` joined by ``/``).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ._device import DeviceLike, resolve_device

__all__ = ["leaves", "leaves_with_path", "unflatten", "map_leaves", "take",
           "from_numpy"]


def _children(node):
    """A node's children in flattening order, or None for a leaf."""
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(node)
    return None


def leaves(tree, is_leaf: Optional[Callable] = None) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order: dict keys
    sorted, lists and tuples in order, ``None`` dropped; a node for which
    ``is_leaf`` is true is a leaf."""
    if tree is None:
        return []
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return [tree]
    return [x for kid in kids for x in leaves(kid, is_leaf)]


def leaves_with_path(tree, prefix: str = "") -> list:
    """``(key, leaf)`` pairs in :func:`leaves` order, each key the
    reference checkpoint's: the path's entries joined by ``/``, a dict key
    as itself, a list or tuple index as its number (``None`` entries are
    dropped but keep their index), a NamedTuple field as ``.name``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        named = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        named = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        named = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [(prefix, tree)]
    return [kv for name, kid in named for kv in leaves_with_path(
        kid, f"{prefix}/{name}" if prefix else name)]


def unflatten(tree, flat) -> object:
    """A tree shaped like ``tree`` whose leaves are ``flat``, taken in
    :func:`leaves` order (dicts keep ``tree``'s key order)."""
    flat = list(flat)
    n = len(leaves(tree))
    if len(flat) != n:
        raise ValueError(f"{len(flat)} leaves for a tree of {n}")
    it = iter(flat)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            filled = {k: build(node[k]) for k in sorted(node)}
            return {k: filled[k] for k in node}
        if isinstance(node, (list, tuple)):
            kids = [build(kid) for kid in node]
            if hasattr(node, "_fields"):        # a NamedTuple
                return type(node)(*kids)
            return type(node)(kids)
        return next(it)

    return build(tree)


def map_leaves(fn: Callable, tree) -> object:
    """``fn`` of every leaf, in the structure of ``tree``."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])


def take(tree, i: int) -> object:
    """Entry ``i`` of every leaf's leading axis (views): one layer of a
    tree stacked over layers."""
    return map_leaves(lambda x: x[i], tree)


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)                     # a writable copy
    if a.dtype.name == "bfloat16":      # numpy has no bf16 of its own
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_numpy(tree, device: DeviceLike = None) -> object:
    """A tree of numpy arrays (or anything ``np.array`` takes) as the same
    tree of tensors on ``device``, dtypes kept (bf16 included)."""
    dev = resolve_device(device)
    return map_leaves(lambda a: _tensor(a, dev), tree)
