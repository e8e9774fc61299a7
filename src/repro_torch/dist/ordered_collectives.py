"""Transmission ordering for gradient-collective payloads.

The port of ``repro.dist.ordered_collectives``. The update that consumes a
(gradient, weight) pair is order-invariant, the reduction is elementwise,
and the weights are replicated across data-parallel peers, so every peer
can compute the same weight-keyed permutation locally and no index ever
travels: O1 on the gradient wire. O2 (each stream by its own popcount)
bounds the win at the cost of a per-window index.

* :func:`order_gradient_bucket` / :func:`restore_gradient_bucket` - the
  payload transform, built on ``core.ordering.affiliated_order``; restore
  is its exact inverse (a permutation never touches bit patterns).
* :func:`gradient_wire_report` - BT of a 16-lane bf16 flit stream of
  (gradient, weight) pairs under O0 / O1 / O2. On CUDA tensors the orders
  are the popcount window-order kernel (``ops.descending_perm_rows``, 16-bit
  words) and the totals the BT counter (``ops.bt_total``).

Trees flatten in the reference's order (``repro_torch.tree.leaves``: dict
keys sorted). BT totals are int32 sums; ``bt_per_flit`` and the reductions
divide in float32, as the reference does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import bt as bt_mod
from ..core.ordering import (affiliated_order, index_overhead_bits,
                             inverse_permutation, pad_to_window)
from ..core.wire import (AffiliatedTransform, IdentityTransform,
                         SeparatedTransform)
from ..tree import leaves

__all__ = ["GradientBucket", "order_gradient_bucket",
           "restore_gradient_bucket", "gradient_wire_report"]


class GradientBucket(NamedTuple):
    """One ordered all-reduce bucket.

    values: the zero-padded gradient stream in wire order.
    perm:   wire order as indices into the padded natural-order stream;
            derived from the replicated weights, so every peer holds it
            without communicating it.
    """

    values: torch.Tensor
    perm: torch.Tensor


def order_gradient_bucket(grads: torch.Tensor, weights: torch.Tensor,
                          window: Optional[int] = 256,
                          tiebreak: str = "stable") -> GradientBucket:
    """O1-order one flat gradient bucket by its weights' '1'-bit counts.

    Both streams are zero-padded to the next window boundary, so the values
    may be longer than the input. ``window=None`` orders the whole stream
    as one window.
    """
    po = affiliated_order(grads, weights, window=window, tiebreak=tiebreak)
    return GradientBucket(po.inputs, po.input_perm)


def restore_gradient_bucket(bucket: GradientBucket,
                            length: int) -> torch.Tensor:
    """Exact inverse of :func:`order_gradient_bucket`: the first ``length``
    values in natural order, bit-identical to the stream that was ordered."""
    return bucket.values[inverse_permutation(bucket.perm)][:length]


def _flat_stream(tree, dtype: torch.dtype) -> torch.Tensor:
    """A tree's leaves, in the reference's order, as one flat stream."""
    flat = leaves(tree)
    if not flat:
        raise ValueError("empty gradient tree")
    return torch.cat([x.reshape(-1).to(dtype) for x in flat])


def gradient_wire_report(grads, params, window: Optional[int] = 256,
                         lanes: int = 16,
                         wire_dtype: torch.dtype = torch.bfloat16) -> dict:
    """BT of the gradient wire under O0 / O1 / O2, on real gradient trees.

    A flit carries ``lanes // 2`` gradients and their ``lanes // 2``
    weights (the paper's Fig. 2 layout, bf16 wire format). O0 streams in
    natural order; O1 orders pairs by the weight's popcount; O2 orders each
    half by its own popcount (``o2_index_bits`` a value to re-pair).
    ``bt_*`` are int32 scalars, ``bt_per_flit_baseline`` and the reductions
    float32 scalars, ``o2_index_bits`` an int.
    """
    g = pad_to_window(_flat_stream(grads, wire_dtype), window)
    w = pad_to_window(_flat_stream(params, wire_dtype), window)
    base = IdentityTransform().apply(g, w, lanes)
    o1 = AffiliatedTransform(window=window).apply(g, w, lanes)
    o2 = SeparatedTransform(window=window).apply(g, w, lanes)
    bt0 = bt_mod.bt_stream(base)
    bt1 = bt_mod.bt_stream(o1)
    bt2 = bt_mod.bt_stream(o2)
    eff_window = int(g.shape[0]) if window is None else window
    return {
        "bt_baseline": bt0,
        "bt_o1": bt1,
        "bt_o2": bt2,
        "bt_per_flit_baseline": bt_mod.bt_per_flit(base),
        "reduction_o1": bt_mod.reduction_rate(bt0, bt1),
        "reduction_o2": bt_mod.reduction_rate(bt0, bt2),
        "o2_index_bits": index_overhead_bits(eff_window),
    }
