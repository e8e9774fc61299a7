"""Static popcount-ordered weight layouts (the paper's Fig. 5, stored).

The port of ``repro.dist.static_reorder``. Permuting an MLP's up/gate
projection columns together with its down projection rows is a similarity
transform of the block: each (unit activation, unit row) pair travels
together, exactly the affiliated-ordering invariance, so the model computes
the same function. Stored popcount-descending, the weight stream leaving
memory is already in the paper's wire order.

:func:`reorder_lm_params` rewrites every MLP (and MoE expert FFN) of a
parameter tree this way; :func:`stream_bt_report` measures what the layout
is worth on the wire: BT per 16-lane bf16 flit of the unit-major weight
stream, before and after. On CUDA tensors the unit counts go through the
popcount kernel (``ops.popcount``) and the BT totals through the BT counter
(``ops.bt_total``).
"""
from __future__ import annotations

import torch

from ..core import bt as bt_mod
from ..core.bits import popcount
from ..core.flits import pack

__all__ = ["mlp_unit_permutation", "reorder_mlp", "reorder_lm_params",
           "stream_bt_total", "stream_bt_report"]


def mlp_unit_permutation(w: torch.Tensor) -> torch.Tensor:
    """Popcount-descending permutation of the unit (last) axis of ``w``.

    ``w`` is ``(..., d, f)`` with hidden units as columns; unit j's key is
    the total '1'-bit count of column j (an int32 sum). Leading axes (scan
    layers, experts) get their own permutations. Stable among ties (int64
    indices).
    """
    counts = popcount(w).sum(dim=-2, dtype=torch.int32)
    return torch.argsort(-counts, dim=-1, stable=True)


def _take_cols(w: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """w (..., d, f)[..., :, perm] with a batched perm (..., f)."""
    return torch.take_along_dim(w, perm.unsqueeze(-2), dim=-1)


def _take_rows(w: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """w (..., f, d)[..., perm, :] with a batched perm (..., f)."""
    return torch.take_along_dim(w, perm.unsqueeze(-1), dim=-2)


def reorder_mlp(p: dict):
    """Reorder one MLP dict {"wu", "wd"[, "wg", ...]} -> (new dict, perm).

    A unit's key is its total popcount over every matrix it appears in
    (wu / wg columns and wd rows): its whole wire footprint. Keys other
    than wu / wg / wd (a MoE router) pass through untouched.
    """
    mats = [p["wu"]]
    if "wg" in p:
        mats.append(p["wg"])
    mats.append(p["wd"].transpose(-1, -2))
    perm = mlp_unit_permutation(torch.cat(mats, dim=-2))
    new = dict(p)
    new["wu"] = _take_cols(p["wu"], perm)
    if "wg" in p:
        new["wg"] = _take_cols(p["wg"], perm)
    new["wd"] = _take_rows(p["wd"], perm)
    return new, perm


def _is_mlp_dict(v) -> bool:
    return isinstance(v, dict) and "wu" in v and "wd" in v


def reorder_lm_params(params):
    """Popcount-order every MLP / MoE FFN of a parameter tree (dicts are
    walked; every other node is kept as it is)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: reorder_mlp(v)[0] if _is_mlp_dict(v) else walk(v)
                    for k, v in node.items()}
        return node
    return walk(params)


def _unit_major_stream(params, wire_dtype: torch.dtype) -> torch.Tensor:
    """Every MLP matrix of the tree as one flat stream, one hidden unit at a
    time (wu / wg transposed to (..., f, d); wd is unit-major already),
    dict keys in sorted order."""
    chunks = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                v = node[k]
                if _is_mlp_dict(v):
                    for name in ("wu", "wg", "wd"):
                        if name in v:
                            m = v[name] if name == "wd" else \
                                v[name].transpose(-1, -2)
                            chunks.append(m.reshape(-1).to(wire_dtype))
                else:
                    walk(v)

    walk(params)
    if not chunks:
        raise ValueError("no MLP blocks found in the parameter tree")
    return torch.cat(chunks)


def _stream(params, lanes: int, wire_dtype: torch.dtype):
    return pack(_unit_major_stream(params, wire_dtype), lanes)


def stream_bt_total(params, lanes: int = 16,
                    wire_dtype: torch.dtype = torch.bfloat16):
    """(BT total, flits) of the unit-major MLP weight stream of ``params``
    in ``lanes``-wide flits: the total as the reference's int32 sum wraps
    (one BT-counter launch on the card), read to the host as an int."""
    stream = _stream(params, lanes, wire_dtype)
    return int(bt_mod.bt_stream(stream)), stream.words.shape[0]


def stream_bt_report(before, after, lanes: int = 16,
                     wire_dtype: torch.dtype = torch.bfloat16) -> dict:
    """BT per flit of the unit-major MLP weight stream, before vs after
    (``params`` and ``reorder_lm_params(params)``): float32 scalars. A
    stream past 2^31 transitions wraps as the reference's int32 sum does;
    report a large tree block by block (:func:`stream_bt_total`)."""
    bt0 = bt_mod.bt_per_flit(_stream(before, lanes, wire_dtype))
    bt1 = bt_mod.bt_per_flit(_stream(after, lanes, wire_dtype))
    return {
        "bt_per_flit_before": bt0,
        "bt_per_flit_after": bt1,
        "reduction": bt_mod.reduction_rate(bt0, bt1),
    }
