"""Dispatch between the port's Hopper kernels and their plain versions.

A CUDA tensor goes to the kernel (which raises on anything it cannot
take); a CPU tensor goes to the plain version in ``ref.py``. There is no
fallback from a failed build or launch to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.bits import bit_width, from_words32, unsigned_view, words32
from . import (bitonic_sort as _bitonic, bt_count, chain_greedy as _greedy,
               chain_select as _select, order_unit as _order_unit,
               popcount as _popcount, popcount_order as _porder, ref,
               router_step as _router)
from ._build import build_all as _build_all

__all__ = ["popcount", "bt_boundaries", "bt_total", "bt_measure",
           "router_step",
           "sort_windows_desc", "order_unit", "chain_select", "chain_greedy",
           "descending_perm_rows", "chain_inputs", "KERNELS",
           "reset_launch_counts", "build_all"]

KERNELS = (_router.KERNEL, _popcount.KERNEL, *bt_count.KERNELS,
           _bitonic.KERNEL, _order_unit.KERNEL, _select.KERNEL,
           _greedy.KERNEL, *_porder.KERNELS)


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


def descending_perm_rows(rows: torch.Tensor, tiebreak: str,
                         nbits: int) -> torch.Tensor:
    """Flat int64 permutation sorting each window (row) of ``rows`` by
    '1'-bit count, descending, with the window offsets added (row ``r``'s
    indices run over ``[r W, (r + 1) W)``). ``rows`` is (R, W) int32
    carrying the zero-extended ``nbits``-wide words (8, 16 or 32: the
    carrier cannot say how wide ``~u`` is). ``tiebreak``: ``stable`` (ties
    in position order) or ``pattern`` (ties by bit pattern, descending as
    unsigned, then position)."""
    if rows.dim() != 2 or rows.dtype != torch.int32:
        raise ValueError(f"rows must be (R, W) int32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if nbits not in (8, 16, 32):
        raise ValueError(f"nbits must be 8, 16 or 32, got {nbits}")
    if tiebreak not in ("stable", "pattern"):
        raise ValueError(f"unknown tiebreak {tiebreak!r}")
    if rows.device.type != "cuda":
        return ref.descending_perm_rows_ref(rows, tiebreak, nbits)
    return _porder.descending_perm(rows.contiguous(), tiebreak, nbits)


def chain_inputs(u: torch.Tensor, starts: int):
    """The O3 chain preamble of (P, R, W) int32 planes (P = 1 or 2, W >=
    1): ``(part, q, z, cid, start_pos)`` - the zeros-to-tail partition
    (R, W) int64, the partitioned planes, the (R,) int32 live counts, the
    (R,) int32 cost of the partitioned identity order and the (R, starts)
    int64 start positions (descending-count ranks ``(s z) // starts``)."""
    if u.dim() != 3 or u.shape[0] not in (1, 2) or u.dtype != torch.int32:
        raise ValueError(f"u must be (P, R, W) int32 with P in (1, 2), got "
                         f"{tuple(u.shape)} {u.dtype}")
    if u.shape[2] < 1 or starts < 1:
        raise ValueError(f"chain_inputs needs W >= 1 and starts >= 1, got "
                         f"W = {u.shape[2]}, starts = {starts}")
    if u.device.type != "cuda":
        return ref.chain_inputs_ref(u, starts)
    return _porder.chain_inputs(u.contiguous(), starts)


def bt_boundaries(words: torch.Tensor) -> torch.Tensor:
    """Bit transitions at each boundary of an (F, L) flit stream -> (F-1,)."""
    if words.device.type != "cuda":
        return ref.bt_boundaries_ref(words)
    return bt_count.bt_boundaries(words32(words).contiguous())


def bt_total(words: torch.Tensor) -> torch.Tensor:
    """Total bit transitions over an (F, L) flit stream -> int32 scalar,
    summed as an int32 sum wraps (one launch on the card)."""
    if words.device.type != "cuda":
        return ref.bt_total_ref(words)
    return bt_count.bt_total(words32(words).contiguous())


def bt_measure(words: torch.Tensor) -> torch.Tensor:
    """``[total, S1, S2]`` (int64, shape (3,)) of an (F, L) flit stream: the
    BT total as an int32 sum wraps, and the sums of x + y and x y over every
    pair of words sharing a lane on consecutive flits, x and y their
    popcounts (one launch on the card)."""
    if words.device.type != "cuda":
        return ref.bt_measure_ref(words)
    return bt_count.bt_measure(words32(words).contiguous())


def router_step(state, wire, mc_nodes, cycles: int, mesh_key,
                count_headers: bool):
    """``cycles`` router cycles: the kernel for CUDA state (updated in
    place), the plain step for CPU state."""
    if state.fifo.device.type != "cuda":
        return ref.router_step_ref(state, wire, mc_nodes, cycles, mesh_key,
                                   count_headers)
    return _router.router_step(state, wire, mc_nodes, cycles, mesh_key,
                               count_headers)


def _check_window(w: int) -> None:
    if w & (w - 1) or w < 128:
        raise ValueError(f"window must be a power of two >= 128, got {w}")


def sort_windows_desc(keys: torch.Tensor, *payloads: torch.Tensor):
    """Descending key sort within each row of (R, W) tensors by the bitonic
    network, W a power of two >= 128; payloads (any dtype with a bit
    pattern view, 0-2 of them) ride the swaps and come back in their own
    dtype. Keys are taken as int32; returns ``(keys, *payloads)``."""
    if keys.dim() != 2:
        raise ValueError(f"keys must be (R, W), got {tuple(keys.shape)}")
    _check_window(keys.shape[1])
    for p in payloads:
        if p.shape != keys.shape:
            raise ValueError("payload shape must match keys")
    k32 = keys.to(torch.int32).contiguous()
    carried = [words32(p).contiguous() for p in payloads]
    if keys.device.type != "cuda":
        outs = ref.sort_windows_ref(k32, *carried)
    else:
        outs = _bitonic.sort_windows(k32, *carried)
    return (outs[0], *(from_words32(o, p.dtype)
                       for o, p in zip(outs[1:], payloads)))


def order_unit(values: torch.Tensor):
    """The fused ordering unit: (R, W) 32-bit values, W a power of two >=
    128 -> (values ordered by popcount descending within each row, the
    window-local permutation int32)."""
    if values.dim() != 2:
        raise ValueError(f"values must be (R, W), got {tuple(values.shape)}")
    if bit_width(values.dtype) != 32:
        raise TypeError(
            f"order_unit takes 32-bit values, got {values.dtype}; the "
            "reference returns (R, W, 4) for narrower dtypes (ROADMAP C8), "
            "so the port refuses them")
    _check_window(values.shape[1])
    words = unsigned_view(values).contiguous()
    if values.device.type != "cuda":
        out, perm = ref.order_unit_ref(words)
    else:
        out, perm = _order_unit.order_unit_words(words)
    return out.view(values.dtype), perm


def chain_select(xors, penalty: torch.Tensor, k2: Optional[int] = None):
    """Distance + select body of one O3 chain step: 1-2 (R, W) XOR planes
    (a tensor or a sequence) and an (R, W) int32 penalty -> ``(dvec,
    order)``, the summed popcount distance per lane and the lanes sorted
    ascending by ``dvec * k2 + idx + penalty`` (``k2`` defaults to W)."""
    planes = (xors,) if isinstance(xors, torch.Tensor) else tuple(xors)
    planes = tuple(words32(p).contiguous() for p in planes)
    if not planes or len({tuple(p.shape) for p in planes}) != 1 \
            or planes[0].dim() != 2:
        raise ValueError("xor planes must share a (R, W) shape")
    if tuple(penalty.shape) != tuple(planes[0].shape):
        raise ValueError(f"penalty must be {tuple(planes[0].shape)}, got "
                         f"{tuple(penalty.shape)}")
    k2 = planes[0].shape[1] if k2 is None else int(k2)
    pen = penalty.to(torch.int32).contiguous()
    if pen.device.type != "cuda":
        return ref.chain_select_ref(planes, pen, k2)
    return _select.chain_select(planes, pen, k2)


def chain_greedy(q: torch.Tensor, z: torch.Tensor, start: torch.Tensor,
                 beam: int):
    """Every step of the greedy beam-lookahead O3 chains of one chain call:
    partitioned (P, R, W) planes (P = 1 or 2, any 32-bit dtype), (R,) live
    counts and (R, S) start positions -> ``(orders (R, S, W), costs (R,
    S))`` int32, ``1 <= beam <= W``."""
    if q.dim() != 3:
        raise ValueError(f"q must be (P, R, W), got {tuple(q.shape)}")
    p, r, w = q.shape
    if tuple(z.shape) != (r,) or start.dim() != 2 or start.shape[0] != r:
        raise ValueError(f"z must be ({r},) and start ({r}, S), got "
                         f"{tuple(z.shape)} and {tuple(start.shape)}")
    if w and not 1 <= beam <= w:
        raise ValueError(f"beam must be in [1, {w}], got {beam}")
    q32 = words32(q).contiguous()
    z32 = z.to(torch.int32).contiguous()
    s32 = start.to(torch.int32).contiguous()
    if q.device.type != "cuda":
        return ref.chain_greedy_ref(q32, z32, s32, beam)
    return _greedy.chain_greedy(q32, z32, s32, beam)
