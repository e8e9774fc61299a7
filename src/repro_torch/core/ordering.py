"""The paper's contribution: '1'-bit-count-based data transmission ordering.

The port of ``repro.core.ordering`` for O0-O2:

* :func:`descending_order` - sort a stream by popcount, descending
  (``fill='rowmajor'``, the paper's Fig. 9 layout, or ``'interleave'``).
* :func:`affiliated_order` (O1) - weights sorted by their own popcount,
  inputs carried along so (input, weight) pairs stay matched.
* :func:`separated_order` (O2) - inputs and weights each sorted by their
  own popcount; needs a recovery index (:func:`index_overhead_bits`).
* :func:`min_hamming_order` / :func:`separated_min_hamming_order` (O3) and
  :func:`affiliated_min_hamming_order` (O3a) - chain values by greedy
  multi-start nearest-neighbour Hamming distance with beam lookahead
  (``repro_torch.kernels.min_hamming``), then deal the chain column-major
  across the window's flits so chain neighbours share a wire lane on
  consecutive flits.

Orderings work inside consecutive windows of the stream (``window`` = the
packet payload); ``window=None`` sorts the whole stream. O1/O2 orders are
one ``ops.descending_perm_rows`` call each (the popcount window-order
kernel on CUDA, a stable ``torch.argsort`` on the CPU). The ``pattern``
tiebreak orders equal counts by the bit pattern read as UNSIGNED - a word
with bit 31 set must not sort as negative.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .bits import bit_width, unsigned_view, words32

__all__ = [
    "Ordered",
    "PairedOrdered",
    "pad_to_window",
    "descending_perm",
    "descending_order",
    "affiliated_order",
    "separated_order",
    "min_hamming_perm",
    "min_hamming_order",
    "affiliated_min_hamming_order",
    "separated_min_hamming_order",
    "DEFAULT_BEAM",
    "DEFAULT_STARTS",
    "inverse_permutation",
    "apply_permutation",
    "index_overhead_bits",
]


class Ordered(NamedTuple):
    values: torch.Tensor     # reordered stream, same multiset as the input
    perm: torch.Tensor       # values = input[perm]


class PairedOrdered(NamedTuple):
    inputs: torch.Tensor
    weights: torch.Tensor
    input_perm: torch.Tensor
    weight_perm: torch.Tensor


def _windowed(n: int, window: Optional[int]) -> tuple:
    """Resolve (num_windows, window) for a length-n stream."""
    if window is None or window >= n:
        return 1, n
    if n % window:
        raise ValueError(
            f"stream length {n} is not a multiple of window {window}; "
            "pad the stream before ordering (the packetizer does this)")
    return n // window, window


def pad_to_window(values: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    """Zero-pad a flat stream to the next packet (window) boundary."""
    flat = values.reshape(-1)
    if window is None:
        return flat
    pad = (-flat.shape[0]) % window
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat


def descending_perm(values: torch.Tensor, window: Optional[int] = None,
                    tiebreak: str = "stable") -> torch.Tensor:
    """Permutation sorting ``values`` by '1'-bit count, descending, inside
    each window; flat int64 indices into the zero-padded stream.

    ``stable`` keeps the original order among equal counts; ``pattern``
    orders equal counts by bit pattern, descending as unsigned, then by
    position (the reference's ``argsort(~u)``, then a stable
    ``argsort(-count)``). One ``ops.descending_perm_rows`` call: a single
    launch of the popcount window-order kernel on CUDA, its plain version
    on the CPU.
    """
    from ..kernels import ops

    flat = pad_to_window(values, window)
    nw, w = _windowed(flat.shape[0], window)
    nbits = bit_width(unsigned_view(flat).dtype)
    return ops.descending_perm_rows(words32(flat).reshape(nw, w), tiebreak,
                                    nbits)


def apply_permutation(values: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    return values.reshape(-1)[perm]


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """inv with inv[perm] = arange; used to de-order separated streams."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype,
                             device=perm.device)
    return inv


def descending_order(
    values: torch.Tensor,
    window: Optional[int] = None,
    fill: str = "rowmajor",
    lanes: Optional[int] = None,
    tiebreak: str = "stable",
) -> Ordered:
    """Sort a stream by popcount descending (the paper's core transform).

    fill='rowmajor': flit k gets sorted values [k*lanes, (k+1)*lanes).
    fill='interleave': the sorted window is dealt round-robin across the
        window's flits (x1>=y1>=x2>=y2... per lane pair). Needs ``lanes``.
    """
    flat = pad_to_window(values, window)
    perm = descending_perm(flat, window, tiebreak)
    if fill == "rowmajor":
        return Ordered(flat[perm], perm)
    if fill != "interleave":
        raise ValueError(f"unknown fill {fill!r}")
    if lanes is None:
        raise ValueError("fill='interleave' needs the flit lane count")
    nw, w = _windowed(flat.shape[0], window)
    if w % lanes:
        raise ValueError("window must be a multiple of lanes for interleave")
    dealt = perm.reshape(nw, lanes, w // lanes).transpose(1, 2).reshape(-1)
    return Ordered(flat[dealt], dealt)


def affiliated_order(
    inputs: torch.Tensor,
    weights: torch.Tensor,
    window: Optional[int] = None,
    tiebreak: str = "stable",
) -> PairedOrdered:
    """O1: order (input, weight) pairs by the *weight's* popcount."""
    if weights.numel() != inputs.numel():
        raise ValueError(
            "affiliated ordering needs paired streams of equal length")
    wflat = pad_to_window(weights, window)
    iflat = pad_to_window(inputs, window)
    perm = descending_perm(wflat, window, tiebreak)
    return PairedOrdered(iflat[perm], wflat[perm], perm, perm)


def separated_order(
    inputs: torch.Tensor,
    weights: torch.Tensor,
    window: Optional[int] = None,
    tiebreak: str = "stable",
) -> PairedOrdered:
    """O2: order inputs and weights independently, each by its own popcount."""
    wflat = pad_to_window(weights, window)
    iflat = pad_to_window(inputs, window)
    wperm = descending_perm(wflat, window, tiebreak)
    iperm = descending_perm(iflat, window, tiebreak)
    return PairedOrdered(iflat[iperm], wflat[wperm], iperm, wperm)


# --- O3: minimum-Hamming-distance chaining --------------------------------

DEFAULT_BEAM = 2
DEFAULT_STARTS = 8


def min_hamming_perm(values: torch.Tensor, window: Optional[int] = None,
                     beam: int = DEFAULT_BEAM,
                     starts: int = DEFAULT_STARTS) -> torch.Tensor:
    """Chain permutation minimizing consecutive Hamming distance per window
    (the logical chain order, before the flit deal); flat int64 indices
    into the zero-padded stream."""
    from ..kernels.min_hamming import min_hamming_chain

    flat = pad_to_window(values, window)
    nw, w = _windowed(flat.shape[0], window)
    res = min_hamming_chain(flat.reshape(nw, w), beam=beam, starts=starts)
    offset = (torch.arange(nw, device=flat.device) * w)[:, None]
    return (res.perm.to(torch.int64) + offset).reshape(-1)


def _deal_chain(perm: torch.Tensor, z: torch.Tensor,
                lanes: int) -> torch.Tensor:
    """Deal per-window chain perms (nw, Wp) column-major over the flits.

    Chained (non-zero) value ``i`` goes to flit ``i % F`` lane ``i // F``
    with ``F = max(ceil(z / lanes), 1)``, so chain neighbours share a lane
    on consecutive flits and every flit past ``F`` stays all-zero. Padding
    zeros fill the free slots in ascending order. Wp must be a multiple of
    ``lanes``.
    """
    nw, wp = perm.shape
    idx = torch.arange(wp, device=perm.device)[None, :]
    z = z.to(torch.int64)[:, None]
    fr = torch.clamp(-(-z // lanes), min=1)
    nzslot = (idx % fr) * lanes + idx // fr
    chained = idx < z
    # The reference drops the writes of unchained positions (``mode="drop"``
    # on an out-of-range slot); here they land in a spare column that is cut.
    used = torch.zeros((nw, wp + 1), dtype=torch.int8, device=perm.device)
    used.scatter_(1, torch.where(chained, nzslot, wp), 1)
    free = torch.argsort(used[:, :wp], dim=1, stable=True)   # unused, ascending
    slot = torch.where(chained, nzslot,
                       torch.gather(free, 1, torch.clamp(idx - z, min=0)))
    return torch.zeros_like(perm).scatter_(1, slot, perm)


def _chain_dealt(planes, window: Optional[int], lanes: Optional[int],
                 beam: int, starts: int):
    """Window, pad to a ``lanes`` multiple, chain and deal -> (padded
    planes (nw, Wp) each, flat int64 perm into the padded stream)."""
    from ..kernels.min_hamming import min_hamming_chain

    if lanes is None:
        raise ValueError("min-Hamming ordering needs the flit lane count")
    flats = [pad_to_window(p, window) for p in planes]
    nw, w = _windowed(flats[0].shape[0], window)
    wp = -(-w // lanes) * lanes
    padded = [F.pad(f.reshape(nw, w), (0, wp - w)) for f in flats]
    res = min_hamming_chain(padded, beam=beam, starts=starts)
    dealt = _deal_chain(res.perm.to(torch.int64), res.nonzeros, lanes)
    offset = (torch.arange(nw, device=dealt.device) * wp)[:, None]
    return padded, (dealt + offset).reshape(-1)


def min_hamming_order(
    values: torch.Tensor,
    window: Optional[int] = None,
    lanes: Optional[int] = None,
    beam: int = DEFAULT_BEAM,
    starts: int = DEFAULT_STARTS,
) -> Ordered:
    """O3 single-stream ordering: chain each window by Hamming distance and
    deal the chain across the window's flits.

    Each window is zero-padded to a ``lanes`` multiple before chaining, so
    the result covers ``ceil(w / lanes) * lanes`` slots per window; the
    perm indexes that flit-padded stream.
    """
    (padded,), perm = _chain_dealt([values], window, lanes, beam, starts)
    return Ordered(padded.reshape(-1)[perm], perm)


def affiliated_min_hamming_order(
    inputs: torch.Tensor,
    weights: torch.Tensor,
    window: Optional[int] = None,
    lanes: Optional[int] = None,
    beam: int = DEFAULT_BEAM,
    starts: int = DEFAULT_STARTS,
) -> PairedOrdered:
    """O3a: chain (input, weight) pairs by their *combined* Hamming distance
    (both planes summed - the paired flit's per-lane-pair toggle cost); one
    permutation moves both streams, so pairing survives. ``lanes`` is the
    per-half lane count (``flit lanes // 2`` for paired packing)."""
    if weights.numel() != inputs.numel():
        raise ValueError(
            "affiliated ordering needs paired streams of equal length")
    (ipad, wpad), perm = _chain_dealt([inputs, weights], window, lanes, beam,
                                      starts)
    return PairedOrdered(ipad.reshape(-1)[perm], wpad.reshape(-1)[perm],
                         perm, perm)


def separated_min_hamming_order(
    inputs: torch.Tensor,
    weights: torch.Tensor,
    window: Optional[int] = None,
    lanes: Optional[int] = None,
    beam: int = DEFAULT_BEAM,
    starts: int = DEFAULT_STARTS,
) -> PairedOrdered:
    """O3: chain inputs and weights independently, each by its own Hamming
    distance; needs the O2-style recovery index."""
    oi = min_hamming_order(inputs, window=window, lanes=lanes, beam=beam,
                           starts=starts)
    ow = min_hamming_order(weights, window=window, lanes=lanes, beam=beam,
                           starts=starts)
    return PairedOrdered(oi.values, ow.values, oi.perm, ow.perm)


def index_overhead_bits(window: int) -> int:
    """Bits per value of the separated-ordering recovery index."""
    return max(1, (window - 1).bit_length())
