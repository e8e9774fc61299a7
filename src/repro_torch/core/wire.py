"""WireTransform: the composable link-payload transform API.

The port of ``repro.core.wire`` for the paper's three configurations and
the min-Hamming chains:

    O0 (baseline)   -> IdentityTransform
    O1 (affiliated) -> AffiliatedTransform   (keyed on the weight stream)
    O2 (separated)  -> SeparatedTransform
    O3              -> MinHammingTransform   (each stream chained alone)
    O3a             -> MinHammingAffiliatedTransform (pairs chained together)

plus the single-stream ``desc`` transform. Each reports the recovery
overhead a receiver needs, so benchmarks charge it honestly. MSR payload
compression (``core.msr``) is the compression axis: ``COMPRESSIONS`` and
``compression_overhead_bits``, its escape records charged like the
recovery index. Flit protection arrives with a later slice (ROADMAP queue
A, item 13).

``order_packets`` is the row-batched form the packetizer uses: row ``i`` of
its result is ``order(inputs[i], weights[i])``, i.e. each packet is its own
stream, windowed by ``window`` inside the packet; ``order_single_packets``
is the same for the result phase's single-stream packets.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import bt as bt_mod
from . import msr, ordering
from .flits import FlitStream, pack, pack_paired

__all__ = [
    "WireTransform",
    "IdentityTransform",
    "DescendingTransform",
    "AffiliatedTransform",
    "SeparatedTransform",
    "MinHammingTransform",
    "MinHammingAffiliatedTransform",
    "TRANSFORMS",
    "by_name",
    "measure",
    "COMPRESSIONS",
    "compression_overhead_bits",
    "PROTECTION_BITS",
    "protection_overhead_bits",
    "crc8_reference",
    "protection_syndrome_masks",
]


@dataclasses.dataclass(frozen=True)
class WireTransform:
    """Base: pack a paired (inputs, weights) stream into flits untouched."""

    name: str = "O0"
    window: Optional[int] = None
    tiebreak: str = "stable"   # "pattern" clusters equal-count values

    # Whether ``order`` permutes values (and so pads to its window).
    reorders = False

    def overhead_bits_per_value(self, window: int, paired: bool = True) -> int:
        """Recovery bits the receiver needs per transmitted value
        (``paired=True``: request phase, only re-pairing is chargeable;
        ``paired=False``: a single stream whose order must be restored)."""
        return 0

    def order(self, inputs: torch.Tensor, weights: torch.Tensor, lanes: int):
        """The value reordering alone, before flit packing."""
        return inputs, weights

    def order_single(self, values: torch.Tensor, lanes: int) -> torch.Tensor:
        return values

    def apply(self, inputs: torch.Tensor, weights: torch.Tensor,
              lanes: int) -> FlitStream:
        oi, ow = self.order(inputs, weights, lanes)
        return pack_paired(oi, ow, lanes)

    def apply_single(self, values: torch.Tensor, lanes: int) -> FlitStream:
        return pack(self.order_single(values, lanes), lanes)

    def _per_row(self, *planes: torch.Tensor):
        """This transform windowed per packet - the row width ``k``, or its
        own window where narrower - and the (n, k) rows zero-padded to a
        multiple of that window."""
        k = planes[0].shape[1]
        w = k if self.window is None or self.window >= k else self.window
        kp = -(-k // w) * w
        if kp != k:
            planes = tuple(F.pad(p, (0, kp - k)) for p in planes)
        return dataclasses.replace(self, window=w), planes

    def order_packets(self, inputs: torch.Tensor, weights: torch.Tensor,
                      lanes: int):
        """Row-batched :meth:`order` over (n, k) packets -> (n, k') each
        (``k'`` is ``k`` padded to the window, and for O3/O3a each window
        further padded to a multiple of ``lanes // 2``)."""
        if not self.reorders:
            return inputs, weights
        n = inputs.shape[0]
        inner, (inputs, weights) = self._per_row(inputs, weights)
        oi, ow = inner.order(inputs.reshape(-1), weights.reshape(-1), lanes)
        return oi.reshape(n, -1), ow.reshape(n, -1)

    def order_single_packets(self, values: torch.Tensor,
                             lanes: int) -> torch.Tensor:
        """Row-batched :meth:`order_single` over (n, k) single-stream
        packets (the result phase's) -> (n, k'), padded as
        :meth:`order_packets` pads."""
        if not self.reorders:
            return values
        n = values.shape[0]
        inner, (values,) = self._per_row(values)
        return inner.order_single(values.reshape(-1), lanes).reshape(n, -1)


class IdentityTransform(WireTransform):
    pass


@dataclasses.dataclass(frozen=True)
class DescendingTransform(WireTransform):
    """Single-stream popcount-descending ordering (no pairing semantics)."""

    name: str = "desc"
    fill: str = "rowmajor"
    reorders = True

    def overhead_bits_per_value(self, window: int, paired: bool = True) -> int:
        return ordering.index_overhead_bits(window)

    def order_single(self, values: torch.Tensor, lanes: int) -> torch.Tensor:
        return ordering.descending_order(
            values, window=self.window, fill=self.fill,
            lanes=lanes if self.fill == "interleave" else None,
            tiebreak=self.tiebreak).values

    def order(self, inputs: torch.Tensor, weights: torch.Tensor, lanes: int):
        half = (lanes // 2) if self.fill == "interleave" else None
        oi = ordering.descending_order(inputs, window=self.window,
                                       fill=self.fill, lanes=half,
                                       tiebreak=self.tiebreak)
        ow = ordering.descending_order(weights, window=self.window,
                                       fill=self.fill, lanes=half,
                                       tiebreak=self.tiebreak)
        return oi.values, ow.values


@dataclasses.dataclass(frozen=True)
class AffiliatedTransform(WireTransform):
    """O1: order pairs by weight popcount; pairing intact, zero recovery cost."""

    name: str = "O1"
    reorders = True

    def overhead_bits_per_value(self, window: int, paired: bool = True) -> int:
        return 0 if paired else ordering.index_overhead_bits(window)

    def order(self, inputs: torch.Tensor, weights: torch.Tensor, lanes: int):
        po = ordering.affiliated_order(inputs, weights, window=self.window,
                                       tiebreak=self.tiebreak)
        return po.inputs, po.weights

    def order_single(self, values: torch.Tensor, lanes: int) -> torch.Tensor:
        return ordering.descending_order(values, window=self.window,
                                         tiebreak=self.tiebreak).values


@dataclasses.dataclass(frozen=True)
class SeparatedTransform(WireTransform):
    """O2: order each stream by its own popcount; index needed to re-pair."""

    name: str = "O2"
    reorders = True

    def overhead_bits_per_value(self, window: int, paired: bool = True) -> int:
        return ordering.index_overhead_bits(window)

    def order(self, inputs: torch.Tensor, weights: torch.Tensor, lanes: int):
        po = ordering.separated_order(inputs, weights, window=self.window,
                                      tiebreak=self.tiebreak)
        return po.inputs, po.weights

    def order_single(self, values: torch.Tensor, lanes: int) -> torch.Tensor:
        return ordering.descending_order(values, window=self.window,
                                         tiebreak=self.tiebreak).values


@dataclasses.dataclass(frozen=True)
class MinHammingTransform(WireTransform):
    """O3: chain each stream by consecutive Hamming distance (separated).

    Popcount sorting (O1/O2) is a proxy for the wire objective; O3
    minimizes consecutive-flit Hamming distance directly and deals each
    chain column-major, so chain neighbours occupy one lane on consecutive
    flits. Streams are chained independently, so re-pairing needs an
    O2-style index - and so does a single stream's order recovery.
    """

    name: str = "O3"
    beam: int = ordering.DEFAULT_BEAM
    starts: int = ordering.DEFAULT_STARTS
    reorders = True

    def overhead_bits_per_value(self, window: int, paired: bool = True) -> int:
        return ordering.index_overhead_bits(window)

    def order(self, inputs: torch.Tensor, weights: torch.Tensor, lanes: int):
        po = ordering.separated_min_hamming_order(
            inputs, weights, window=self.window, lanes=lanes // 2,
            beam=self.beam, starts=self.starts)
        return po.inputs, po.weights

    def order_single(self, values: torch.Tensor, lanes: int) -> torch.Tensor:
        return ordering.min_hamming_order(
            values, window=self.window, lanes=lanes,
            beam=self.beam, starts=self.starts).values


@dataclasses.dataclass(frozen=True)
class MinHammingAffiliatedTransform(MinHammingTransform):
    """O3a: one min-Hamming chain over the *combined* pair distance; one
    shared permutation keeps pairs matched - zero recovery cost on the
    request phase, like O1."""

    name: str = "O3a"

    def overhead_bits_per_value(self, window: int, paired: bool = True) -> int:
        return 0 if paired else ordering.index_overhead_bits(window)

    def order(self, inputs: torch.Tensor, weights: torch.Tensor, lanes: int):
        po = ordering.affiliated_min_hamming_order(
            inputs, weights, window=self.window, lanes=lanes // 2,
            beam=self.beam, starts=self.starts)
        return po.inputs, po.weights


TRANSFORMS = {
    "O0": IdentityTransform,
    "O1": AffiliatedTransform,
    "O2": SeparatedTransform,
    "O3": MinHammingTransform,
    "O3a": MinHammingAffiliatedTransform,
    "desc": DescendingTransform,
}


def by_name(name: str, window: Optional[int] = None, **kw) -> WireTransform:
    return TRANSFORMS[name](name=name, window=window, **kw)


def measure(stream: FlitStream) -> dict:
    """BT metrics of one flit stream (the Fig. 8 recorder). The stream's BT
    and Eq. 3's sums are taken together (one launch and one read on the
    card); the per-flit figure divides the total as ``bt_per_flit`` does,
    and the expected BT is formed from the sums, both on the host."""
    total, s1, s2 = bt_mod.stream_sums(stream)
    return {
        "total_bt": float(total),
        "bt_per_flit": bt_mod.per_flit(total, stream.words.shape[0]),
        "expected_bt": bt_mod.expected_bt(s1, s2, stream.value_bits),
        "num_flits": int(stream.words.shape[0]),
        "flit_bits": stream.flit_bits,
    }


# MSR payload compression (``core.msr``): the 5-bit codes ride the payload
# lanes (fewer flits); the per-window escape records - outlier count and a
# (position, top bits) record per outlier - ride the sideband like the
# recovery index, charged analytically at half a transition per bit.

COMPRESSIONS = ("none", "msr")


def compression_overhead_bits(compression: str, values: torch.Tensor,
                              window: int) -> int:
    """Escape/metadata bits a compression scheme owes for sending
    ``values`` in ``window``-slot windows (a 2-D operand matrix charges one
    window a row; a flat stream is split into ``ceil(n / window)``).

    ``none`` owes nothing; ``msr`` owes the escape records
    (:func:`core.msr.escape_bits`). Outlier status is per value, so the
    charge is the same under every transform's in-window permutation."""
    if compression == "none":
        return 0
    if compression != "msr":
        raise KeyError(f"unknown compression scheme {compression!r}; "
                       f"supported: {COMPRESSIONS}")
    return msr.escape_bits(values, window)


# Flit protection codes (the fault-injection wire axis). The code bits ride
# the sideband, not the payload lanes, so they never perturb the recorded
# payload BT: their cost is charged analytically, like the O2 recovery
# index, on every transmitted flit.

PROTECTION_BITS = {"none": 0, "parity": 1, "crc8": 8}


def protection_overhead_bits(protect: str, num_flits: int) -> int:
    """Protection bits owed for ``num_flits`` transmitted flits (callers
    charge the transmitted count, retransmissions included)."""
    return PROTECTION_BITS[protect] * int(num_flits)


def crc8_reference(data: bytes) -> int:
    """Bitwise CRC-8 (poly 0x07, init 0, MSB-first, no xor-out). With init
    0 the map is linear over GF(2): ``crc(a ^ b) = crc(a) ^ crc(b)``."""
    crc = 0
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


@functools.lru_cache(maxsize=None)
def protection_syndrome_masks(protect: str, lanes: int) -> np.ndarray:
    """``(code_bits, lanes)`` int32 masks (uint32 bit patterns, so
    ``0xFFFFFFFF`` is -1): code bit ``j`` of a flit payload is
    ``popcount(payload & masks[j]) & 1`` summed over the lanes.

    The message is the payload words in lane order, little-endian bytes,
    LSB-first bits; both codes are linear with zero init, so a code is the
    XOR of its set bits' syndromes. Parity is the one all-ones mask. Cached
    per ``(protect, lanes)``; the array is read-only."""
    if protect not in PROTECTION_BITS:
        raise KeyError(f"unknown protection scheme {protect!r}; "
                       f"supported: {sorted(PROTECTION_BITS)}")
    masks = np.zeros((PROTECTION_BITS[protect], lanes), dtype=np.uint32)
    if protect == "parity":
        masks[0, :] = 0xFFFFFFFF
    elif protect == "crc8":
        for pos in range(lanes * 32):
            msg = bytearray(lanes * 4)
            msg[pos // 8] = 1 << (pos % 8)
            syndrome = crc8_reference(bytes(msg))
            for j in range(8):
                if syndrome >> j & 1:
                    masks[j, pos // 32] |= np.uint32(1 << (pos % 32))
    masks = masks.view(np.int32)
    masks.flags.writeable = False
    return masks
