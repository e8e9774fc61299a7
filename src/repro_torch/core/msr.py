"""MSR (Most-Significant-Run) flit compression: 8b -> 5b payload codes.

The port of ``repro.core.msr``. Trained int8 tensors are dominated by
near-zero values whose top bits copy the sign: whenever the ``MSR_RUN = 4``
most significant bits of a byte are a run of the sign bit, the value fits
in ``CODE_BITS = 5`` two's-complement bits and the wire needs only its low
five. The codec splits a value stream into fixed windows and produces

* a dense 5-bit *code* per value (the low five bits - always, so the flit
  geometry stays data-independent: the packetizer keeps one skeleton per
  layer and the streamed path stays equal to the one-shot path), and
* per-window *escape metadata* for the outliers whose MSR is shorter than
  the threshold: an outlier count, and per outlier its window position and
  its ``ESCAPE_BITS = 3`` explicit top bits.

The payload lanes always shrink 8b -> 5b, while the escape records ride
the sideband and are charged analytically at half a transition per bit,
like the O2 recovery index.

On tensors: int8 values are taken as uint8 through ``.view(torch.uint8)``
(torch's uint8 shifts and compares on every device). The dense packing is
LSB-first over the little-endian bit stream - code ``i`` occupies bits
``[5i, 5i+5)`` - and is one tensor expression over all rows: eight codes
make one 40-bit group, five bytes. ``msr_pack_rows`` and
``msr_pack_paired_rows`` are the row-batched forms the packetizer uses.
The numpy oracles (``compress_reference``, ``decompress_reference``,
``unpack_codes_reference``, ``msr_pack_reference``,
``msr_pack_paired_reference``) are the port's own copies of the
reference's.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .bits import words32
from .flits import FlitStream, num_flits

__all__ = [
    "MSR_RUN", "CODE_BITS", "ESCAPE_BITS", "MsrCompressed",
    "compress", "decompress", "compress_reference", "decompress_reference",
    "outlier_mask", "msr_overhead_bits", "msr_stream_overhead_bits",
    "escape_bits", "compressed_bytes", "compressed_payload_flits",
    "compressed_paired_payload_flits", "msr_pack", "msr_pack_paired",
    "msr_pack_rows", "msr_pack_paired_rows",
    "msr_pack_reference", "msr_pack_paired_reference",
    "unpack_codes_reference",
]

MSR_RUN = 4                       # MSB run length that makes a value an inlier
CODE_BITS = 9 - MSR_RUN           # 1 sign bit + (8 - MSR_RUN) value bits = 5
ESCAPE_BITS = 8 - CODE_BITS       # explicit top bits per outlier record = 3
_SIGN_BIT = 1 << (CODE_BITS - 1)          # 0x10: sign bit of a 5-bit code
_CODE_MASK = (1 << CODE_BITS) - 1         # 0x1F
_TOP_ONES = (1 << ESCAPE_BITS) - 1        # 0b111
_EXT_MASK = _TOP_ONES << CODE_BITS        # 0xE0: sign-extension of the top 3
_GROUP = 8                        # codes per 40-bit group (= CODE_BITS bytes)


class MsrCompressed(NamedTuple):
    """One compressed stream, split into fixed ordering windows.

    codes:   ``(num_windows, window)`` uint8 - the 5-bit code per value.
    outlier: ``(num_windows, window)`` bool - True where the top
             ``MSR_RUN`` bits are NOT a sign run (escape record needed).
    top:     ``(num_windows, window)`` uint8 - the outlier's explicit top
             ``ESCAPE_BITS`` bits (0 at inlier slots).
    window / count / shape / dtype: window size, real value count before
             padding, and the original shape and dtype name (``"int8"`` or
             ``"uint8"``) for decompress.
    """

    codes: torch.Tensor
    outlier: torch.Tensor
    top: torch.Tensor
    window: int
    count: int
    shape: Tuple[int, ...]
    dtype: str

    def overhead_bits(self) -> int:
        """Escape-metadata bits this stream owes."""
        return msr_stream_overhead_bits(self.window, self.codes.shape[0],
                                        int(torch.as_tensor(self.outlier)
                                            .sum()))


# --- byte views ------------------------------------------------------------

def _to_bytes(values: torch.Tensor) -> torch.Tensor:
    v = values.reshape(-1)
    if v.dtype == torch.uint8:
        return v
    if v.dtype == torch.int8:
        return v.view(torch.uint8)
    raise TypeError(f"MSR codec wants int8/uint8 values, got {v.dtype}")


def _to_bytes_np(values) -> np.ndarray:
    a = np.asarray(values)
    if a.dtype == np.uint8:
        return a.reshape(-1)
    if a.dtype == np.int8:
        return a.reshape(-1).view(np.uint8)
    raise TypeError(f"MSR codec wants int8/uint8 values, got {a.dtype}")


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


# --- codec -----------------------------------------------------------------

def _windowed(u: torch.Tensor, window: int):
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    n = int(u.shape[0])
    nw = -(-n // window)
    return F.pad(u, (0, nw * window - n)).reshape(nw, window), n


def compress(values: torch.Tensor, window: int) -> MsrCompressed:
    """MSR-compress ``values`` (int8/uint8, any shape) in fixed windows.

    The last window is zero-padded (a zero byte is always an inlier).
    :func:`compress_reference` is the numpy oracle."""
    u, count = _windowed(_to_bytes(values), window)
    top = u >> CODE_BITS
    predicted = torch.where((u & _SIGN_BIT) != 0, _TOP_ONES, 0).to(torch.uint8)
    outlier = top != predicted
    codes = u & _CODE_MASK
    return MsrCompressed(codes, outlier, torch.where(outlier, top, 0)
                         .to(torch.uint8), window, count,
                         tuple(values.shape), _dtype_name(values.dtype))


def decompress(comp: MsrCompressed) -> torch.Tensor:
    """Bit-exact inverse of :func:`compress`."""
    codes, top = comp.codes, comp.top
    ext = torch.where((codes & _SIGN_BIT) != 0, _EXT_MASK, 0).to(torch.uint8)
    escaped = (top << CODE_BITS) | codes
    flat = torch.where(comp.outlier, escaped, codes | ext).reshape(-1)
    flat = flat[:comp.count]
    if comp.dtype == "int8":
        flat = flat.view(torch.int8)
    return flat.reshape(comp.shape)


def compress_reference(values, window: int) -> MsrCompressed:
    """Pure-numpy reference codec (the oracle :func:`compress` must match
    bit for bit)."""
    a = np.asarray(values)
    u = _to_bytes_np(a)
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    count = u.shape[0]
    nw = -(-count // window)
    u = np.pad(u, (0, nw * window - count)).reshape(nw, window)
    top = (u >> CODE_BITS).astype(np.uint8)
    predicted = np.where(u & _SIGN_BIT, _TOP_ONES, 0).astype(np.uint8)
    outlier = top != predicted
    codes = (u & _CODE_MASK).astype(np.uint8)
    return MsrCompressed(codes, outlier,
                         np.where(outlier, top, 0).astype(np.uint8),
                         window, count, tuple(a.shape), str(a.dtype))


def decompress_reference(comp: MsrCompressed) -> np.ndarray:
    codes = np.asarray(comp.codes, np.uint8)
    outlier = np.asarray(comp.outlier, bool)
    top = np.asarray(comp.top, np.uint8)
    ext = np.where(codes & _SIGN_BIT, _EXT_MASK, 0).astype(np.uint8)
    escaped = ((top.astype(np.uint16) << CODE_BITS) | codes).astype(np.uint8)
    flat = np.where(outlier, escaped, codes | ext).reshape(-1)[:comp.count]
    if np.dtype(comp.dtype) == np.int8:
        flat = flat.view(np.int8)
    return flat.reshape(comp.shape)


def outlier_mask(values: torch.Tensor) -> torch.Tensor:
    """Boolean mask (same shape) of values needing an escape record -
    ``(v < -16) | (v > 15)`` on the int8 view. Outlier status is per value,
    so it does not depend on windowing, ordering or packet grouping."""
    u = _to_bytes(values)
    top = u >> CODE_BITS
    predicted = torch.where((u & _SIGN_BIT) != 0, _TOP_ONES, 0).to(torch.uint8)
    return (top != predicted).reshape(values.shape)


# --- escape-metadata accounting --------------------------------------------

def _count_field_bits(window: int) -> int:
    # The per-window outlier counter addresses 0..window inclusive.
    return max(1, int(window).bit_length())


def _pos_field_bits(window: int) -> int:
    # Same contract as ordering.index_overhead_bits: one of `window` slots.
    return max(1, int(window - 1).bit_length())


def msr_stream_overhead_bits(window: int, num_windows, num_outliers) -> int:
    """Escape bits for ``num_windows`` windows of ``window`` transmitted
    slots holding ``num_outliers`` outliers in total: a count field per
    window plus a (position, top-bits) record per outlier."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return (int(num_windows) * _count_field_bits(window)
            + int(num_outliers) * (_pos_field_bits(window) + ESCAPE_BITS))


def msr_overhead_bits(window: int, num_outliers) -> int:
    """Escape bits one window of ``window`` slots owes for ``num_outliers``
    outliers."""
    return msr_stream_overhead_bits(window, 1, num_outliers)


def escape_bits(values: torch.Tensor, window: int) -> int:
    """Total escape bits for ``values`` sent in ``window``-slot windows: a
    2-D ``(num_windows, k <= window)`` operand matrix (one row per packet,
    zero-padded on the wire to ``window`` slots; padding zeros are
    inliers), or a flat stream split into ``ceil(n / window)`` windows."""
    if values.dim() == 2:
        if values.shape[1] > window:
            raise ValueError(f"operand rows of {values.shape[1]} values do "
                             f"not fit a {window}-slot window")
        nwin = int(values.shape[0])
    else:
        nwin = -(-values.numel() // window) if values.numel() else 0
    n_out = int(outlier_mask(values).sum())
    return msr_stream_overhead_bits(window, nwin, n_out)


# --- compressed flit geometry ----------------------------------------------

def compressed_bytes(n_slots: int) -> int:
    """Bytes of the dense 5-bit code stream for ``n_slots`` values."""
    return -(-CODE_BITS * int(n_slots) // 8)


def compressed_payload_flits(n_values, lanes: int):
    """Payload flits of an MSR-compressed single stream of ``n_values``
    values: values lane-padded as :func:`flits.pack` pads them, the 5-bit
    codes densely packed into bytes, the bytes lane-padded into 8-bit flit
    lanes. Scalar in, int out; array in, int64 array out."""
    n = np.asarray(n_values, np.int64)
    slots = -(-n // lanes) * lanes
    nbytes = -(-(CODE_BITS * slots) // 8)
    nf = -(-nbytes // lanes)
    return int(nf) if np.ndim(n_values) == 0 else nf


def compressed_paired_payload_flits(n_values, lanes: int):
    """Payload flits of an MSR-compressed paired stream of ``n_values``
    (input, weight) pairs - each half-flit stream compressed on its own."""
    if lanes % 2:
        raise ValueError("paired packing needs an even lane count")
    half = lanes // 2
    n = np.asarray(n_values, np.int64)
    slots = -(-n // half) * half
    nbytes = -(-(CODE_BITS * slots) // 8)
    nf = -(-nbytes // half)
    return int(nf) if np.ndim(n_values) == 0 else nf


# --- dense 5-bit packing + flit streams ------------------------------------

def _pack_code_rows(codes: torch.Tensor) -> torch.Tensor:
    """(n, s) 5-bit codes (uint8) -> (n, ceil(5 s / 8)) uint8 bytes, each row
    packed LSB-first. Eight codes are one 40-bit group: the group's int64
    ``sum(code_i << 5 i)`` split into its five low bytes; the zero codes
    that pad a row to whole groups only add zero bytes, cut off at the end."""
    n, s = codes.shape
    g = -(-s // _GROUP)
    c = F.pad(codes, (0, g * _GROUP - s)).to(torch.int64)
    shifts = torch.arange(0, CODE_BITS * _GROUP, CODE_BITS,
                          dtype=torch.int64, device=codes.device)
    v = (c.reshape(n, g, _GROUP) << shifts).sum(dim=2, keepdim=True)
    byte_shifts = torch.arange(0, 8 * CODE_BITS, 8, dtype=torch.int64,
                               device=codes.device)
    data = ((v >> byte_shifts) & 0xFF).to(torch.uint8).reshape(n, -1)
    return data[:, :compressed_bytes(s)]


def _code_rows(values: torch.Tensor, slots: int) -> torch.Tensor:
    """(n, k) int8/uint8 values -> (n, slots) codes, zero-padded."""
    if values.dtype == torch.int8:
        values = values.view(torch.uint8)
    elif values.dtype != torch.uint8:
        raise TypeError(f"MSR codec wants int8/uint8 values, got "
                        f"{values.dtype}")
    return F.pad(values, (0, slots - values.shape[1])) & _CODE_MASK


def _lane_rows(data: torch.Tensor, lanes: int) -> torch.Tensor:
    """(n, nbytes) -> (n, nf, lanes), bytes zero-padded to whole flits."""
    n, nb = data.shape
    nf = -(-nb // lanes)
    return F.pad(data, (0, nf * lanes - nb)).reshape(n, nf, lanes)


def msr_pack_rows(values: torch.Tensor, lanes: int) -> torch.Tensor:
    """Row-batched :func:`msr_pack`: (n, k) ordered values -> (n, F, L)
    int32 words; row ``i`` is ``msr_pack(values[i], lanes).words``."""
    slots = num_flits(int(values.shape[1]), lanes) * lanes
    data = _pack_code_rows(_code_rows(values, slots))
    return words32(_lane_rows(data, lanes))


def msr_pack_paired_rows(inputs: torch.Tensor, weights: torch.Tensor,
                         lanes: int) -> torch.Tensor:
    """Row-batched :func:`msr_pack_paired`: (n, k) ordered operands ->
    (n, F, L) int32 words, inputs' codes left, weights' right."""
    if lanes % 2:
        raise ValueError("paired packing needs an even lane count")
    if inputs.shape != weights.shape:
        raise ValueError("inputs and weights must have the same element count")
    half = lanes // 2
    slots = num_flits(int(inputs.shape[1]), half) * half
    di = _lane_rows(_pack_code_rows(_code_rows(inputs, slots)), half)
    dw = _lane_rows(_pack_code_rows(_code_rows(weights, slots)), half)
    return words32(torch.cat([di, dw], dim=2))


def msr_pack(values: torch.Tensor, lanes: int) -> FlitStream:
    """Compress a flat value stream and pack the 5-bit codes into flits:
    values zero-padded to a lane multiple (a zero's code is zero), dense
    code bytes zero-padded to a lane multiple, one byte per 8-bit lane.
    Escape metadata never rides the payload (:func:`msr_stream_overhead_bits`
    charges it), so the geometry is a function of the value count alone."""
    u = _to_bytes(values)
    words = msr_pack_rows(u[None], lanes)[0].to(torch.uint8)
    return FlitStream(words, lanes, 8)


def msr_pack_paired(inputs: torch.Tensor, weights: torch.Tensor,
                    lanes: int) -> FlitStream:
    """Paired-stream :func:`msr_pack`: inputs compressed into the left
    half-flit, weights into the right, each half's code stream packed on
    its own (Fig. 2's layout)."""
    ui, uw = _to_bytes(inputs), _to_bytes(weights)
    if ui.shape != uw.shape:
        raise ValueError("inputs and weights must have the same element count")
    words = msr_pack_paired_rows(ui[None], uw[None], lanes)[0]
    return FlitStream(words.to(torch.uint8), lanes, 8)


def _pack_codes_reference(codes: np.ndarray) -> np.ndarray:
    codes = np.asarray(codes, np.uint8).reshape(-1)
    bits = np.unpackbits(codes[:, None], axis=1,
                         bitorder="little")[:, :CODE_BITS]
    return np.packbits(bits.reshape(-1), bitorder="little")


def unpack_codes_reference(data, n: int) -> np.ndarray:
    """Recover ``n`` 5-bit codes from a dense byte stream (numpy)."""
    bits = np.unpackbits(np.asarray(data, np.uint8),
                         bitorder="little")[:CODE_BITS * n]
    if n == 0:
        return np.zeros(0, np.uint8)
    return np.packbits(bits.reshape(n, CODE_BITS), axis=1,
                       bitorder="little")[:, 0]


def msr_pack_reference(values, lanes: int) -> np.ndarray:
    """Numpy reference of :func:`msr_pack` - returns the words array."""
    u = _to_bytes_np(values)
    n = u.shape[0]
    slots = num_flits(n, lanes) * lanes
    u = np.pad(u, (0, slots - n))
    data = _pack_codes_reference(u & _CODE_MASK)
    nf = -(-data.shape[0] // lanes)
    data = np.pad(data, (0, nf * lanes - data.shape[0]))
    return data.reshape(nf, lanes)


def msr_pack_paired_reference(inputs, weights, lanes: int) -> np.ndarray:
    """Numpy reference of :func:`msr_pack_paired` - returns the words."""
    if lanes % 2:
        raise ValueError("paired packing needs an even lane count")
    half = lanes // 2
    ui, uw = _to_bytes_np(inputs), _to_bytes_np(weights)
    if ui.shape != uw.shape:
        raise ValueError("inputs and weights must have the same element count")
    n = ui.shape[0]
    pad = num_flits(n, half) * half - n
    di = _pack_codes_reference(np.pad(ui, (0, pad)) & _CODE_MASK)
    dw = _pack_codes_reference(np.pad(uw, (0, pad)) & _CODE_MASK)
    nf = -(-di.shape[0] // half)
    di = np.pad(di, (0, nf * half - di.shape[0])).reshape(nf, half)
    dw = np.pad(dw, (0, nf * half - dw.shape[0])).reshape(nf, half)
    return np.concatenate([di, dw], axis=1)
