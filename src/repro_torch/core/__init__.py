"""Bit-transition math and the O0-O3 transmission orderings, on tensors.

    bits      - popcount / unsigned views / per-element transitions
    flits     - packing value streams into link flits
    bt        - measured + expected bit-transition metrics (Eqs. 1-3)
    ordering  - descending / affiliated (O1) / separated (O2) orderings and
                the min-Hamming chains (O3, O3a)
    wire      - the WireTransform API used by the NoC packetizer
    msr       - MSR 8b->5b flit compression codec (the compression knob)
"""
from . import bits, bt, flits, msr, ordering, wire
from .bits import popcount, transitions
from .bt import (bt_between, bt_per_flit, bt_per_position, bt_stream,
                 expected_bt_pair, expected_bt_stream,
                 ones_prob_per_position, pairing_objective, reduction_rate)
from .flits import FlitStream, pack, pack_paired, unpack
from .ordering import (Ordered, PairedOrdered, affiliated_min_hamming_order,
                       affiliated_order, apply_permutation, descending_order,
                       descending_perm, index_overhead_bits,
                       inverse_permutation, min_hamming_order,
                       separated_min_hamming_order, separated_order)
from .wire import WireTransform, by_name as wire_transform, measure as measure_stream
from .msr import (MsrCompressed, compress as msr_compress,
                  decompress as msr_decompress, msr_overhead_bits, msr_pack,
                  msr_pack_paired)

__all__ = [
    "bits", "flits", "bt", "msr", "ordering", "wire",
    "MsrCompressed", "msr_compress", "msr_decompress",
    "msr_overhead_bits", "msr_pack", "msr_pack_paired",
    "popcount", "transitions",
    "FlitStream", "pack", "pack_paired", "unpack",
    "bt_stream", "bt_per_flit", "bt_between", "expected_bt_pair",
    "expected_bt_stream", "pairing_objective", "reduction_rate",
    "bt_per_position", "ones_prob_per_position",
    "descending_order", "affiliated_order", "separated_order",
    "min_hamming_order", "affiliated_min_hamming_order",
    "separated_min_hamming_order",
    "descending_perm", "inverse_permutation", "apply_permutation",
    "index_overhead_bits", "Ordered", "PairedOrdered",
    "WireTransform", "wire_transform", "measure_stream",
]
