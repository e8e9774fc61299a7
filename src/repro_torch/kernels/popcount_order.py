"""Hopper popcount window-order kernel (``csrc/popcount_order.cu``): each
window's '1'-bit counts decide its order in one launch.

Replaces ``repro/kernels/popcount.py`` ``popcount_words_pallas`` where the
port orders by it. The TPU kernel wrote the counts and XLA fused the keys
and the argsort around them; in eager PyTorch that was a popcount launch
and ~10-15 torch launches a call, a segmented stable sort among them. Here
a count stays in a register until the order it decides is written: one
stable counting sort of each window by a small key, in shared memory
(per-warp histograms, one exclusive scan, ``__match_any_sync`` ranks over
position-ordered tiles). Two entry points:

* :func:`descending_perm` - the O1/O2 permutation of (R, W) rows by count,
  descending (``stable``: one pass; ``pattern``: 8-bit LSD passes on
  ``~u`` within ``nbits``, then the count pass), with the window offsets
  added: ``ordering.descending_perm`` in one launch;
* :func:`chain_inputs` - the O3/O3a chain preamble of (P, R, W) planes
  (partition, partitioned planes, live counts, the identity's cost and the
  start positions) in one launch.

Both equal their plain versions (``ref.descending_perm_rows_ref``,
``ref.chain_inputs_ref``) exactly. The wrapper checks, allocates each
output once and launches once; :func:`layout` says how a window is laid
out on the card.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from ._build import I32, I64, P, SMEM_BYTES, CudaKernel, check_arg, stream

__all__ = ["DESCENDING_PERM", "CHAIN_INPUTS", "KERNELS", "Layout", "layout",
           "descending_perm", "chain_inputs"]

_REPLACES = "src/repro/kernels/popcount.py:34 popcount_words_pallas"
DESCENDING_PERM = CudaKernel(
    "descending_perm", "popcount_order.cu", "descending_perm_rows",
    [P, P, P, I32, I32, I32, I32, I32, I32, I64, P], replaces=_REPLACES)
CHAIN_INPUTS = CudaKernel(
    "chain_inputs", "popcount_order.cu", "chain_inputs",
    [P, P, P, P, P, P, I32, I32, I32, I32, I32, I64, P], replaces=_REPLACES)
KERNELS = (DESCENDING_PERM, CHAIN_INPUTS)

# csrc/popcount_order.cu kBlockThreads: a block holds 256 / (32 G) rows
# when a row takes G <= 8 warps.
_BLOCK_THREADS = 256


class Layout(NamedTuple):
    warps: int        # G: warps a row (about 8 values a lane)
    rows: int         # rows a block
    in_smem: bool     # the row's buffers in shared memory (else scratch)
    smem_bytes: int   # dynamic shared memory a block


@lru_cache(maxsize=256)
def layout(kind: str, w: int, planes: int = 1) -> Layout:
    """How a window of ``w`` values is laid out: ``kind`` is ``"stable"``
    or ``"pattern"`` (:func:`descending_perm`) or ``"chain"``
    (:func:`chain_inputs` over ``planes`` planes). Per row: the (key,
    warp) histogram and G scan words, then the words and the permutation
    buffers (stable 2 arrays of W, pattern 3, chain P + 1). A
    ``descending_perm`` row whose buffers do not fit keeps them in device
    scratch; a chain row that does not fit raises, naming the width."""
    g = min(32, max(1, -(-w // 256)))
    rows = _BLOCK_THREADS // (32 * g) if g <= 8 else 1
    buckets = {"stable": 33, "pattern": 256, "chain": 32 * planes + 1}[kind]
    arrays = {"stable": 2, "pattern": 3, "chain": planes + 1}[kind]
    hist = buckets * g + g
    smem = rows * (hist + arrays * w) * 4
    if smem <= SMEM_BYTES:
        return Layout(g, rows, True, smem)
    if kind == "chain":
        raise ValueError(
            f"chain_inputs: a row of width {w} on {planes} planes needs "
            f"{smem} bytes of shared memory; a block has {SMEM_BYTES}")
    return Layout(g, rows, False, rows * hist * 4)


def descending_perm(rows: torch.Tensor, tiebreak: str,
                    nbits: int) -> torch.Tensor:
    """Flat int64 permutation ordering each (R, W) row of int32 carriers
    of zero-extended ``nbits``-wide words by count, descending (``stable``
    or ``pattern`` ties), window offsets added, on the card."""
    if rows.dim() != 2:
        raise ValueError(f"descending_perm: rows must be (R, W), got "
                         f"{tuple(rows.shape)}")
    r, w = rows.shape
    check_arg("descending_perm", "rows", rows, (r, w))
    if nbits not in (8, 16, 32):
        raise ValueError(f"descending_perm: nbits must be 8, 16 or 32, got "
                         f"{nbits}")
    if tiebreak not in ("stable", "pattern"):
        raise ValueError(f"unknown tiebreak {tiebreak!r}")
    perm = torch.empty((r * w,), dtype=torch.int64, device=rows.device)
    if r and w:
        lay = layout(tiebreak, w)
        scratch = None
        if not lay.in_smem:
            bufs = 2 if tiebreak == "pattern" else 1
            scratch = torch.empty((r * bufs * w,), dtype=torch.int32,
                                  device=rows.device)
        DESCENDING_PERM.launch(
            rows.data_ptr(), perm.data_ptr(),
            None if scratch is None else scratch.data_ptr(), r, w, nbits,
            int(tiebreak == "pattern"), lay.warps, int(lay.in_smem),
            lay.smem_bytes, stream())
    return perm


def chain_inputs(u: torch.Tensor, starts: int):
    """The O3 chain preamble of (P, R, W) int32 planes (P = 1 or 2) on the
    card -> ``(part (R, W) int64, q (P, R, W) int32, z (R,) int32, cid
    (R,) int32, start_pos (R, S) int64)``."""
    if u.dim() != 3 or u.shape[0] not in (1, 2):
        raise ValueError(f"chain_inputs: u must be (P, R, W) with P in "
                         f"(1, 2), got {tuple(u.shape)}")
    p, r, w = u.shape
    check_arg("chain_inputs", "u", u, (p, r, w))
    if w < 1 or starts < 1:
        raise ValueError(f"chain_inputs: needs W >= 1 and starts >= 1, got "
                         f"W = {w}, starts = {starts}")
    lay = layout("chain", w, p)
    dev = u.device
    part = torch.empty((r, w), dtype=torch.int64, device=dev)
    q = torch.empty((p, r, w), dtype=torch.int32, device=dev)
    z = torch.empty((r,), dtype=torch.int32, device=dev)
    cid = torch.empty((r,), dtype=torch.int32, device=dev)
    start = torch.empty((r, starts), dtype=torch.int64, device=dev)
    if r:
        CHAIN_INPUTS.launch(u.data_ptr(), part.data_ptr(), q.data_ptr(),
                            z.data_ptr(), cid.data_ptr(), start.data_ptr(),
                            p, r, w, int(starts), lay.warps, lay.smem_bytes,
                            stream())
    return part, q, z, cid, start
