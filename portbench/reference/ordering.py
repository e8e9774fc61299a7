"""Plain reference of the value path: bit views, fixed-point quantization,
the O0-O3a orderings (popcount sort, the min-Hamming chain) and MSR codes.

Plain PyTorch, on whatever device its inputs live, with no kernel of the
program: each function states the semantics the sweep's rows rest on, in
the form that the program's plain path was held to against the paper's
original implementation. Nothing here imports the program.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

# --- bit views ---------------------------------------------------------------

_CARRIER = {torch.float32: torch.int32, torch.int32: torch.int32,
            torch.int8: torch.uint8, torch.uint8: torch.uint8}


def unsigned_view(values: torch.Tensor) -> torch.Tensor:
    """The same-width word carrier of ``values`` (a bitcast)."""
    target = _CARRIER[values.dtype]
    return values if values.dtype == target else values.view(target)


def bit_width(dtype: torch.dtype) -> int:
    return dtype.itemsize * 8


def words32(values: torch.Tensor) -> torch.Tensor:
    """Bit patterns zero-extended into int32-carried uint32 words."""
    u = unsigned_view(values)
    nbits = bit_width(u.dtype)
    if nbits == 32:
        return u
    return u.to(torch.int32) & ((1 << nbits) - 1)


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    return (x >> k) & ((1 << (32 - k)) - 1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """'1' bits of int32-carried uint32 words -> int32 in [0, 32]."""
    x = x.to(torch.int32)
    x = x - (_srl(x, 1) & 0x55555555)
    x = (x & 0x33333333) + (_srl(x, 2) & 0x33333333)
    x = (x + _srl(x, 4)) & 0x0F0F0F0F
    x = x + _srl(x, 8)
    x = x + _srl(x, 16)
    return x & 0x3F


# --- fixed point -------------------------------------------------------------

def quantize_fixed8(x: torch.Tensor) -> torch.Tensor:
    """Q(7-f).f int8 with f chosen per tensor from its largest magnitude."""
    amax = x.abs().max() if x.numel() else torch.zeros((), dtype=x.dtype,
                                                        device=x.device)
    amax = torch.clamp(amax.to(torch.float32), min=1e-12)
    int_bits = torch.ceil(torch.log2(amax)).to(torch.int32)
    frac_bits = torch.clamp(7 - int_bits, 0, 7)
    scale = torch.exp2(frac_bits.to(torch.float32))
    q = torch.clamp(torch.round(x.to(torch.float32) * scale), -128, 127)
    return q.to(torch.int8)


QUANTIZERS = {"float32": None, "fixed8": quantize_fixed8}

# --- O1 / O2: popcount order inside each window ------------------------------


def descending_perm_rows(rows: torch.Tensor, tiebreak: str,
                         nbits: int) -> torch.Tensor:
    """Per row of (R, W) zero-extended ``nbits``-wide words: the stable
    order by '1'-bit count, descending; ``pattern`` breaks count ties by
    the pattern read as unsigned, descending. Flat int64, row offsets
    added."""
    counts = popcount32(rows).to(torch.int64)
    if tiebreak == "stable":
        key = -counts
    elif tiebreak == "pattern":
        inv = ((1 << nbits) - 1) - (rows.to(torch.int64) & ((1 << nbits) - 1))
        key = ((nbits - counts) << nbits) | inv
    else:
        raise ValueError(f"unknown tiebreak {tiebreak!r}")
    perm = torch.argsort(key, dim=-1, stable=True)
    nw, w = rows.shape
    return (perm + (torch.arange(nw, device=perm.device) * w)[:, None]
            ).reshape(-1)


def _popcount_perm(rows: torch.Tensor, tiebreak: str) -> torch.Tensor:
    """(n, w) values -> flat permutation of their popcount order."""
    nbits = bit_width(unsigned_view(rows).dtype)
    return descending_perm_rows(words32(rows), tiebreak, nbits)


# --- O3 / O3a: the greedy min-Hamming chain ----------------------------------

BEAM = 2
STARTS = 8
_VISITED = 1 << 30
_ZONE = 1 << 28
_INF = 1 << 20


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = popcount32(a ^ b)
    return d[0] if d.shape[0] == 1 else d.sum(0, dtype=torch.int32)


def _chain_inputs(u: torch.Tensor, starts: int):
    """(P, R, W) words -> zeros-to-tail partition, partitioned planes, live
    counts, the partitioned identity's cost and the (R, S) starts (ranks
    0, z/S, 2z/S, ... of the descending popcount order)."""
    p, r, w = u.shape
    pc = popcount32(u)
    pops = pc[0] if p == 1 else pc.sum(0, dtype=torch.int32)
    nz = pops > 0
    z = nz.sum(1, dtype=torch.int32)
    part = torch.argsort((~nz).to(torch.int8), dim=1, stable=True)
    q = torch.gather(u, 2, part[None].expand(p, r, w))
    cid = (_dist(q[..., :-1], q[..., 1:]).sum(1, dtype=torch.int32) if w > 1
           else torch.zeros((r,), dtype=torch.int32, device=u.device))
    dperm = torch.argsort(-torch.gather(pops, 1, part), dim=1, stable=True)
    ranks = (torch.arange(starts, dtype=torch.int64, device=u.device)[None, :]
             * z[:, None].to(torch.int64)) // starts
    return part, q, z, cid, torch.gather(dperm, 1, ranks)


def _chain_greedy(q: torch.Tensor, z: torch.Tensor, start: torch.Tensor,
                  beam: int):
    """Greedy chains with a ``beam``-candidate one-step lookahead from
    every start: at each step the ``beam`` nearest unvisited live lanes
    (distance, then index) are scored by distance + the candidate's own
    nearest next distance, the winner taken. -> (orders (R, S, W), costs
    (R, S)) int32."""
    p, r, w = q.shape
    s = start.shape[1]
    dev = q.device
    idx = torch.arange(w, dtype=torch.int32, device=dev)
    zone = torch.where(idx[None, :] >= z[:, None], _ZONE, 0).to(torch.int32)
    k1, k2 = 130 * w, w
    start = start.to(torch.int64)
    visited_pen = torch.full((r, s, 1), _VISITED, dtype=torch.int32,
                             device=dev)
    pen = zone[:, None, :].expand(r, s, w).clone()
    pen.scatter_add_(2, start[..., None], visited_pen)
    order = torch.zeros((r, s, w), dtype=torch.int32, device=dev)
    order[..., 0] = start.to(torch.int32)
    cost = torch.zeros((r, s), dtype=torch.int32, device=dev)
    q4 = q[:, :, None, :].expand(p, r, s, w)
    cur = start
    for i in range(1, w):
        qcur = torch.gather(q4, 3, cur[None, ..., None].expand(p, r, s, 1))
        dvec = _dist(q4 ^ qcur, torch.zeros((), dtype=torch.int32,
                                              device=dev))
        # The keys embed the lane index, so they are distinct and the
        # ``beam`` smallest are the head of their stable sort.
        cand = torch.topk(dvec * k2 + idx + pen, beam, dim=2, largest=False,
                          sorted=True).indices
        d_b = torch.gather(dvec, 2, cand)
        qc = torch.gather(q4, 3, cand[None].expand(p, r, s, beam))
        d2 = _dist(qc[..., None], q[:, :, None, None, :])
        lamask = ((pen >= _ZONE)[:, :, None, :]
                  | (idx.to(torch.int64) == cand[..., None]))
        la = torch.where(lamask, _INF, d2).amin(dim=3)
        la = torch.where(la >= _INF, 0, la)
        score = ((d_b + la) * k1 + d_b * k2 + cand.to(torch.int32)
                 + torch.gather(pen, 2, cand))
        nxt = torch.gather(cand, 2, score.argmin(dim=2, keepdim=True))
        pen.scatter_add_(2, nxt, visited_pen)
        cost = cost + torch.gather(dvec, 2, nxt)[..., 0]
        order[..., i] = nxt[..., 0].to(torch.int32)
        cur = nxt[..., 0]
    return order, cost


def min_hamming_chain(planes: Sequence[torch.Tensor], beam: int = BEAM,
                      starts: int = STARTS):
    """Chain each row of one or more (R, W) value planes (summed distance):
    -> (window-local perm (R, W) int64, live counts (R,)). The best start's
    chain, or the zeros-to-tail identity where that is no dearer."""
    u = torch.stack([words32(p) for p in planes])
    _, r, w = u.shape
    if w == 0 or r == 0:
        return (torch.zeros((r, w), dtype=torch.int64, device=u.device),
                torch.zeros((r,), dtype=torch.int32, device=u.device))
    beam = min(beam, w)
    part, q, z, cid, start_pos = _chain_inputs(u, starts)
    orders, costs = _chain_greedy(q, z, start_pos, beam)
    sbest = (costs.to(torch.int64) * starts
             + torch.arange(starts, device=u.device)).argmin(dim=1,
                                                             keepdim=True)
    best = torch.gather(costs, 1, sbest)[:, 0]
    idx = torch.arange(w, dtype=torch.int32, device=u.device)
    chain = torch.where((best < cid)[:, None],
                        torch.gather(orders, 1, sbest[..., None].expand(
                            r, 1, w))[:, 0], idx[None, :])
    return torch.gather(part, 1, chain.to(torch.int64)), z


def _deal_chain(perm: torch.Tensor, z: torch.Tensor,
                lanes: int) -> torch.Tensor:
    """Chained value ``i`` to flit ``i % F`` lane ``i // F`` (F =
    max(ceil(z / lanes), 1)); padding zeros fill the free slots in
    ascending order."""
    nw, wp = perm.shape
    idx = torch.arange(wp, device=perm.device)[None, :]
    z = z.to(torch.int64)[:, None]
    fr = torch.clamp(-(-z // lanes), min=1)
    nzslot = (idx % fr) * lanes + idx // fr
    chained = idx < z
    used = torch.zeros((nw, wp + 1), dtype=torch.int8, device=perm.device)
    used.scatter_(1, torch.where(chained, nzslot, wp), 1)
    free = torch.argsort(used[:, :wp], dim=1, stable=True)
    slot = torch.where(chained, nzslot,
                       torch.gather(free, 1, torch.clamp(idx - z, min=0)))
    return torch.zeros_like(perm).scatter_(1, slot, perm)


def _chain_rows(planes: Sequence[torch.Tensor], lanes: int):
    """(n, k) planes -> (rows padded to a ``lanes`` multiple, the dealt
    chain perm (n, Wp))."""
    n, k = planes[0].shape
    wp = -(-k // lanes) * lanes
    padded = [F.pad(p, (0, wp - k)) for p in planes]
    perm, z = min_hamming_chain(padded)
    return padded, _deal_chain(perm, z, lanes)


def _take(rows: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    return torch.gather(rows, 1, perm)


# --- the transforms, one row per packet --------------------------------------

def order_packets(name: str, tiebreak: str, inputs: torch.Tensor,
                  weights: torch.Tensor, lanes: int):
    """The request phase's ordering of (n, k) operand rows, one window a
    packet -> (n, k') each (O3/O3a pad k to a multiple of ``lanes // 2``).
    O1 sorts the pairs by the weight's popcount, O2 each stream by its own;
    O3 chains each stream alone, O3a the pairs on their summed distance."""
    n, k = inputs.shape
    if name == "O0" or n == 0:
        return inputs, weights
    if name in ("O1", "O2"):
        wperm = _popcount_perm(weights, tiebreak)
        iperm = wperm if name == "O1" else _popcount_perm(inputs, tiebreak)
        return (inputs.reshape(-1)[iperm].reshape(n, k),
                weights.reshape(-1)[wperm].reshape(n, k))
    half = lanes // 2
    if name == "O3":
        (pi,), ci = _chain_rows([inputs], half)
        (pw,), cw = _chain_rows([weights], half)
        return _take(pi, ci), _take(pw, cw)
    if name == "O3a":
        (pi, pw), c = _chain_rows([inputs, weights], half)
        return _take(pi, c), _take(pw, c)
    raise ValueError(f"unknown transform {name!r}")


def order_single_packets(name: str, tiebreak: str, values: torch.Tensor,
                         lanes: int) -> torch.Tensor:
    """The result phase's ordering of (n, w) single-stream windows: O1 and
    O2 by popcount, O3 and O3a by the chain over ``lanes`` lanes."""
    n, k = values.shape
    if name == "O0" or n == 0:
        return values
    if name in ("O1", "O2"):
        return values.reshape(-1)[_popcount_perm(values, tiebreak)
                                  ].reshape(n, k)
    (pv,), c = _chain_rows([values], lanes)
    return _take(pv, c)


def index_overhead_bits(window: int) -> int:
    """Recovery-index bits per value for one of ``window`` slots."""
    return max(1, (window - 1).bit_length())


def overhead_bits_per_value(name: str, window: int,
                            paired: bool = True) -> int:
    """Recovery bits a receiver needs per value: O2 and O3 always (the two
    streams re-pair), O1 and O3a only for a single stream."""
    if name == "O0":
        return 0
    if name in ("O1", "O3a") and paired:
        return 0
    return index_overhead_bits(window)


# --- MSR 8b -> 5b codes ------------------------------------------------------

CODE_BITS = 5
ESCAPE_BITS = 3
_GROUP = 8


def outlier_mask(values: torch.Tensor) -> torch.Tensor:
    """Values whose top four bits are not a run of the sign: -16 > v > 15."""
    v = values.to(torch.int16)
    return (v < -16) | (v > 15)


def msr_stream_overhead_bits(window: int, num_windows: int,
                             num_outliers: int) -> int:
    """A count field per window, a (position, top bits) record per
    outlier."""
    return (int(num_windows) * max(1, int(window).bit_length())
            + int(num_outliers) * (max(1, int(window - 1).bit_length())
                                   + ESCAPE_BITS))


def escape_bits(values: torch.Tensor, window: int) -> int:
    """Escape bits of (n, k <= window) rows sent one window a row."""
    return msr_stream_overhead_bits(window, values.shape[0],
                                    int(outlier_mask(values).sum()))


def compressed_payload_flits(n_values, lanes: int):
    """Flits of a single stream of ``n_values`` codes: the values
    lane-padded, the 5-bit codes packed into bytes, the bytes into flits."""
    n = np.asarray(n_values, np.int64)
    slots = -(-n // lanes) * lanes
    nbytes = -(-(CODE_BITS * slots) // 8)
    nf = -(-nbytes // lanes)
    return int(nf) if np.ndim(n_values) == 0 else nf


def _code_bytes(values: torch.Tensor, slots: int) -> torch.Tensor:
    """(n, k) int8 -> (n, ceil(5 slots / 8)) bytes: each value's low five
    bits, zero-padded to ``slots``, packed LSB-first."""
    n = values.shape[0]
    codes = F.pad(values.view(torch.uint8), (0, slots - values.shape[1])) & 0x1F
    g = -(-slots // _GROUP)
    c = F.pad(codes, (0, g * _GROUP - slots)).to(torch.int64)
    v = (c.reshape(n, g, _GROUP) << torch.arange(
        0, CODE_BITS * _GROUP, CODE_BITS, device=values.device)).sum(
            dim=2, keepdim=True)
    data = ((v >> torch.arange(0, 8 * CODE_BITS, 8, device=values.device))
            & 0xFF).to(torch.uint8).reshape(n, -1)
    return data[:, :-(-(CODE_BITS * slots) // 8)]


def _lane_rows(data: torch.Tensor, lanes: int) -> torch.Tensor:
    n, nb = data.shape
    nf = -(-nb // lanes)
    return F.pad(data, (0, nf * lanes - nb)).reshape(n, nf, lanes)


def msr_pack_rows(values: torch.Tensor, lanes: int) -> torch.Tensor:
    """(n, k) ordered int8 values -> (n, F, L) int32 words of MSR codes."""
    slots = -(-values.shape[1] // lanes) * lanes
    return words32(_lane_rows(_code_bytes(values, slots), lanes))


def msr_pack_paired_rows(inputs: torch.Tensor, weights: torch.Tensor,
                         lanes: int) -> torch.Tensor:
    """Paired MSR flits: the inputs' codes in the left half-flit, the
    weights' in the right."""
    half = lanes // 2
    slots = -(-inputs.shape[1] // half) * half
    return words32(torch.cat([_lane_rows(_code_bytes(inputs, slots), half),
                              _lane_rows(_code_bytes(weights, slots), half)],
                             dim=2))


def pack_paired_rows(oi: torch.Tensor, ow: torch.Tensor,
                     lanes: int) -> torch.Tensor:
    """(n, k) ordered operands -> (n, F, L) int32 words, inputs in the left
    half-flit, weights in the right, zero-padded per packet."""
    half = lanes // 2
    n, k = oi.shape
    nf = -(-k // half)
    ui = F.pad(words32(oi), (0, nf * half - k)).reshape(n, nf, half)
    uw = F.pad(words32(ow), (0, nf * half - k)).reshape(n, nf, half)
    return torch.cat([ui, uw], dim=2)


def result_words(name: str, tiebreak: str, windows: torch.Tensor,
                 lanes: int, compression: str) -> torch.Tensor:
    """(n, w) result windows -> (n, F, L) int32 words."""
    vals = order_single_packets(name, tiebreak, windows, lanes)
    if compression == "msr":
        return msr_pack_rows(vals, lanes)
    n, k = vals.shape
    nf = -(-k // lanes)
    return F.pad(words32(vals), (0, nf * lanes - k)).reshape(n, nf, lanes)


def subsample(inputs: torch.Tensor, weights: torch.Tensor,
              max_packets: Optional[int]):
    """Deterministic-stride neuron subsampling to ``max_packets``."""
    n = int(inputs.shape[0])
    if max_packets is not None and n > max_packets:
        stride = n // max_packets
        idx = torch.arange(0, stride * max_packets, stride,
                           device=inputs.device)
        return inputs[idx], weights[idx]
    return inputs, weights
