"""Batched minimum-Hamming-distance chaining - the O3 ordering kernel.

The port of ``repro.kernels.min_hamming``. Within each window the chain is
greedy nearest-neighbour in Hamming space with two refinements:

* **multi-start**: chains start from ``starts`` positions spread evenly
  over the descending-popcount ranks (every position when a window has at
  most ``starts`` non-zero values), and the cheapest chain is kept;
* **beam lookahead**: each step scores the ``beam`` nearest candidates by
  ``d(cur, c) + min_r d(c, r)`` and breaks ties toward the smaller hop,
  then the smaller index.

The chain never costs more than the zeros-to-tail identity order, which is
always a candidate and wins ties, and exact-zero values stay at the window
tail in their original order.

Layout: the reference's two ``vmap``s (windows, starts) are one explicit
``(R, S)`` batch, and its ``lax.scan`` - all ``w - 1`` steps of every chain
- is one :func:`repro_torch.kernels.ops.chain_greedy` call: one launch of
the Hopper chain kernel on CUDA, the plain step loop
(``ref.chain_greedy_ref``) on the CPU. The partition, the identity cost
and the start ranks before it are one ``ops.chain_inputs`` call (one
launch of the popcount window-order kernel on CUDA,
``ref.chain_inputs_ref`` on the CPU); the best-start choice after it is a
handful of torch calls. Every key is int32, with the reference's
penalties, which bound the window to ``_MAX_WINDOW``.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import numpy as np
import torch

from ..core.bits import popcount, words32
from . import ops

__all__ = ["ChainResult", "min_hamming_chain", "min_hamming_chain_reference",
           "chain_cost", "DEFAULT_BEAM", "DEFAULT_STARTS"]

DEFAULT_BEAM = 2
DEFAULT_STARTS = 8

# Penalty encoding (int32): a visited candidate loses to any zero-region
# one, and a zero-region candidate to any live one. Legitimate scores stay
# below (2*64) * K1 + 64 * K2 + W with K1 = 130*W, K2 = W (~16705*W), so
# windows up to _MAX_WINDOW values fit under _ZONE.
_VISITED = 1 << 30
_ZONE = 1 << 28
_INF = 1 << 20
_MAX_WINDOW = 16000

Streams = Union[torch.Tensor, Sequence[torch.Tensor]]


class ChainResult(NamedTuple):
    perm: torch.Tensor      # (R, W) int32 - chained order, window-local
    cost: torch.Tensor      # (R,) int32 - sum of consecutive distances
    nonzeros: torch.Tensor  # (R,) int32 - chained (non-padding) values


def _as_planes(streams: Streams) -> torch.Tensor:
    """One or more (R, W) streams -> (P, R, W) int32 word planes."""
    if isinstance(streams, torch.Tensor):
        streams = (streams,)
    planes = [words32(s) for s in streams]
    if not planes:
        raise ValueError("need at least one value stream")
    if len({tuple(p.shape) for p in planes}) != 1:
        raise ValueError("all streams must share a (R, W) shape")
    if planes[0].dim() != 2:
        raise ValueError(f"streams must be (R, W), got "
                         f"{tuple(planes[0].shape)}")
    return torch.stack(planes)


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Summed XOR-popcount distance over the leading plane axis (int32)."""
    d = popcount(a ^ b)
    return d[0] if d.shape[0] == 1 else d.sum(0, dtype=torch.int32)


def _chain_windows(u: torch.Tensor, beam: int, starts: int):
    """Chain every window of a (P, R, W) stack: partition zeros to the
    tail, run ``starts`` greedy chains, fall back to the partitioned
    identity when it is no dearer."""
    r, w = u.shape[1:]
    dev = u.device
    idx = torch.arange(w, dtype=torch.int32, device=dev)
    part, q, z, cid, start_pos = ops.chain_inputs(u, starts)
    orders, costs = ops.chain_greedy(q, z, start_pos, beam)
    # First minimum over the starts, written out: (cost, start) is unique.
    sbest = (costs.to(torch.int64) * starts
             + torch.arange(starts, device=dev)).argmin(dim=1, keepdim=True)
    best = torch.gather(costs, 1, sbest)[:, 0]
    use_greedy = best < cid
    chain = torch.where(use_greedy[:, None],
                        torch.gather(orders, 1, sbest[..., None].expand(
                            r, 1, w))[:, 0], idx[None, :])
    cost = torch.minimum(best, cid)
    perm = torch.gather(part, 1, chain.to(torch.int64)).to(torch.int32)
    return perm, cost, z


def min_hamming_chain(streams: Streams, *, beam: int = DEFAULT_BEAM,
                      starts: int = DEFAULT_STARTS) -> ChainResult:
    """Chain each window (row) of one or more (R, W) value streams.

    streams: a single (R, W) tensor, or a sequence of them sharing a shape
        (the affiliated variant chains (input, weight) pairs on the summed
        distance of both planes). Any dtype with a bit-pattern view.
    beam: lookahead beam width (>= 1); ``min(beam, W)`` is used.
    starts: number of greedy start positions (>= 1).

    Returns window-local permutations: ``values[r, perm[r]]`` is the chained
    sequence, padding zeros at the tail, cost never above the zeros-to-tail
    identity order.
    """
    u = _as_planes(streams)
    r, w = u.shape[1:]
    if beam < 1:
        raise ValueError(f"beam must be >= 1, got {beam}")
    if starts < 1:
        raise ValueError(f"starts must be >= 1, got {starts}")
    if w > _MAX_WINDOW:
        raise ValueError(
            f"window {w} exceeds the int32 score encoding bound "
            f"({_MAX_WINDOW}); chain smaller windows")
    if w == 0 or r == 0:
        zeros = torch.zeros((r,), dtype=torch.int32, device=u.device)
        return ChainResult(torch.zeros((r, w), dtype=torch.int32,
                                       device=u.device), zeros, zeros.clone())
    perm, cost, z = _chain_windows(u, min(beam, w), starts)
    return ChainResult(perm, cost, z)


def chain_cost(streams: Streams, perm: torch.Tensor) -> torch.Tensor:
    """Sum of consecutive summed-plane Hamming distances of each window of
    ``streams`` reordered by ``perm`` - the objective O3 minimizes."""
    u = _as_planes(streams)
    p = u.shape[0]
    seq = torch.gather(u, 2, perm.to(torch.int64)[None].expand(p, *perm.shape))
    if seq.shape[-1] < 2:
        return torch.zeros((seq.shape[1],), dtype=torch.int32,
                           device=u.device)
    return _dist(seq[..., :-1], seq[..., 1:]).sum(1, dtype=torch.int32)


def _np_words(a) -> np.ndarray:
    """numpy or torch values -> uint32 bit patterns (zero-extended)."""
    if isinstance(a, torch.Tensor):
        return words32(a.cpu()).numpy().view(np.uint32)
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}").astype(np.uint32)


def min_hamming_chain_reference(streams, *, beam: int = DEFAULT_BEAM,
                                starts: int = DEFAULT_STARTS):
    """Per-window numpy mirror of :func:`min_hamming_chain`, in python
    loops (the reference's oracle, kept as the port's own copy) -> numpy
    ``(perm, cost, nonzeros)``."""
    if isinstance(streams, (torch.Tensor, np.ndarray)):
        streams = (streams,)
    planes = [_np_words(s) for s in streams]
    r, w = planes[0].shape
    beam_w = min(max(beam, 1), max(w, 1))

    def popc(x):
        return bin(int(x)).count("1")

    def dist(i, j, q):
        return sum(popc(int(p[i]) ^ int(p[j])) for p in q)

    perms = np.zeros((r, w), np.int32)
    costs = np.zeros((r,), np.int32)
    zs = np.zeros((r,), np.int32)
    if w == 0:
        return perms, costs, zs
    for row in range(r):
        q0 = [p[row] for p in planes]
        pops = [sum(popc(int(p[i])) for p in q0) for i in range(w)]
        nzidx = [i for i in range(w) if pops[i] > 0]
        zidx = [i for i in range(w) if pops[i] == 0]
        part = nzidx + zidx
        q = [p[part] for p in q0]
        z = len(nzidx)
        cid = sum(dist(i, i + 1, q) for i in range(w - 1))

        dperm = sorted(range(w), key=lambda i: (-sum(
            popc(int(p[i])) for p in q), i))
        start_pos = [dperm[(s * z) // starts] for s in range(starts)]

        best_cost, best_order = None, None
        for start in start_pos:
            visited = [False] * w
            visited[start] = True
            order = [start]
            cur, cost = start, 0
            for _ in range(w - 1):
                def selkey(j):
                    d = dist(cur, j, q)
                    pen = (_VISITED if visited[j] else 0) + \
                        (_ZONE if j >= z else 0)
                    return d * w + j + pen
                cands = sorted(range(w), key=selkey)[:beam_w]

                def score(c):
                    d = dist(cur, c, q)
                    rest = [j for j in range(w)
                            if not visited[j] and j < z and j != c]
                    la = min((dist(c, j, q) for j in rest), default=0)
                    pen = (_VISITED if visited[c] else 0) + \
                        (_ZONE if c >= z else 0)
                    return (d + la) * (130 * w) + d * w + c + pen
                nxt = min(cands, key=score)
                visited[nxt] = True
                order.append(nxt)
                cost += dist(cur, nxt, q)
                cur = nxt
            if best_cost is None or cost < best_cost:
                best_cost, best_order = cost, order
        if best_cost is None or not (best_cost < cid):
            best_cost, best_order = cid, list(range(w))
        perms[row] = np.asarray(part, np.int32)[best_order]
        costs[row] = best_cost
        zs[row] = z
    return perms, costs, zs
