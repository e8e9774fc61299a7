"""Plain-PyTorch versions of the port's kernels.

Each is the semantic ground truth its Hopper kernel is held to (exact
equality: these are integer and bit operations). They are also what the
port runs on CPU tensors.
"""
from __future__ import annotations

import torch

from ..core.bits import popcount32, widen_unsigned, words32

__all__ = ["popcount_ref", "bt_boundaries_ref", "bt_total_ref",
           "bt_measure_ref", "router_step_ref",
           "sort_windows_ref", "order_unit_ref", "chain_select_ref",
           "chain_greedy_ref", "descending_perm_rows_ref",
           "chain_inputs_ref"]


def popcount_ref(values: torch.Tensor) -> torch.Tensor:
    """'1'-bit count per element (int32), any dtype with an unsigned view."""
    return popcount32(words32(values))


def descending_perm_rows_ref(rows: torch.Tensor, tiebreak: str,
                             nbits: int) -> torch.Tensor:
    """Flat int64 permutation sorting each (R, W) row of int32 carriers of
    zero-extended ``nbits``-wide words by '1'-bit count, descending,
    window offsets added.

    ``stable`` keeps the original order among equal counts. ``pattern``
    orders equal counts by bit pattern, descending as unsigned, then by
    position: the reference's two stable sorts (``~u`` ascending, then the
    count) are one stable sort on the composite key ``(-count, ~u)``, which
    this builds in int64 from the zero-extended pattern.
    """
    counts = popcount32(rows).to(torch.int64)
    if tiebreak == "stable":
        key = -counts
    elif tiebreak == "pattern":
        inv = ((1 << nbits) - 1) - widen_unsigned(rows)      # ~u, unsigned
        key = ((nbits - counts) << nbits) | inv
    else:
        raise ValueError(f"unknown tiebreak {tiebreak!r}")
    perm = torch.argsort(key, dim=-1, stable=True)
    nw, w = rows.shape
    offset = (torch.arange(nw, device=perm.device) * w)[:, None]
    return (perm + offset).reshape(-1)


def bt_boundaries_ref(words: torch.Tensor) -> torch.Tensor:
    """Bit transitions at each flit boundary of an (F, L) word stream ->
    (F-1,) int32 (the paper's Fig. 8 recorder)."""
    w = words32(words)
    return popcount32(w[:-1] ^ w[1:]).sum(dim=-1, dtype=torch.int32)


def bt_total_ref(words: torch.Tensor) -> torch.Tensor:
    """Total bit transitions over an (F, L) word stream -> int32 scalar
    (an int32 sum of the boundary counts)."""
    return bt_boundaries_ref(words).sum(dtype=torch.int32)


def bt_measure_ref(words: torch.Tensor) -> torch.Tensor:
    """``[total, S1, S2]`` (int64) of an (F, L) word stream: the int32 BT
    total, and over the word pairs (w[i, j], w[i+1, j]) with popcounts x
    and y, S1 = sum(x + y) and S2 = sum(x y) (Eq. 3's sums), in int64."""
    c = popcount32(words32(words)).to(torch.int64)
    x, y = c[:-1], c[1:]
    return torch.stack([bt_total_ref(words).to(torch.int64),
                        (x + y).sum(), (x * y).sum()])


def router_step_ref(state, wire, mc_nodes: torch.Tensor, cycles: int,
                    mesh_key, count_headers: bool):
    """``cycles`` applications of the plain step (``noc.sim.plain_step``);
    returns the new state."""
    from ..noc.sim import plain_step
    for _ in range(cycles):
        state = plain_step(state, wire, mc_nodes, mesh_key, count_headers)
    return state


def _compare_exchange(keys: torch.Tensor, payloads, k: int, j: int):
    """One substage (k, j) of the bitonic network over the last axis: lane
    i pairs with i ^ 2^j, and the pair sorts descending when
    ``((i >> (k+1)) & 1) == 0``; the lower lane takes the other's element
    only on a strict comparison (``repro/kernels/bitonic_sort.py``
    ``_compare_exchange``)."""
    r, w = keys.shape
    s = 1 << j
    g = w // (2 * s)

    def split(x):
        x = x.reshape(r, g, 2, s)
        return x[:, :, 0, :], x[:, :, 1, :]

    ka, kb = split(keys)
    grp = torch.arange(g, device=keys.device)[None, :, None]
    desc = ((grp >> (k - j)) & 1) == 0
    swap = torch.where(desc, ka < kb, ka > kb)

    def merge(x):
        a, b = split(x)
        return torch.stack([torch.where(swap, b, a), torch.where(swap, a, b)],
                           dim=2).reshape(r, w)

    return merge(keys), tuple(merge(p) for p in payloads)


def sort_windows_ref(keys: torch.Tensor, *payloads: torch.Tensor):
    """The bitonic network, descending, over each row of (R, W) int32 keys
    (W a power of two), payloads riding the swaps. Not ``torch.sort``: the
    network is not stable, and this is its exact output on ties."""
    w = keys.shape[1]
    for k in range(max(w.bit_length() - 1, 0)):
        for j in range(k, -1, -1):
            keys, payloads = _compare_exchange(keys, payloads, k, j)
    return (keys, *payloads)


def order_unit_ref(words: torch.Tensor):
    """Popcount keys + the descending network over (R, W) int32 words ->
    (ordered words, window permutation int32)."""
    idx = torch.arange(words.shape[1], dtype=torch.int32,
                       device=words.device).expand(words.shape)
    _, vals, perm = sort_windows_ref(popcount32(words), words, idx)
    return vals, perm


def chain_select_ref(planes, penalty: torch.Tensor, k2: int):
    """(dvec, order) of one chain step: the summed popcount of the (R, W)
    int32 XOR planes, and the lanes sorted ascending by the int32 key
    ``dvec * k2 + idx + penalty`` (one stable argsort)."""
    dvec = popcount32(planes[0])
    for p in planes[1:]:
        dvec = dvec + popcount32(p)
    idx = torch.arange(penalty.shape[1], dtype=torch.int32,
                       device=penalty.device)
    key = dvec * k2 + idx + penalty.to(torch.int32)
    order = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    return dvec, order


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Summed XOR-popcount distance over the leading plane axis (int32)."""
    d = popcount32(a ^ b)
    return d[0] if d.shape[0] == 1 else d.sum(0, dtype=torch.int32)


def chain_inputs_ref(u: torch.Tensor, starts: int):
    """A (P, R, W) int32 stack -> the chain's inputs: the zeros-to-tail
    partition ``part`` (R, W) int64, the partitioned planes ``q``, the live
    counts ``z``, the partitioned identity's cost ``cid`` and the (R, S)
    int64 start positions."""
    p, r, w = u.shape
    dev = u.device
    pc = popcount32(u)
    pops = pc[0] if p == 1 else pc.sum(0, dtype=torch.int32)     # (R, W)
    nz = pops > 0
    z = nz.sum(1, dtype=torch.int32)
    part = torch.argsort((~nz).to(torch.int8), dim=1, stable=True)
    q = torch.gather(u, 2, part[None].expand(p, r, w))
    cid = (_dist(q[..., :-1], q[..., 1:]).sum(1, dtype=torch.int32)
           if w > 1 else torch.zeros((r,), dtype=torch.int32, device=dev))

    # Start positions: descending-popcount ranks 0, z/S, 2z/S, ... - all of
    # 0..z-1 when z <= starts (the exhaustive small-window regime).
    dperm = torch.argsort(-torch.gather(pops, 1, part), dim=1, stable=True)
    ranks = (torch.arange(starts, dtype=torch.int64, device=dev)[None, :]
             * z[:, None].to(torch.int64)) // starts
    start_pos = torch.gather(dperm, 1, ranks)                    # (R, S)
    return part, q, z, cid, start_pos


def chain_greedy_ref(q: torch.Tensor, z: torch.Tensor, start: torch.Tensor,
                     beam: int):
    """Greedy beam-lookahead chains over partitioned (P, R, W) int32 planes
    with (R,) live counts from (R, S) start positions -> (orders (R, S, W),
    costs (R, S)) int32: the reference's ``_greedy_from`` scan, vmapped over
    starts and windows, as one (R, S) batch and a loop of ``w - 1`` steps,
    each a :func:`chain_select_ref` call."""
    from .min_hamming import _INF, _VISITED, _ZONE
    p, r, w = q.shape
    s = start.shape[1]
    dev = q.device
    idx = torch.arange(w, dtype=torch.int32, device=dev)
    zone = torch.where(idx[None, :] >= z[:, None], _ZONE, 0).to(torch.int32)
    k1, k2 = 130 * w, w
    start = start.to(torch.int64)
    # pen = visited + zone penalty per lane; pen >= _ZONE marks the lanes
    # the lookahead skips (visited or zero-region).
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
        xor = q4 ^ qcur                                           # (P,R,S,W)
        dvec, sel = chain_select_ref(tuple(xor.reshape(p, r * s, w)),
                                     pen.reshape(r * s, w), k2)
        dvec = dvec.view(r, s, w)
        cand = sel.view(r, s, w)[..., :beam].to(torch.int64)      # (R,S,B)
        d_b = torch.gather(dvec, 2, cand)
        qc = torch.gather(q4, 3, cand[None].expand(p, r, s, beam))
        d2 = _dist(qc[..., None], q[:, :, None, None, :])        # (R,S,B,W)
        lamask = ((pen >= _ZONE)[:, :, None, :]
                  | (idx.to(torch.int64) == cand[..., None]))
        la = torch.where(lamask, _INF, d2).amin(dim=3)
        la = torch.where(la >= _INF, 0, la)
        score = ((d_b + la) * k1 + d_b * k2 + cand.to(torch.int32)
                 + torch.gather(pen, 2, cand))
        # Scores are pairwise distinct (they embed the candidate index), so
        # the argmin has no ties to break; the winner is always an unvisited
        # lane (one remains at every step), so adding _VISITED marks it.
        nxt = torch.gather(cand, 2, score.argmin(dim=2, keepdim=True))
        pen.scatter_add_(2, nxt, visited_pen)
        cost = cost + torch.gather(dvec, 2, nxt)[..., 0]
        order[..., i] = nxt[..., 0].to(torch.int32)
        cur = nxt[..., 0]
    return order, cost
