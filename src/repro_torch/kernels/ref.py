"""Plain-PyTorch versions of the port's kernels.

Each is the semantic ground truth its Hopper kernel is held to (exact
equality: these are integer and bit operations). They are also what the
port runs on CPU tensors.
"""
from __future__ import annotations

import torch

from ..core.bits import popcount32, words32

__all__ = ["popcount_ref", "bt_boundaries_ref", "router_step_ref",
           "sort_windows_ref", "order_unit_ref", "chain_select_ref"]


def popcount_ref(values: torch.Tensor) -> torch.Tensor:
    """'1'-bit count per element (int32), any dtype with an unsigned view."""
    return popcount32(words32(values))


def bt_boundaries_ref(words: torch.Tensor) -> torch.Tensor:
    """Bit transitions at each flit boundary of an (F, L) word stream ->
    (F-1,) int32 (the paper's Fig. 8 recorder)."""
    w = words32(words)
    return popcount32(w[:-1] ^ w[1:]).sum(dim=-1, dtype=torch.int32)


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
