"""Gradient bucketing for collective / compute overlap.

The port of ``repro.dist.overlap``'s ``bucketed`` and ``unbucket``: a
gradient tree's leaves cut into size-capped buckets, so that reducing
bucket k can overlap computing bucket k + 1, and put back exactly. Each
bucket is also one payload for
:func:`repro_torch.dist.ordered_collectives.order_gradient_bucket`.

The reference's ``xla_overlap_flags`` is left out: it sets XLA-on-TPU
flags that schedule collectives asynchronously, and PyTorch has nothing to
set. Under ``DistributedDataParallel`` the all-reduce already overlaps the
backward pass, bucket by bucket, and its bucket size is ``bucket_cap_mb``;
a trainer sets that from the same cap.
"""
from __future__ import annotations

from typing import List

from ..tree import leaves, unflatten

__all__ = ["bucketed", "unbucket"]


def bucketed(tree, max_bytes: int) -> List[list]:
    """Partition a tree's leaves, in the reference's order, into buckets of
    at most ``max_bytes`` (``numel * element_size`` a leaf).

    Greedy in leaf order, so :func:`unbucket` is a plain concatenation: a
    leaf that would push the current bucket past the cap starts a new one,
    and a leaf larger than the cap gets a bucket of its own (never split).
    """
    if max_bytes <= 0:
        raise ValueError(f"max_bytes must be positive, got {max_bytes}")
    buckets: List[list] = []
    cur: list = []
    cur_bytes = 0
    for leaf in leaves(tree):
        nbytes = leaf.numel() * leaf.element_size()
        if cur and cur_bytes + nbytes > max_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(leaf)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def unbucket(buckets: List[list], tree):
    """Reassemble :func:`bucketed` output into ``tree``'s structure."""
    flat = [leaf for bucket in buckets for leaf in bucket]
    n = len(leaves(tree))
    if len(flat) != n:
        raise ValueError(f"buckets hold {len(flat)} leaves, tree has {n}")
    return unflatten(tree, flat)
