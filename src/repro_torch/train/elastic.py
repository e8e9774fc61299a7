"""Elastic scaling + straggler policy (the port of ``repro.train.elastic``,
pure Python, copied whole).

The contract at 1000+ node scale:

  * **Checkpoint/restart** - repro_torch.train.checkpoint gives
    crash-consistent restore; the launcher restores the newest intact step
    on every (re)start.
  * **Elastic re-mesh** - ``choose_mesh`` picks a (data, model) factorization
    for whatever device count survives, holding the model axis fixed (TP
    degree is a property of the weights' layout) and flexing the data axis.
    Because the data pipeline is addressable by (step, shard), a re-meshed
    job recomputes shard assignments with no data loss.
  * **Straggler mitigation** - deterministic shard regeneration means a
    slow/failed host's shard can be re-issued to any spare host; combined
    with grad-accumulation the global batch stays constant when the data
    axis shrinks (``microbatches_for`` below).
"""
from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["choose_mesh", "microbatches_for"]


def choose_mesh(n_devices: int, model_parallel: int = 16,
                pods: Optional[int] = None) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest (data, model) mesh that fits ``n_devices``.

    Keeps the model axis fixed and uses the largest data axis such that
    data * model <= n_devices (dropped devices idle until replaced - the
    standard elastic policy when TP groups must stay intact).
    """
    if n_devices < model_parallel:
        raise ValueError(
            f"need at least one full TP group ({model_parallel} devices), "
            f"got {n_devices}")
    data = n_devices // model_parallel
    if pods is not None and pods > 1:
        if data % pods:
            data = (data // pods) * pods
        return (pods, data // pods, model_parallel), ("pod", "data", "model")
    return (data, model_parallel), ("data", "model")


def microbatches_for(global_batch: int, per_device_batch: int,
                     data_axis: int) -> int:
    """Grad-accumulation factor keeping the global batch constant when the
    data axis shrinks (elastic downscale)."""
    per_step = per_device_batch * data_axis
    if global_batch % per_step:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"data_axis*per_device = {per_step}")
    return global_batch // per_step
