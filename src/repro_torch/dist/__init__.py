"""Distributed substrate: sharding rules, ordered collectives, static weight
layouts and gradient bucketing (the port of ``repro.dist``).

* :mod:`.sharding` - logical-axis -> mesh-axis rules with the divisibility
  fallback, as ``torch.distributed.tensor`` placements on a DTensor mesh;
* :mod:`.ordered_collectives` - the paper's O1/O2 orderings applied to
  gradient all-reduce payloads (bucket transform + BT report);
* :mod:`.static_reorder` - popcount-descending hidden-unit layouts that
  leave the model's function unchanged;
* :mod:`.overlap` - gradient bucketing (the reference's
  ``xla_overlap_flags`` has no PyTorch counterpart: see the module).
"""
from . import ordered_collectives, overlap, sharding, static_reorder
from .ordered_collectives import (GradientBucket, gradient_wire_report,
                                  order_gradient_bucket,
                                  restore_gradient_bucket)
from .overlap import bucketed, unbucket
from .sharding import (DEFAULT_RULES, LocalMesh, PSpec, Rules,
                       batch_shardings, compact_batch, data_axis_size,
                       logical_to_pspec, placements, spec_pspecs,
                       spec_shardings)
from .static_reorder import (mlp_unit_permutation, reorder_lm_params,
                             reorder_mlp, stream_bt_report, stream_bt_total)

__all__ = [
    "sharding", "ordered_collectives", "static_reorder", "overlap",
    "Rules", "DEFAULT_RULES", "PSpec", "LocalMesh", "logical_to_pspec",
    "placements", "spec_pspecs", "spec_shardings", "batch_shardings",
    "compact_batch", "data_axis_size",
    "GradientBucket", "order_gradient_bucket", "restore_gradient_bucket",
    "gradient_wire_report",
    "mlp_unit_permutation", "reorder_mlp", "reorder_lm_params",
    "stream_bt_report", "stream_bt_total",
    "bucketed", "unbucket",
]
