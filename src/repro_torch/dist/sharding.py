"""Logical-axis sharding rules: ParamSpec axes -> mesh placements.

The port of ``repro.dist.sharding``. Every tensor names its dims with
logical axes (``repro_torch.models.spec``); a rules dict maps each logical
axis to a mesh axis, a tuple of mesh axes, or None (replicate).
:func:`logical_to_pspec` applies the rules with the reference's two safety
valves:

* **divisibility fallback** - a dim that does not divide the mesh-axis size
  is replicated (14 heads on a 16-way model axis -> replicated; 48 heads ->
  sharded);
* **duplicate-axis guard** - one mesh axis is consumed at most once per
  tensor (left to right); a second logical axis mapped to it replicates.

A ``pod`` axis in the mesh expands every ``"data"`` assignment to
``("pod", "data")``. The entries are the reference's ``PartitionSpec``
entries (:class:`PSpec`, a tuple). :func:`placements` turns them into
``torch.distributed.tensor`` placements, one per mesh dim, which
``distribute_tensor`` takes: :func:`spec_shardings` for a ParamSpec tree,
:func:`batch_shardings` and :func:`compact_batch` for batched data.

Meshes are read by their axis names and sizes only: a torch
``DeviceMesh`` (``mesh_dim_names`` and its shape), a :class:`LocalMesh`,
or any stand-in with ``.axis_names`` and ``.shape`` (name -> size). A
DTensor mesh wants one process per rank, so it cannot name two devices of
one process, nor one device twice; the single-process NoC drain
(``noc.sim.simulate_batch(devices=)``) takes a device list or a 1-D
:class:`LocalMesh` instead, and needs no DTensor.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from ..tree import leaves, map_leaves, unflatten

__all__ = ["Rules", "DEFAULT_RULES", "PSpec", "LocalMesh", "mesh_axes",
           "logical_to_pspec", "placements", "spec_pspecs", "spec_shardings",
           "batch_shardings", "compact_batch", "data_axis_size"]

Rules = Dict[str, Union[None, str, Tuple[str, ...]]]

DEFAULT_RULES: Rules = {
    # data-parallel dims
    "batch": "data",
    "seq": None,
    # tensor-parallel dims: shard the "many units" axis over 'model'
    "embed": None,
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "vocab": "model",
    "experts": "model",
    "state": "model",
    # scan/stacking and small conv dims stay replicated
    "layers": None,
    "conv_in": None,
    "conv_out": "model",
}


class PSpec(tuple):
    """One entry per tensor dim: None, a mesh axis, or a tuple of mesh
    axes - ``tuple(jax.sharding.PartitionSpec(...))`` compares equal."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PSpec{tuple.__repr__(self)}"


class LocalMesh:
    """Devices of this process in an n-D array with named axes: the
    counterpart of ``jax.sharding.Mesh`` where no process group is wanted.
    A device may repeat."""

    def __init__(self, devices, axis_names):
        arr = np.array(devices, dtype=object)
        self.devices = np.vectorize(torch.device, otypes=[object])(arr)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-D device array")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size, in mesh-dim order."""
    if isinstance(mesh, DeviceMesh):
        if mesh.mesh_dim_names is None:
            raise ValueError("a DeviceMesh needs mesh_dim_names to be read "
                             "by logical-axis rules")
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _expand(rule, axis_names) -> Tuple[str, ...]:
    """Normalize a rule value to a tuple of mesh axes, with pod expansion."""
    if rule is None:
        return ()
    axes = (rule,) if isinstance(rule, str) else tuple(rule)
    if "pod" in axis_names and "data" in axes and "pod" not in axes:
        out = []
        for a in axes:
            out.extend(("pod", "data") if a == "data" else (a,))
        axes = tuple(out)
    return axes


def logical_to_pspec(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
                     rules: Rules, mesh) -> PSpec:
    """The spec of one tensor, honouring the fallback and the guard."""
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} vs shape {shape} rank mismatch")
    sizes = mesh_axes(mesh)
    names = tuple(sizes)
    used: set = set()
    entries = []
    for logical, dim in zip(axes, shape):
        cand = _expand(rules.get(logical) if logical else None, names)
        ok = (cand
              and all(a in names for a in cand)
              and not (set(cand) & used))
        if ok:
            size = 1
            for a in cand:
                size *= sizes[a]
            ok = dim % size == 0
        if ok:
            used.update(cand)
            entries.append(cand[0] if len(cand) == 1 else cand)
        else:
            entries.append(None)
    return PSpec(*entries)


def placements(spec: PSpec, mesh) -> List:
    """DTensor placements of a spec, one per mesh dim: ``Shard(d)`` where
    the spec puts tensor dim ``d`` on that mesh axis, else ``Replicate()``.
    A tuple entry shards its dim over each of its axes; DTensor splits it in
    mesh-dim order, which is the spec's major-to-minor order only when the
    tuple lists its axes in mesh-dim order (anything else raises)."""
    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry} lists its mesh axes out of "
                             f"mesh-dim order {tuple(names)}")
        for i in dims:
            out[i] = Shard(d)
    return out


def spec_pspecs(specs, rules: Rules, mesh):
    """The spec of every ParamSpec of a spec tree, in its structure (the
    reference's ``NamedSharding`` tree's ``.spec`` entries)."""
    return map_leaves(lambda s: logical_to_pspec(s.axes, s.shape, rules,
                                                 mesh), specs)


def spec_shardings(specs, rules: Rules, mesh):
    """Placements for every ParamSpec of a spec tree, in its structure."""
    return map_leaves(lambda s: placements(
        logical_to_pspec(s.axes, s.shape, rules, mesh), mesh), specs)


def _batch_placements(mesh, x, axis: str) -> List:
    shape = tuple(getattr(x, "shape", ()))
    size = mesh_axes(mesh)[axis]
    spec = PSpec(axis) if (shape and shape[0] % size == 0) else PSpec()
    return placements(spec, mesh)


def batch_shardings(mesh, tree, axis: str = "data"):
    """Placements splitting every leaf's leading dim over ``axis``, in the
    structure of ``tree``; a scalar leaf, or a leading dim that does not
    divide the axis, is replicated."""
    return map_leaves(lambda x: _batch_placements(mesh, x, axis), tree)


def compact_batch(mesh: DeviceMesh, tree, idx, axis: str = "data"):
    """Rows ``idx`` of every leaf's leading dim (a DTensor leaf gathered
    first), distributed over ``mesh`` by :func:`batch_shardings`."""
    idx = torch.as_tensor(idx)
    rows = [(x.full_tensor() if isinstance(x, DTensor) else x)
            for x in leaves(tree)]
    rows = [x.index_select(0, idx.to(x.device)) for x in rows]
    return unflatten(tree, [distribute_tensor(
        x, mesh, _batch_placements(mesh, x, axis)) for x in rows])


def data_axis_size(mesh) -> int:
    """Total data-parallel degree: the 'data' axis, times 'pod' if present."""
    sizes = mesh_axes(mesh)
    n = 1
    for a in ("pod", "data"):
        n *= sizes.get(a, 1)
    return n
