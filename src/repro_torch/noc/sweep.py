"""Declarative NoC sweep engine on the paper's axes (Figs. 12-13, Tab. I).

The port of ``repro.noc.sweep.run_sweep`` for meshes x transforms x
tiebreaks x precisions x models, with the paper's edge MC placement,
round-robin packet->MC dealing, no compression and no result phase. All
ordering/precision/tiebreak variants of one (mesh, model) pair share their
traffic shapes, so each pair packetizes once (payloads ordered once per
model) and drains in ONE batched simulation. Rows carry the reference's
keys and values: raw BT totals, exact drain cycles, the reduction against
the cell's O0 baseline, and the honest reduction that charges the
recovery index of O2 and O3 at half a transition per bit. The transforms
axis takes O0, O1, O2, O3 and O3a.

Placement, affinity, compression and result-phase axes arrive with later
slices (ROADMAP queue A, items 9 and 11); until then every row reads
``placement="edge"``, ``affinity="roundrobin"``, ``compression="none"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.wire import WireTransform, by_name
from ..quant import quantize_fixed8
from .sim import BACKENDS, SimResult, simulate_batch
from .topology import NocConfig, mesh_by_name, packet_mean_hops, xy_link_loads
from .traffic import (LayerTraffic, assemble_traffic,
                      build_traffic_streamed_multi, ordered_payloads,
                      pad_traffic_length, payload_shapes, stream_lengths)

__all__ = ["SweepGrid", "SweepReport", "run_sweep", "recovery_overhead_bits",
           "cached_ordered_payloads", "drain_estimate"]

Mesh = Union[str, NocConfig]
LayersFn = Callable[[str], Sequence[LayerTraffic]]

_QUANTIZERS = {
    "float32": None,
    "fixed8": lambda t: quantize_fixed8(t).values,
}

_LATER = "a later slice of the port (ROADMAP queue A, item {})"


@dataclasses.dataclass(frozen=True)
class SweepGrid:
    """One declarative sweep: meshes x transforms x tiebreaks x precisions x
    models (``repro.noc.sweep.SweepGrid`` on the paper's axes).

    meshes: PAPER_NOCS names, ``RxC_mcN`` specs, or NocConfig instances.
    max_packets_per_layer: deterministic-stride neuron subsampling budget;
        ``None`` packetizes the full layers through the streamed path.
    backend: the router step - ``"auto"`` (the Hopper kernel on CUDA, the
        plain step on the CPU), ``"plain"`` or ``"cuda"``.
    device: where the sweep runs (CUDA unless ``"cpu"`` is given).
    """

    meshes: Sequence[Mesh] = ("4x4_mc2",)
    transforms: Sequence[str] = ("O0", "O1", "O2")
    tiebreaks: Sequence[str] = ("pattern",)
    precisions: Sequence[str] = ("float32", "fixed8")
    models: Sequence[str] = ("lenet",)
    max_packets_per_layer: Optional[int] = 40
    stream_chunk_packets: int = 4096
    count_headers: bool = True
    chunk: int = 2048
    max_cycles: int = 2_000_000
    baseline: str = "O0"
    backend: str = "auto"
    device: Optional[str] = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {self.backend!r}")
        unknown = set(self.precisions) - set(_QUANTIZERS)
        if unknown:
            raise ValueError(f"unknown precisions {sorted(unknown)}; "
                             f"supported: {sorted(_QUANTIZERS)}")
        if self.baseline not in self.transforms:
            raise ValueError(
                f"baseline {self.baseline!r} not in transforms {self.transforms}")

    def variant_axes(self):
        """The per-shape-class variant list, in batch order."""
        return [(prec, tb, tr) for prec in self.precisions
                for tb in self.tiebreaks for tr in self.transforms]


@dataclasses.dataclass
class SweepReport:
    rows: List[dict]
    stats: dict

    def row(self, **match) -> dict:
        hits = [r for r in self.rows
                if all(r[k] == v for k, v in match.items())]
        if len(hits) != 1:
            raise KeyError(f"{len(hits)} rows match {match}")
        return hits[0]


def recovery_overhead_bits(layers: Sequence[LayerTraffic],
                           transform: WireTransform,
                           max_packets_per_layer: Optional[int] = None) -> int:
    """Total recovery-index bits a transform must transmit for ``layers``
    (O2/O3: one minimal-width in-packet index per pair; O0/O1/O3a on the
    paired request phase: zero)."""
    total = 0
    for layer in layers:
        n, k = int(layer.inputs.shape[0]), int(layer.inputs.shape[1])
        if max_packets_per_layer is not None and n > max_packets_per_layer:
            n = max_packets_per_layer
        window = transform.window if transform.window is not None else k
        total += n * k * transform.overhead_bits_per_value(min(window, k))
    return total


def cached_ordered_payloads(cache: Dict[tuple, list], model: str,
                            layers: Sequence[LayerTraffic], lanes: int,
                            variants, axes,
                            max_packets_per_layer: Optional[int],
                            timings: Optional[Dict[str, float]] = None,
                            device: DeviceLike = None) -> list:
    """Ordered payloads for ``variants``, cached per (model, lanes,
    transform, precision); returns the per-layer (B, n, F, L) stacks.
    ``timings`` (transform name -> seconds, accumulated in place) charges
    each cache miss to its transform, the device synchronised at the end."""
    dev = resolve_device(device)
    stacks = []
    for (tr, q), (prec, _, _) in zip(variants, axes):
        key = (model, lanes, tr, prec)
        if key not in cache:
            t0 = time.perf_counter()
            cache[key] = ordered_payloads(
                layers, lanes, [(tr, q)],
                max_packets_per_layer=max_packets_per_layer, device=dev)
            if timings is not None:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                timings[tr.name] = (timings.get(tr.name, 0.0)
                                    + time.perf_counter() - t0)
        stacks.append(cache[key])
    return [torch.cat([s[li] for s in stacks])
            for li in range(len(stacks[0]))]


def _resolve_mesh(mesh: Mesh) -> tuple:
    if isinstance(mesh, NocConfig):
        return (f"{mesh.rows}x{mesh.cols}_mc{mesh.num_mcs}", mesh)
    return (mesh, mesh_by_name(mesh))


def drain_estimate(cfg: NocConfig, lengths: np.ndarray) -> float:
    """Lower-bound drain estimate: max(injection bound, hottest-link bound)."""
    lengths = np.asarray(lengths, float)[:cfg.num_mcs]
    inj = float(lengths.max()) if lengths.size else 0.0
    link = float(xy_link_loads(cfg, lengths).max()) if lengths.size else 0.0
    return max(inj, link)


def run_sweep(grid: SweepGrid, layers_for_model: LayersFn, *,
              check_conservation: bool = False, devices=None) -> SweepReport:
    """Execute every cell of ``grid``: one packetization and ONE batched
    drain per (mesh, model), one row per (mesh, model, precision, tiebreak,
    transform), in the reference's row order and with its keys."""
    if check_conservation:
        raise NotImplementedError(
            "check_conservation arrives with " + _LATER.format(6))
    if devices is not None:
        raise NotImplementedError("devices= arrives with " + _LATER.format(15))
    dev = resolve_device(grid.device)
    axes = grid.variant_axes()
    variants = [(by_name(tr, tiebreak=tb), _QUANTIZERS[prec])
                for prec, tb, tr in axes]
    streamed = grid.max_packets_per_layer is None
    rows: List[dict] = []
    classes = []
    pack_s = sim_s = 0.0
    pack_by_tr: Dict[str, float] = {}
    stepped_cycles = 0
    all_drained = True
    layer_cache: Dict[str, Sequence[LayerTraffic]] = {}
    ordered_cache: Dict[tuple, list] = {}
    payload_cache: Dict[tuple, list] = {}
    shape_cache: Dict[tuple, list] = {}
    # Meshes of one size share traffic shapes: pad every member of a size
    # group to the group's MC-stream count and stream length, as the
    # reference does (padding streams are empty and never inject).
    resolved = [_resolve_mesh(m) for m in grid.meshes]
    size_groups: Dict[tuple, List[NocConfig]] = {}
    for _, cfg in resolved:
        key = (cfg.rows, cfg.cols, cfg.num_vcs, cfg.vc_depth, cfg.lanes)
        size_groups.setdefault(key, []).append(cfg)
    nv = len(variants)

    for mesh_name, cfg in resolved:
        for model in grid.models:
            if model not in layer_cache:
                layer_cache[model] = layers_for_model(model)
            layers = layer_cache[model]

            t0 = time.perf_counter()
            pkey = (model, cfg.lanes)
            if pkey not in shape_cache:
                if streamed:
                    shape_cache[pkey] = payload_shapes(
                        layers, cfg.lanes, variants,
                        max_packets_per_layer=grid.max_packets_per_layer,
                        device=dev)
                else:
                    payload_cache[pkey] = cached_ordered_payloads(
                        ordered_cache, model, layers, cfg.lanes, variants,
                        axes, max_packets_per_layer=grid.max_packets_per_layer,
                        timings=pack_by_tr, device=dev)
                    shape_cache[pkey] = [(w.shape[1], w.shape[2])
                                         for w in payload_cache[pkey]]
            group = size_groups[(cfg.rows, cfg.cols, cfg.num_vcs,
                                 cfg.vc_depth, cfg.lanes)]
            shapes = shape_cache[pkey]
            npackets = sum(n for n, _ in shapes)
            mc_pad = max(c.num_mcs for c in group)
            lens = stream_lengths(shapes, cfg.num_mcs)
            t_pad = max(int(stream_lengths(shapes, c.num_mcs).max())
                        for c in group)
            if streamed:
                traffic = build_traffic_streamed_multi(
                    layers, [cfg], variants,
                    chunk_packets=grid.stream_chunk_packets,
                    num_streams=mc_pad, shapes=shapes, device=dev,
                    timings=pack_by_tr)[0]
            else:
                traffic = assemble_traffic(payload_cache[pkey], cfg,
                                           num_streams=mc_pad,
                                           num_variants=nv, device=dev)
            traffic = pad_traffic_length(traffic, t_pad)
            mc_rows = np.broadcast_to(
                np.asarray(tuple(cfg.mc_nodes) + (0,) * (mc_pad - cfg.num_mcs),
                           np.int32), (nv, mc_pad))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            results: List[SimResult] = simulate_batch(
                cfg, traffic, mc_nodes=mc_rows,
                count_headers=grid.count_headers, chunk=grid.chunk,
                max_cycles=grid.max_cycles, backend=grid.backend, device=dev)
            t2 = time.perf_counter()

            pack_s += t1 - t0
            sim_s += t2 - t1
            all_drained &= all(r.ejected == r.injected for r in results)
            class_cycles = sum(r.cycles for r in results)
            stepped_cycles += class_cycles
            classes.append({
                "mesh": mesh_name, "placements": ["edge"],
                "affinity": ["roundrobin"], "model": model,
                "compression": "none", "variants": len(results),
                "packetize_s": round(t1 - t0, 4),
                "simulate_s": round(t2 - t1, 4),
                "cycles_per_sec": round(class_cycles / (t2 - t1), 1)
                if t2 > t1 else None,
                "drain_estimate": drain_estimate(cfg, lens),
            })

            mean_hops = packet_mean_hops(cfg, npackets)
            base_bt = {(prec, tb): res.total_bt
                       for (prec, tb, tr), res in zip(axes, results)
                       if tr == grid.baseline}
            for (prec, tb, tr), (transform, _), res in zip(axes, variants,
                                                           results):
                overhead = recovery_overhead_bits(
                    layers, transform,
                    max_packets_per_layer=grid.max_packets_per_layer)
                # Each recovery-index bit costs half a transition (the
                # toggle expectation of an uninformative bit stream).
                adjusted_bt = res.total_bt + overhead // 2
                base = base_bt[(prec, tb)]
                rows.append({
                    "mesh": mesh_name, "placement": "edge",
                    "affinity": "roundrobin", "model": model,
                    "precision": prec, "transform": tr, "tiebreak": tb,
                    "compression": "none",
                    "total_bt": res.total_bt,
                    "adjusted_bt": adjusted_bt,
                    "overhead_bits": overhead,
                    "compression_overhead_bits": 0,
                    "cycles": res.drain_cycle,
                    "flits": res.injected,
                    "bt_per_flit": res.bt_per_flit,
                    "mean_hops": mean_hops,
                    "reduction_pct": (1 - res.total_bt / base) * 100,
                    "adjusted_reduction_pct": (1 - adjusted_bt / base) * 100,
                    "result_bt": None,
                    "result_cycles": None,
                    "result_flits": None,
                    "result_overhead_bits": None,
                    "result_compression_overhead_bits": None,
                    "result_adjusted_bt": None,
                    "result_adjusted_reduction_pct": None,
                })

    stats = {
        "cells": len(rows),
        "shape_classes": classes,
        "packetize_s": round(pack_s, 4),
        "packetize_by_transform": {k: round(v, 4)
                                   for k, v in sorted(pack_by_tr.items())},
        "simulate_s": round(sim_s, 4),
        "wall_s": round(pack_s + sim_s, 4),
        "stepped_cycles": stepped_cycles,
        "cycles_per_sec": round(stepped_cycles / sim_s, 1) if sim_s else None,
        "streamed": streamed,
        "devices": 1,
        "result_phase": False,
        "device": str(dev),
        "ejected_equals_injected": all_drained,
    }
    return SweepReport(rows=rows, stats=stats)
