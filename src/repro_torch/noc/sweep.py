"""Declarative NoC sweep engine on the paper's axes (Figs. 12-13, Tab. I).

The port of ``repro.noc.sweep.run_sweep`` for meshes x MC placements x
packet->MC affinities x transforms x tiebreaks x precisions x models, with
the optional PE->MC result phase. All ordering/precision/tiebreak variants
of one (mesh, model) pair share their traffic shapes, so payloads are
ordered once per model, and every placement x affinity combo of the pair
rides ONE batched request drain as extra lanes (per-lane ``mc_nodes``);
the result phase drains every combo's PE->MC traffic in one more batched
drain. Rows carry the reference's keys and values: raw BT totals, exact
drain cycles, the reduction against the cell's O0 baseline, the honest
reduction that charges the recovery index of O2 and O3 at half a
transition per bit, and the result phase's columns. The transforms axis
takes O0, O1, O2, O3 and O3a; the compression axis ``none`` and ``msr``
(an extra shape class per (mesh, model): MSR changes every packet's flit
count), whose escape records are charged like the recovery index.
``tune_path`` applies ``noc.tune``'s measured drain schedule per mesh, and
``run_sweep(check_conservation=True)`` drains with the packet ledger.
:func:`run_serving` joins the rows with the closed-loop serving suite: one
gated drain per (combo, offered load, fault rate) and a back-to-back
saturation probe per combo (``noc.online``). ``out_path`` writes the rows,
the grid and the stats as the reference's JSON artifact.
"""
from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch.profiler import record_function

from .._device import DeviceLike, resolve_device
from ..core import msr
from ..core.wire import (COMPRESSIONS, PROTECTION_BITS, WireTransform,
                         by_name)
from ..quant import quantize_fixed8
from .online import (ARRIVAL_KINDS, ArrivalProcess, latency_percentiles,
                     simulate_online)
from .sim import (BACKENDS, SimResult, Traffic, _lane_devices,
                  _resolve_backend, simulate_batch)
from .topology import (AFFINITIES, PLACEMENTS, NocConfig, affinity_mc_table,
                       mc_placement, mesh_by_name, packet_mean_hops,
                       xy_link_loads)
from .traffic import (DEFAULT_RESULT_WINDOW, LayerTraffic, assemble_traffic,
                      build_result_traffic, build_traffic_batch,
                      build_traffic_streamed_multi,
                      compression_overhead, ordered_payloads,
                      pad_traffic_length, payload_shapes, result_values,
                      stream_lengths)
from .tune import load_tuned, schedule_for

__all__ = ["SweepGrid", "SweepReport", "run_sweep", "run_serving",
           "recovery_overhead_bits", "cached_ordered_payloads",
           "drain_estimate"]

Mesh = Union[str, NocConfig]
LayersFn = Callable[[str], Sequence[LayerTraffic]]

_QUANTIZERS = {
    "float32": None,
    "fixed8": lambda t: quantize_fixed8(t).values,
}

@dataclasses.dataclass(frozen=True)
class SweepGrid:
    """One declarative sweep: meshes x MC placements x packet->MC
    affinities x transforms x tiebreaks x precisions x models x
    compression schemes, with an optional PE->MC result phase, and the
    closed-loop serving and fault axes that :func:`run_serving` reads
    (``run_sweep`` ignores them): ``repro.noc.sweep.SweepGrid`` field for
    field, plus ``device``.

    meshes: PAPER_NOCS names, ``RxC_mcN`` specs, or NocConfig instances.
    placements: MC placement strategies (``topology.PLACEMENTS``); ``edge``
        keeps each mesh's resolved mc_nodes, the others re-place its MCs.
    affinity: packet->MC strategies (``topology.AFFINITIES``):
        ``roundrobin`` deals packet g to MC ``g % M``, ``nearest`` serves
        each PE from its hop-minimising MC (``affinity_mc_table``).
    compression: payload compression schemes (``core.wire.COMPRESSIONS``):
        ``none`` packs the ordered values as they are; ``msr`` packs them
        as dense 5-bit MSR codes (``core.msr``) and charges the escape
        records in ``compression_overhead_bits`` / ``adjusted_bt``. MSR
        reads int8 payloads, so it needs ``precisions`` within
        ``("fixed8",)``.
    max_packets_per_layer: deterministic-stride neuron subsampling budget;
        ``None`` packetizes the full layers through the streamed path.
    result_phase: also drain each cell's PE->MC result traffic; the rows
        gain ``result_bt``/``result_cycles``/``result_flits`` and the
        single-stream accounting columns (``None`` when off).
    result_window: result values per result packet
        (``traffic.DEFAULT_RESULT_WINDOW`` when ``None``).
    backend: the router step - ``"auto"`` (the Hopper kernel on CUDA, the
        plain step on the CPU), ``"plain"`` or ``"cuda"``.
    tune_path: a ``noc.tune`` winners table (JSON); each mesh found in it
        drains with its measured chunk and ``compact_ratio``, the others
        with ``chunk`` and 0.5. Scheduling only: the rows do not change.
    offered_loads: serving load points in inferences per 1000 cycles
        (empty: no serving suite); ``serving_inferences`` back-to-back
        inferences a point, ``compute_latency`` cycles a PE, arrivals of
        kind ``arrival`` (``online.ARRIVAL_KINDS``) seeded by
        ``arrival_seed``.
    fault_rates: soft-error rates crossed with every load point (rate 0
        with no dead links drains the clean gated step); each faulty point
        drains under ``fault_protect`` with ``fault_seed``,
        ``fault_dead_links``, ``fault_max_retries`` retries and
        ``fault_ack_latency``. ``deadline`` (cycles) turns on SLO
        attainment, ``admit_queue_depth`` overload shedding
        (``online.simulate_online``).
    device: where the sweep runs (CUDA unless ``"cpu"`` is given).
    """

    meshes: Sequence[Mesh] = ("4x4_mc2",)
    placements: Sequence[str] = ("edge",)
    affinity: Sequence[str] = ("roundrobin",)
    transforms: Sequence[str] = ("O0", "O1", "O2")
    tiebreaks: Sequence[str] = ("pattern",)
    precisions: Sequence[str] = ("float32", "fixed8")
    models: Sequence[str] = ("lenet",)
    compression: Sequence[str] = ("none",)
    max_packets_per_layer: Optional[int] = 40
    stream_chunk_packets: int = 4096
    count_headers: bool = True
    chunk: int = 2048
    max_cycles: int = 2_000_000
    baseline: str = "O0"
    result_phase: bool = False
    result_window: Optional[int] = None
    backend: str = "auto"
    tune_path: Optional[str] = None
    offered_loads: Sequence[float] = ()
    serving_inferences: int = 8
    compute_latency: int = 0
    arrival: str = "uniform"
    arrival_seed: int = 0
    fault_rates: Sequence[float] = ()
    fault_protect: str = "crc8"
    fault_seed: int = 0
    fault_dead_links: Sequence = ()
    fault_max_retries: int = 3
    fault_ack_latency: int = 32
    deadline: Optional[int] = None
    admit_queue_depth: Optional[int] = None
    device: Optional[str] = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {self.backend!r}")
        unknown = set(self.precisions) - set(_QUANTIZERS)
        if unknown:
            raise ValueError(f"unknown precisions {sorted(unknown)}; "
                             f"supported: {sorted(_QUANTIZERS)}")
        unknown = set(self.placements) - set(PLACEMENTS)
        if unknown:
            raise ValueError(f"unknown placements {sorted(unknown)}; "
                             f"supported: {sorted(PLACEMENTS)}")
        if not self.placements:
            raise ValueError("need at least one MC placement")
        unknown = set(self.affinity) - set(AFFINITIES)
        if unknown:
            raise ValueError(f"unknown affinity {sorted(unknown)}; "
                             f"supported: {sorted(AFFINITIES)}")
        if not self.affinity:
            raise ValueError("need at least one packet->MC affinity")
        if self.baseline not in self.transforms:
            raise ValueError(
                f"baseline {self.baseline!r} not in transforms {self.transforms}")
        unknown = set(self.compression) - set(COMPRESSIONS)
        if unknown:
            raise ValueError(f"unknown compression {sorted(unknown)}; "
                             f"supported: {COMPRESSIONS}")
        if not self.compression:
            raise ValueError("need at least one compression scheme")
        if "msr" in self.compression:
            nonint = set(self.precisions) - {"fixed8"}
            if nonint:
                raise ValueError(
                    "compression 'msr' reads int8 payloads; drop precisions "
                    f"{sorted(nonint)} or sweep compression=('none',)")
        if self.arrival not in ARRIVAL_KINDS:
            raise ValueError(f"arrival must be one of {ARRIVAL_KINDS}, "
                             f"got {self.arrival!r}")
        if any(not load > 0 for load in self.offered_loads):
            raise ValueError("offered_loads must be > 0 "
                             f"(got {tuple(self.offered_loads)})")
        if self.serving_inferences < 1:
            raise ValueError("serving_inferences must be >= 1")
        if self.compute_latency < 0:
            raise ValueError("compute_latency must be >= 0")
        if self.fault_protect not in PROTECTION_BITS:
            raise ValueError(f"fault_protect must be one of "
                             f"{sorted(PROTECTION_BITS)}, "
                             f"got {self.fault_protect!r}")
        if any(not 0.0 <= r <= 1.0 for r in self.fault_rates):
            raise ValueError("fault_rates must lie in [0, 1] "
                             f"(got {tuple(self.fault_rates)})")
        if self.fault_max_retries < 0:
            raise ValueError("fault_max_retries must be >= 0")
        if self.fault_ack_latency < 1:
            raise ValueError("fault_ack_latency must be >= 1")
        if self.deadline is not None and self.deadline <= 0:
            raise ValueError("deadline must be > 0 cycles when set")
        if self.admit_queue_depth is not None and self.admit_queue_depth < 1:
            raise ValueError("admit_queue_depth must be >= 1 when set")

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
                            compression: str = "none",
                            device: DeviceLike = None) -> list:
    """Ordered payloads for ``variants``, cached per (model, lanes,
    transform, precision, compression); returns the per-layer (B, n, F, L)
    stacks. ``timings`` (transform name -> seconds, accumulated in place)
    charges each cache miss to its transform, the device synchronised at
    the end."""
    dev = resolve_device(device)
    stacks = []
    for (tr, q), (prec, _, _) in zip(variants, axes):
        key = (model, lanes, tr, prec, compression)
        if key not in cache:
            t0 = time.perf_counter()
            cache[key] = ordered_payloads(
                layers, lanes, [(tr, q)],
                max_packets_per_layer=max_packets_per_layer,
                compression=compression, device=dev)
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


def _place(cfg: NocConfig, placement: str) -> NocConfig:
    """``edge`` keeps the resolved mc_nodes (named meshes already use the
    boundary spread; a hand-built NocConfig's nodes stay); the other
    strategies re-place the same MC count."""
    if placement == "edge":
        return cfg
    return dataclasses.replace(
        cfg, mc_nodes=mc_placement(cfg.rows, cfg.cols, cfg.num_mcs,
                                   placement))


def _concat_lanes(parts: Sequence[Traffic]) -> Traffic:
    """Concatenate batched Traffics along the lane axis; ``num_packets`` is
    the max (result-phase parts differ in packet count), -1 if any part's
    is unknown."""
    if len(parts) == 1:
        return parts[0]
    counts = [int(p.num_packets) for p in parts]
    return Traffic(*(torch.cat([p[i] for p in parts]) for i in range(6)),
                   num_packets=-1 if min(counts) < 0 else max(counts))


def _node_rows(nodes_per_combo: Sequence[Sequence[int]], pad: int,
               nv: int) -> np.ndarray:
    """Per-lane injection nodes: each combo's nodes padded with router 0 to
    ``pad`` streams, repeated for its ``nv`` variant lanes."""
    return np.stack([np.asarray(tuple(nodes) + (0,) * (pad - len(nodes)),
                                np.int32)
                     for nodes in nodes_per_combo for _ in range(nv)])


def drain_estimate(cfg: NocConfig, lengths: np.ndarray) -> float:
    """Lower-bound drain estimate: max(injection bound, hottest-link bound)."""
    lengths = np.asarray(lengths, float)[:cfg.num_mcs]
    inj = float(lengths.max()) if lengths.size else 0.0
    link = float(xy_link_loads(cfg, lengths).max()) if lengths.size else 0.0
    return max(inj, link)


def _deal_order(ests: np.ndarray, ndev: int) -> np.ndarray:
    """Lane permutation dealing estimate-sorted lanes round-robin across
    ``ndev`` contiguous device shards; identity when there is nothing to
    balance (one device or uniform estimates)."""
    if ndev <= 1 or np.unique(ests).size <= 1:
        return np.arange(ests.size)
    order = np.argsort(-ests, kind="stable")
    return np.concatenate([order[i::ndev] for i in range(ndev)])


def _take_lanes(traffic: Traffic, idx: np.ndarray) -> Traffic:
    """The lanes ``idx`` of a batched Traffic, in that order."""
    if np.array_equal(idx, np.arange(idx.size)):
        return traffic
    j = torch.as_tensor(idx, device=traffic.length.device)
    return traffic._replace(**{f: getattr(traffic, f).index_select(0, j)
                               for f in Traffic._fields[:6]})


def _dealt(order: np.ndarray, cfg: NocConfig, traffic: Traffic,
           mc_rows: np.ndarray, **kw) -> List[SimResult]:
    """``simulate_batch`` of the lanes taken in ``order`` (dealt over the
    device shards), its results put back in lane order."""
    res = simulate_batch(cfg, _take_lanes(traffic, order),
                         mc_nodes=mc_rows[order], **kw)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    return [res[i] for i in inv]


def _resolve_devices(devices, dev: torch.device):
    """``"auto"`` -> every visible CUDA device when the grid's device is
    CUDA and there are two or more, else None; a device sequence or a 1-D
    mesh -> its devices, in shard order."""
    if isinstance(devices, str):
        if devices != "auto":
            raise ValueError(f"devices must be 'auto', None, or a device "
                             f"sequence, got {devices!r}")
        n = torch.cuda.device_count() if dev.type == "cuda" else 0
        return [torch.device("cuda", i) for i in range(n)] if n > 1 else None
    return None if devices is None else _lane_devices(devices)


def run_sweep(grid: SweepGrid, layers_for_model: LayersFn, *,
              out_path: Optional[str] = None,
              check_conservation: bool = False,
              devices="auto") -> SweepReport:
    """Execute every cell of ``grid``: one packetization per (mesh,
    placement, affinity, model, compression) combo and ONE batched request
    drain per (mesh, model, compression) over every combo's lanes; with
    ``grid.result_phase`` one more batched drain of every combo's PE->MC
    result traffic. One row per (mesh, placement, affinity, model,
    compression, precision, tiebreak, transform), in the reference's row
    order and with its keys.

    ``check_conservation``: every drain runs with the packet ledger and
    raises ``RuntimeError`` if a packet id does not eject exactly once;
    the ledger runs on the plain step (``stats["step"]`` says which step
    drained), and the rows are the same as without it.

    Each stage runs in a ``torch.profiler`` span (``run_sweep/packetize``,
    ``/drain``, ``/result_packetize``, ``/result_drain``), the device
    synchronised before it ends: a profiler window over the call reads
    each stage's device idle share; with no profiler the spans cost
    nothing measurable.

    ``devices``: the devices both batched drains deal their lanes over
    (``sim.simulate_batch(devices=)``; a device may repeat): ``"auto"``,
    the default, takes every visible CUDA device when ``grid.device`` is
    CUDA and there are two or more, else drains on ``grid.device`` alone,
    as ``None`` does. Lanes are dealt by their drain estimate, so no shard
    holds only the congested lanes; ``stats["devices"]`` counts the shards
    and the rows are the single-device drain's.

    ``out_path`` writes ``{"grid", "rows", "stats"}`` as JSON: the
    reference's keys and values, and ``grid["device"]`` beside them."""
    dev = resolve_device(grid.device)
    devs = _resolve_devices(devices, dev)
    ndev = len(devs) if devs else 1
    step = _resolve_backend(grid.backend, dev, check_conservation)
    axes = grid.variant_axes()
    variants = [(by_name(tr, tiebreak=tb), _QUANTIZERS[prec])
                for prec, tb, tr in axes]
    streamed = grid.max_packets_per_layer is None
    rw = (grid.result_window if grid.result_window is not None
          else DEFAULT_RESULT_WINDOW)
    rows: List[dict] = []
    classes = []
    pack_s = sim_s = res_pack_s = res_s = 0.0
    pack_by_tr: Dict[str, float] = {}
    stepped_cycles = result_cycles = 0
    all_drained = True
    layer_cache: Dict[str, Sequence[LayerTraffic]] = {}
    ordered_cache: Dict[tuple, list] = {}
    payload_cache: Dict[tuple, list] = {}
    shape_cache: Dict[tuple, list] = {}
    # Result values depend only on (model, variants): computed once.
    rvalue_cache: Dict[str, list] = {}
    # Escape bits per (model, precision, lanes, compression) and result
    # outlier counts per (model, precision): value-only, shared by every
    # mesh, placement and affinity.
    comp_cache: Dict[tuple, int] = {}
    routlier_cache: Dict[tuple, int] = {}
    # The measured drain schedule per mesh; meshes missing from the table
    # keep the grid's chunk and the half-live compaction.
    tuned = load_tuned(grid.tune_path) if grid.tune_path else {}

    def drain_sched(cfg):
        sched = schedule_for(cfg, tuned)
        return (sched.chunk, sched.compact_ratio) if sched else (grid.chunk,
                                                                  0.5)

    # Meshes of one size share traffic shapes: pad every member of a size
    # group to the group's MC-stream count and stream length, as the
    # reference does (padding streams are empty and never inject).
    resolved = [_resolve_mesh(m) for m in grid.meshes]
    size_groups: Dict[tuple, List[NocConfig]] = {}
    for _, cfg in resolved:
        key = (cfg.rows, cfg.cols, cfg.num_vcs, cfg.vc_depth, cfg.lanes)
        size_groups.setdefault(key, []).append(cfg)
    nv = len(variants)

    def table(cfg, aff):
        return affinity_mc_table(cfg) if aff == "nearest" else None

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    drain_kw = dict(count_headers=grid.count_headers,
                    max_cycles=grid.max_cycles,
                    check_conservation=check_conservation,
                    backend=grid.backend,
                    **(dict(devices=devs) if devs else dict(device=dev)))

    for mesh_name, base_cfg in resolved:
        # Compression is an extra shape class per (mesh, model): MSR changes
        # every packet's flit count, so none and msr never share a drain.
        for model, comp in [(m, c) for m in grid.models
                            for c in grid.compression]:
            if model not in layer_cache:
                layer_cache[model] = layers_for_model(model)
            layers = layer_cache[model]

            t0 = time.perf_counter()
            with record_function("run_sweep/packetize"):
                pkey = (model, base_cfg.lanes, comp)
                if pkey not in shape_cache:
                    if streamed:
                        shape_cache[pkey] = payload_shapes(
                            layers, base_cfg.lanes, variants,
                            max_packets_per_layer=grid.max_packets_per_layer,
                            compression=comp, device=dev)
                    else:
                        payload_cache[pkey] = cached_ordered_payloads(
                            ordered_cache, model, layers, base_cfg.lanes,
                            variants, axes,
                            max_packets_per_layer=grid.max_packets_per_layer,
                            timings=pack_by_tr, compression=comp, device=dev)
                        shape_cache[pkey] = [(w.shape[1], w.shape[2])
                                             for w in payload_cache[pkey]]
                group = size_groups[(base_cfg.rows, base_cfg.cols,
                                     base_cfg.num_vcs, base_cfg.vc_depth,
                                     base_cfg.lanes)]
                shapes = shape_cache[pkey]
                npackets = sum(n for n, _ in shapes)
                mc_pad = max(c.num_mcs for c in group)

                # Every placement x affinity combo drains in ONE batched call:
                # the combos share traffic shapes (padded below) and differ in
                # their per-lane mc_nodes and per-MC stream split.
                placed = [(pl, aff, _place(base_cfg, pl))
                          for pl in grid.placements for aff in grid.affinity]
                tables = [table(cfg, aff) for _, aff, cfg in placed]
                lens = [stream_lengths(shapes, cfg.num_mcs, tbl)
                        for (_, _, cfg), tbl in zip(placed, tables)]
                # The common stream length covers every combo of every member
                # of the size group.
                t_pad = max(
                    [int(ln.max()) for ln in lens]
                    + [int(stream_lengths(shapes, gcfg.num_mcs,
                                          table(gcfg, aff)).max())
                       for c in group if c is not base_cfg
                       for pl in grid.placements for aff in grid.affinity
                       for gcfg in (_place(c, pl),)])
                if streamed:
                    # One ordering pass feeds every combo's assembler.
                    combo_traffics = build_traffic_streamed_multi(
                        layers, [cfg for _, _, cfg in placed], variants,
                        chunk_packets=grid.stream_chunk_packets,
                        num_streams=mc_pad, shapes=shapes, mc_tables=tables,
                        compression=comp, device=dev, timings=pack_by_tr)
                else:
                    combo_traffics = [
                        assemble_traffic(payload_cache[pkey], cfg,
                                         num_streams=mc_pad, num_variants=nv,
                                         device=dev, mc_table=tbl)
                        for (_, _, cfg), tbl in zip(placed, tables)]
                traffic = _concat_lanes([pad_traffic_length(t, t_pad)
                                         for t in combo_traffics])
                del combo_traffics
                mc_rows = _node_rows([cfg.mc_nodes for _, _, cfg in placed],
                                     mc_pad, nv)
                sync()
                # Deal estimate-sorted lanes across the device shards so no
                # shard holds only congested lanes.
                ests = [drain_estimate(cfg, ln)
                        for (_, _, cfg), ln in zip(placed, lens)]
                order = _deal_order(np.repeat(ests, nv), ndev)
            t1 = time.perf_counter()
            d_chunk, d_ratio = drain_sched(base_cfg)
            with record_function("run_sweep/drain"):
                results = _dealt(order, base_cfg, traffic, mc_rows,
                                 chunk=d_chunk, compact_ratio=d_ratio,
                                 **drain_kw)
            t2 = time.perf_counter()
            del traffic

            # Result phase: one PE->MC drain covering every combo's lanes.
            # Streams inject at the PEs (per-lane mc_nodes = pe_nodes, padded
            # with router 0 to the size group's PE count) and eject at the
            # MCs.
            rres: Optional[List[SimResult]] = None
            t2b = t2
            if grid.result_phase:
                with record_function("run_sweep/result_packetize"):
                    if model not in rvalue_cache:
                        rvalue_cache[model] = result_values(
                            layers, variants,
                            max_packets_per_layer=grid.max_packets_per_layer,
                            device=dev)
                    pe_pad = max(c.num_routers - c.num_mcs for c in group)
                    rparts = [build_result_traffic(
                        layers, cfg, variants,
                        max_packets_per_layer=grid.max_packets_per_layer,
                        mc_table=tbl, result_window=grid.result_window,
                        num_streams=pe_pad, values=rvalue_cache[model],
                        compression=comp, device=dev)
                        for (_, _, cfg), tbl in zip(placed, tables)]
                    rnpkts = [int(p.num_packets) for p in rparts]
                    rt_pad = max(int(p.words.shape[-2]) for p in rparts)
                    # The longest PE stream floors a result drain: its
                    # lanes are dealt by that injection bound.
                    rorder = _deal_order(np.repeat(
                        [int(p.length.max()) if p.length.numel() else 0
                         for p in rparts], nv), ndev)
                    rtraffic = _concat_lanes([pad_traffic_length(p, rt_pad)
                                              for p in rparts])
                    del rparts
                    pe_rows = _node_rows(
                        [cfg.pe_nodes for _, _, cfg in placed], pe_pad, nv)
                    sync()
                t2b = time.perf_counter()
                with record_function("run_sweep/result_drain"):
                    rres = _dealt(rorder, base_cfg, rtraffic, pe_rows,
                                  chunk=d_chunk, compact_ratio=d_ratio,
                                  **drain_kw)
                del rtraffic
            t3 = time.perf_counter()

            pack_s += t1 - t0
            sim_s += t2 - t1
            res_pack_s += t2b - t2
            res_s += t3 - t2b
            all_drained &= all(r.ejected == r.injected
                               for r in results + (rres or []))
            class_cycles = sum(r.cycles for r in results)
            stepped_cycles += class_cycles
            entry = {
                "mesh": mesh_name, "placements": list(grid.placements),
                "affinity": list(grid.affinity), "model": model,
                "compression": comp, "variants": len(results),
                "packetize_s": round(t1 - t0, 4),
                "simulate_s": round(t2 - t1, 4),
                "cycles_per_sec": round(class_cycles / (t2 - t1), 1)
                if t2 > t1 else None,
                "drain_estimate": ests,
            }
            if rres is not None:
                rc = sum(r.cycles for r in rres)
                result_cycles += rc
                entry["result_packetize_s"] = round(t2b - t2, 4)
                entry["result_simulate_s"] = round(t3 - t2b, 4)
                entry["result_cycles_per_sec"] = (
                    round(rc / (t3 - t2b), 1) if t3 > t2b else None)
            classes.append(entry)

            for pi, (placement, aff, cfg) in enumerate(placed):
                cell = results[pi * nv:(pi + 1) * nv]
                rcell = rres[pi * nv:(pi + 1) * nv] if rres else [None] * nv
                mean_hops = packet_mean_hops(cfg, npackets, tables[pi])
                base_bt = {}
                base_rbt = {}
                for (prec, tb, tr), res, rr in zip(axes, cell, rcell):
                    if tr == grid.baseline:
                        base_bt[(prec, tb)] = res.total_bt
                        base_rbt[(prec, tb)] = rr.total_bt if rr else None
                for (prec, tb, tr), (transform, _), res, rr in zip(
                        axes, variants, cell, rcell):
                    overhead = recovery_overhead_bits(
                        layers, transform,
                        max_packets_per_layer=grid.max_packets_per_layer)
                    # MSR escape bits: outlier status is a property of the
                    # value, so the charge is the same for every transform.
                    ckey = (model, prec, base_cfg.lanes, comp)
                    if ckey not in comp_cache:
                        comp_cache[ckey] = compression_overhead(
                            layers, _QUANTIZERS[prec], base_cfg.lanes, comp,
                            max_packets_per_layer=grid.max_packets_per_layer,
                            device=dev)
                    comp_overhead = comp_cache[ckey]
                    # Each recovery-index and escape bit costs half a
                    # transition (the toggle expectation of an
                    # uninformative bit stream).
                    adjusted_bt = (res.total_bt + overhead // 2
                                   + comp_overhead // 2)
                    base = base_bt[(prec, tb)]
                    if rr:
                        # The result phase is a single stream: any
                        # non-identity reorder (O1 included) owes a window
                        # index per value, one value per request packet.
                        roverhead = (npackets
                                     * transform.overhead_bits_per_value(
                                         min(rw, npackets), paired=False))
                        rcomp = 0
                        if comp == "msr":
                            rokey = (model, prec)
                            if rokey not in routlier_cache:
                                vi = axes.index((prec, tb, tr))
                                routlier_cache[rokey] = sum(
                                    int(msr.outlier_mask(lay[vi]).sum())
                                    for lay in rvalue_cache[model])
                            # Result packets pad to lane-rounded slots: the
                            # escape window is the padded slot count.
                            rslots = -(-rw // base_cfg.lanes) * base_cfg.lanes
                            rcomp = msr.msr_stream_overhead_bits(
                                rslots, rnpkts[pi], routlier_cache[rokey])
                        radj = rr.total_bt + roverhead // 2 + rcomp // 2
                        rbase = base_rbt[(prec, tb)]
                    rows.append({
                        "mesh": mesh_name, "placement": placement,
                        "affinity": aff, "model": model,
                        "precision": prec, "transform": tr, "tiebreak": tb,
                        "compression": comp,
                        "total_bt": res.total_bt,
                        "adjusted_bt": adjusted_bt,
                        "overhead_bits": overhead,
                        "compression_overhead_bits": comp_overhead,
                        "cycles": res.drain_cycle,
                        "flits": res.injected,
                        "bt_per_flit": res.bt_per_flit,
                        "mean_hops": mean_hops,
                        "reduction_pct": (1 - res.total_bt / base) * 100,
                        "adjusted_reduction_pct": (1 - adjusted_bt / base) * 100,
                        "result_bt": rr.total_bt if rr else None,
                        "result_cycles": rr.drain_cycle if rr else None,
                        "result_flits": rr.injected if rr else None,
                        "result_overhead_bits": roverhead if rr else None,
                        "result_compression_overhead_bits":
                            rcomp if rr else None,
                        "result_adjusted_bt": radj if rr else None,
                        "result_adjusted_reduction_pct": (
                            (1 - radj / rbase) * 100 if rr else None),
                    })

    stats = {
        "cells": len(rows),
        "shape_classes": classes,
        "packetize_s": round(pack_s, 4),
        "packetize_by_transform": {k: round(v, 4)
                                   for k, v in sorted(pack_by_tr.items())},
        "simulate_s": round(sim_s, 4),
        "wall_s": round(pack_s + sim_s + res_pack_s + res_s, 4),
        "stepped_cycles": stepped_cycles,
        "cycles_per_sec": round(stepped_cycles / sim_s, 1) if sim_s else None,
        "streamed": streamed,
        "devices": ndev,
        "result_phase": grid.result_phase,
        "device": str(dev),
        "step": step,
        "conservation_checked": bool(check_conservation),
        "ejected_equals_injected": all_drained,
    }
    if grid.result_phase:
        stats["result_packetize_s"] = round(res_pack_s, 4)
        stats["result_simulate_s"] = round(res_s, 4)
        stats["result_cycles"] = result_cycles
        stats["result_cycles_per_sec"] = (
            round(result_cycles / res_s, 1) if res_s else None)
    report = SweepReport(rows=rows, stats=stats)
    if out_path:
        _write_json(out_path, grid, report)
    return report


def _grid_json(grid: SweepGrid) -> dict:
    out = dataclasses.asdict(grid)
    out["meshes"] = [_resolve_mesh(m)[0] for m in grid.meshes]
    for key in ("placements", "affinity", "transforms", "tiebreaks",
                "precisions", "models", "compression", "offered_loads"):
        out[key] = list(out[key])
    return out


def _write_json(out_path: str, grid: SweepGrid,
                report: SweepReport) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"grid": _grid_json(grid), "rows": report.rows,
                   "stats": report.stats}, f, indent=1)


def _serving_drain(task):
    """One closed-loop drain of :func:`run_serving` (a process-pool task:
    its traffic comes on the CPU and moves to ``kw["device"]``)."""
    cfg, req, res, kw = task
    return simulate_online(cfg, req, res, **kw)


def _one_torch_thread() -> None:
    torch.set_num_threads(1)


def _serving_processes(dev: torch.device, n_tasks: int) -> int:
    """How many processes :func:`run_serving`'s closed-loop drains run in.
    On the card the gated step is bound by the host's launches (the device
    idles most of each cycle), so the independent drains take one process
    a host core; on the CPU the step is the host's work itself, and they
    run in this process."""
    if dev.type != "cuda":
        return 1
    return max(1, min(n_tasks, len(os.sched_getaffinity(0))))


def _drain_all(tasks: list, processes: int) -> list:
    """``_serving_drain`` of every task, in order: in this process, or in
    ``processes`` spawned ones with one torch thread each (the traffic
    travels as CPU copies: pickling a CPU tensor for the pool moves its
    storage to shared memory, under anything else that reads it). Every
    drain is the one the serial run gives."""
    if processes == 1:
        return [_serving_drain(t) for t in tasks]
    tasks = [(cfg, *(Traffic(*(x.to("cpu", copy=True) for x in t[:6]),
                             num_packets=t.num_packets) for t in (req, res)),
              kw) for cfg, req, res, kw in tasks]
    with ProcessPoolExecutor(
            processes, mp_context=multiprocessing.get_context("spawn"),
            initializer=_one_torch_thread) as ex:
        return list(ex.map(_serving_drain, tasks))


def run_serving(grid: SweepGrid, layers_for_model: LayersFn, *,
                out_path: Optional[str] = None,
                check_conservation: bool = False,
                devices="auto") -> SweepReport:
    """The closed-loop ``serving`` suite: the BT sweep joined with an
    offered-load latency sweep (the port of
    ``repro.noc.sweep.run_serving``).

    Runs :func:`run_sweep` (result phase forced on) for the per-transform
    BT rows, then one gated closed-loop drain
    (:func:`repro_torch.noc.online.simulate_online`) of the baseline
    transform's traffic per (mesh, placement, affinity, model) combo,
    offered load and fault rate, and a back-to-back saturation probe per
    combo. Timing never reads payload values, so the load axis is priced
    once per combo and every transform joins it by its BT.

    ``stats["serving"]`` holds the reference's ``points`` (latency
    percentiles, throughput, completed / truncated counts, gated drain
    cycles; with the degradation axes also fault_rate, slo_attainment,
    goodput, shed, failed), ``combos`` (``saturation_tput``,
    ``latency_monotone`` over the unshed points at the lowest fault rate,
    ``slo_monotone_in_fault`` with faults and a deadline, the BT join
    ``transforms``) and ``serving_s``; the port adds ``stepped_cycles``,
    the gated cycles every serving drain stepped (the saturation probes
    and aborted admission replays included), and ``workers``, the
    processes the closed-loop drains ran in: one on the CPU, and on the
    card one a host core, up to one a drain (the gated step is bound by
    the host's launches there).

    devices: passed on to :func:`run_sweep`'s batched drains; the
        closed-loop drains run on ``grid.device``, as the reference runs
        them on one device.
    """
    if not grid.offered_loads:
        raise ValueError("run_serving needs grid.offered_loads (offered "
                         "load points in inferences per 1000 cycles)")
    if grid.max_packets_per_layer is None:
        raise ValueError("run_serving uses the one-shot packetizer; set "
                         "max_packets_per_layer")
    if set(grid.compression) != {"none"}:
        raise ValueError(
            "run_serving prices drain timing once per combo on the O0 "
            "baseline packetization; the compression axis changes flit "
            "geometry per scheme, so serving grids must keep "
            "compression=('none',) (BT-only compression rows come from "
            "run_sweep)")
    base = (grid if grid.result_phase
            else dataclasses.replace(grid, result_phase=True))
    report = run_sweep(base, layers_for_model,
                       check_conservation=check_conservation,
                       devices=devices)

    dev = resolve_device(grid.device)
    t0 = time.perf_counter()
    o0 = [(by_name(grid.baseline), _QUANTIZERS[grid.precisions[0]])]
    prec0, tb0 = grid.precisions[0], grid.tiebreaks[0]
    loads = sorted(grid.offered_loads)
    frates = sorted(set(grid.fault_rates))
    fault_axis = bool(frates)
    if not frates:
        frates = [0.0]
    dead = tuple(tuple(int(x) for x in d) for d in grid.fault_dead_links)
    degradation = (fault_axis or bool(dead) or grid.deadline is not None
                   or grid.admit_queue_depth is not None)

    def _fault_model(rate: float):
        # Rate 0 with no dead links is the clean gated drain (no faults).
        if rate == 0.0 and not dead:
            return None
        from .faults import FaultModel
        return FaultModel(rate=rate, seed=grid.fault_seed,
                          protect=grid.fault_protect, dead_links=dead,
                          max_retries=grid.fault_max_retries,
                          ack_latency=grid.fault_ack_latency)

    online_kw = dict(num_inferences=grid.serving_inferences,
                     compute_latency=grid.compute_latency,
                     count_headers=grid.count_headers, chunk=grid.chunk,
                     max_cycles=grid.max_cycles,
                     check_conservation=check_conservation, record_bt=False,
                     device=str(dev))
    # Every combo's traffic, then its drains: one a (load, rate) point and
    # the back-to-back probe last.
    combo_keys, tasks = [], []
    layer_cache: Dict[str, Sequence[LayerTraffic]] = {}
    for mesh_name, base_cfg in [_resolve_mesh(m) for m in grid.meshes]:
        for model in grid.models:
            if model not in layer_cache:
                layer_cache[model] = layers_for_model(model)
            layers = layer_cache[model]
            for pl in grid.placements:
                for aff in grid.affinity:
                    cfg = _place(base_cfg, pl)
                    tbl = (affinity_mc_table(cfg) if aff == "nearest"
                           else None)
                    req = build_traffic_batch(
                        layers, cfg, o0,
                        max_packets_per_layer=grid.max_packets_per_layer,
                        mc_table=tbl, device=dev).variant(0)
                    res = build_result_traffic(
                        layers, cfg, o0,
                        max_packets_per_layer=grid.max_packets_per_layer,
                        mc_table=tbl, result_window=grid.result_window,
                        device=dev).variant(0)
                    combo_keys.append({"mesh": mesh_name, "placement": pl,
                                       "affinity": aff, "model": model})
                    tasks += [(cfg, req, res, dict(
                        online_kw, arrivals=ArrivalProcess(
                            grid.arrival, load, grid.arrival_seed),
                        faults=_fault_model(rate), deadline=grid.deadline,
                        admit_queue_depth=grid.admit_queue_depth))
                        for load in loads for rate in frates]
                    tasks.append((cfg, req, res, dict(
                        online_kw, arrivals=ArrivalProcess("backtoback"))))
    workers = _serving_processes(dev, len(tasks))
    drains = _drain_all(tasks, workers)

    points: List[dict] = []
    combos: List[dict] = []
    stepped = sum(onl.stepped_cycles for onl in drains)
    per_combo = len(loads) * len(frates) + 1
    for ci, combo_key in enumerate(combo_keys):
        runs = iter(drains[ci * per_combo:(ci + 1) * per_combo])
        combo_p50 = []
        slo_by_load: Dict[float, List] = {}
        for load in loads:
            for rate in frates:
                onl = next(runs)
                lp = latency_percentiles(onl.latencies)
                # p50 is non-decreasing in offered load only while every
                # inference is admitted: shedding caps queueing, so shed
                # points stay out of the monotonicity verdict.
                if rate == frates[0] and not onl.num_shed:
                    combo_p50.append(lp["p50"])
                point = {
                    **combo_key, "offered_load": load,
                    "throughput": onl.throughput,
                    "p50_latency": lp["p50"],
                    "p99_latency": lp["p99"],
                    "mean_latency": lp["mean"],
                    "completed": lp["count"],
                    "truncated": lp["truncated"],
                    "request_drain_cycle": onl.request_drain_cycle,
                    "result_drain_cycle": onl.result_drain_cycle,
                }
                if degradation:
                    point.update({
                        "fault_rate": rate,
                        "deadline": grid.deadline,
                        "slo_attainment": onl.slo_attainment,
                        "goodput": onl.goodput,
                        "shed": onl.num_shed,
                        "failed": onl.num_failed,
                    })
                    slo_by_load.setdefault(load, []).append(
                        onl.slo_attainment)
                points.append(point)
        sat = next(runs)
        transforms = {}
        for tr in grid.transforms:
            row = report.row(**combo_key, transform=tr, precision=prec0,
                             tiebreak=tb0)
            transforms[tr] = {
                "request_bt": row["total_bt"],
                "request_adjusted_bt": row["adjusted_bt"],
                "result_bt": row["result_bt"],
                "result_adjusted_bt": row["result_adjusted_bt"],
                "adjusted_reduction_pct": row["adjusted_reduction_pct"],
            }
        combo = {
            **combo_key,
            "saturation_tput": sat.throughput,
            "latency_monotone": all(
                b >= a for a, b in zip(combo_p50, combo_p50[1:])
                if a is not None and b is not None),
            "transforms": transforms,
        }
        if fault_axis and grid.deadline is not None:
            # SLO attainment non-increasing along the sorted fault-rate
            # axis at every load (flip schedules are nested in rate).
            combo["slo_monotone_in_fault"] = all(
                a >= b for curve in slo_by_load.values()
                for a, b in zip(curve, curve[1:])
                if a is not None and b is not None)
        combos.append(combo)
    report.stats["serving"] = {
        "offered_loads": loads,
        "inferences": grid.serving_inferences,
        "compute_latency": grid.compute_latency,
        "arrival": grid.arrival,
        "arrival_seed": grid.arrival_seed,
        "precision": prec0, "tiebreak": tb0,
        "conservation_checked": bool(check_conservation),
        "fault_rates": frates if fault_axis else [],
        "fault_protect": grid.fault_protect if degradation else None,
        "fault_dead_links": [list(d) for d in dead],
        "deadline": grid.deadline,
        "admit_queue_depth": grid.admit_queue_depth,
        "points": points,
        "combos": combos,
        "serving_s": round(time.perf_counter() - t0, 4),
        "stepped_cycles": stepped,
        "workers": workers,
    }
    if out_path:
        _write_json(out_path, grid, report)
    return report
