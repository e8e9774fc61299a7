"""Plain reference of a sweep's rows.

For a grid (meshes x MC placements x packet->MC affinities x precisions x
tiebreaks x transforms x compressions, and the optional result phase) and
one inference's per-layer (inputs, weights) operand rows, the rows a sweep
reports: raw and adjusted BT, drain cycles, flits, BT a flit, mean hops,
the reductions against the O0 baseline and the result phase's columns.
Every lane of one mesh geometry drains in one batched reference drain.
Nothing here imports the program.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import ordering as od
from . import packets as pk
from .drain import drain

Layer = Tuple[torch.Tensor, torch.Tensor]


def variant_axes(grid: dict) -> List[tuple]:
    """(precision, tiebreak, transform) in the sweep's batch order."""
    return [(prec, tb, tr) for prec in grid["precisions"]
            for tb in grid["tiebreaks"] for tr in grid["transforms"]]


def _quantized(layers: Sequence[Layer], prec: str, maxp):
    q = od.QUANTIZERS[prec]
    out = []
    for inp, wgt in layers:
        inp, wgt = od.subsample(inp, wgt, maxp)
        out.append((inp, wgt) if q is None else (q(inp), q(wgt)))
    return out


def _recovery_bits(layers: Sequence[Layer], tr: str, maxp) -> int:
    total = 0
    for inp, _ in layers:
        n, k = int(inp.shape[0]), int(inp.shape[1])
        if maxp is not None and n > maxp:
            n = maxp
        total += n * k * od.overhead_bits_per_value(tr, k)
    return total


def _escape_bits(qlayers, lanes: int) -> int:
    half = lanes // 2
    total = 0
    for inp, wgt in qlayers:
        if inp.shape[0] == 0:
            continue
        window = -(-int(inp.shape[1]) // half) * half
        total += od.escape_bits(inp, window) + od.escape_bits(wgt, window)
    return total


# A sweep's defaults for the fields a grid leaves out.
DEFAULTS = dict(meshes=["4x4_mc2"], placements=["edge"],
                affinity=["roundrobin"], transforms=["O0", "O1", "O2"],
                tiebreaks=["pattern"], precisions=["float32", "fixed8"],
                compression=["none"], max_packets_per_layer=40,
                result_phase=False, result_window=None, baseline="O0",
                count_headers=True)


def reference_rows(grid: dict, layers: Sequence[Layer]) -> List[dict]:
    """The rows of ``grid`` (the traffic file's sweep fields) for one
    inference's operand rows ``layers``, keyed as the sweep keys them."""
    grid = {**DEFAULTS, **grid}
    if not grid.get("count_headers", True):
        raise ValueError("the reference counts header flits")
    axes = variant_axes(grid)
    nv = len(axes)
    model = grid["models"][0]
    if len(grid["models"]) != 1:
        raise ValueError("one model a cell")
    maxp = grid.get("max_packets_per_layer")
    rw = grid.get("result_window") or pk.RESULT_WINDOW
    baseline = grid.get("baseline", "O0")
    qcache: Dict[str, list] = {}
    pay_cache: Dict[tuple, list] = {}
    ord_cache: Dict[tuple, tuple] = {}
    res_cache: Dict[str, list] = {}

    def qlayers(prec):
        if prec not in qcache:
            qcache[prec] = _quantized(layers, prec, maxp)
        return qcache[prec]

    def ordered(prec, tb, tr, lanes, li):
        # The chains ignore the tiebreak: one ordering serves both.
        key = (prec, tb if tr in ("O1", "O2") else None, tr, lanes, li)
        if key not in ord_cache:
            ord_cache[key] = od.order_packets(tr, tb, *qlayers(prec)[li],
                                              lanes)
        return ord_cache[key]

    def payloads(lanes, comp):
        key = (lanes, comp)
        if key not in pay_cache:
            pack = (od.pack_paired_rows if comp == "none"
                    else od.msr_pack_paired_rows)
            pay_cache[key] = [torch.stack([
                pack(*ordered(prec, tb, tr, lanes, li), lanes)
                for prec, tb, tr in axes]) for li in range(len(layers))]
        return pay_cache[key]

    def results(prec):
        if prec not in res_cache:
            out = []
            for inp, wgt in layers:
                inp, wgt = od.subsample(inp, wgt, maxp)
                r = (inp.to(torch.float32) * wgt.to(torch.float32)).sum(dim=1)
                q = od.QUANTIZERS[prec]
                out.append(r if q is None else q(r))
            res_cache[prec] = out
        return res_cache[prec]

    # Every (mesh, compression, placement, affinity) combo's lanes, grouped
    # by mesh geometry: one request drain and one result drain a group.
    combos = []
    for mesh_name in grid["meshes"]:
        for comp in grid["compression"]:
            for pl in grid["placements"]:
                for aff in grid["affinity"]:
                    cfg = pk.mesh(mesh_name, pl)
                    tbl = pk.affinity_table(cfg) if aff == "nearest" else None
                    combos.append((mesh_name, comp, pl, aff, cfg, tbl))
    req_parts: Dict[tuple, list] = {}
    res_parts: Dict[tuple, list] = {}
    for ci, (_, comp, _, _, cfg, tbl) in enumerate(combos):
        req_parts.setdefault(cfg.geometry, []).append(
            (ci, pk.request_streams(payloads(cfg.lanes, comp), cfg, tbl)))
        if grid.get("result_phase"):
            per_layer = results_by_variant(axes, results, len(layers))
            res_parts.setdefault(cfg.geometry, []).append(
                (ci, pk.result_streams(per_layer, cfg,
                                       [(tr, tb) for _, tb, tr in axes],
                                       tbl, rw, comp)))
    req = _drain_groups(req_parts, nv)
    res = _drain_groups(res_parts, nv) if grid.get("result_phase") else {}

    rows = []
    npackets = sum(min(int(i.shape[0]), maxp) if maxp is not None
                   else int(i.shape[0]) for i, _ in layers)
    rout: Dict[str, int] = {}
    for ci, (mesh_name, comp, pl, aff, cfg, tbl) in enumerate(combos):
        hops = pk.mean_hops(cfg, npackets, tbl)
        cell = req[ci]
        rcell = res.get(ci, [None] * nv)
        base = {(prec, tb): d.total_bt for (prec, tb, tr), d in
                zip(axes, cell) if tr == baseline}
        rbase = {(prec, tb): (d.total_bt if d else None) for (prec, tb, tr), d
                 in zip(axes, rcell) if tr == baseline}
        for (prec, tb, tr), d, rd in zip(axes, cell, rcell):
            overhead = _recovery_bits(layers, tr, maxp)
            comp_bits = (_escape_bits(qlayers(prec), cfg.lanes)
                         if comp == "msr" else 0)
            adjusted = d.total_bt + overhead // 2 + comp_bits // 2
            b0 = base[(prec, tb)]
            row = {
                "mesh": mesh_name, "placement": pl, "affinity": aff,
                "model": model, "precision": prec, "transform": tr,
                "tiebreak": tb, "compression": comp,
                "total_bt": d.total_bt, "adjusted_bt": adjusted,
                "overhead_bits": overhead,
                "compression_overhead_bits": comp_bits,
                "cycles": d.cycles, "flits": d.flits,
                "bt_per_flit": d.total_bt / max(d.link_flits, 1),
                "mean_hops": hops,
                "reduction_pct": (1 - d.total_bt / b0) * 100,
                "adjusted_reduction_pct": (1 - adjusted / b0) * 100,
                "result_bt": None, "result_cycles": None,
                "result_flits": None, "result_overhead_bits": None,
                "result_compression_overhead_bits": None,
                "result_adjusted_bt": None,
                "result_adjusted_reduction_pct": None,
            }
            if rd is not None:
                roverhead = npackets * od.overhead_bits_per_value(
                    tr, min(rw, npackets), paired=False)
                rcomp = 0
                if comp == "msr":
                    if prec not in rout:
                        rout[prec] = sum(int(od.outlier_mask(v).sum())
                                         for v in results(prec))
                    slots = -(-rw // cfg.lanes) * cfg.lanes
                    rcomp = od.msr_stream_overhead_bits(
                        slots, result_packets(layers, cfg, tbl, rw, maxp),
                        rout[prec])
                radj = rd.total_bt + roverhead // 2 + rcomp // 2
                row.update({
                    "result_bt": rd.total_bt, "result_cycles": rd.cycles,
                    "result_flits": rd.flits,
                    "result_overhead_bits": roverhead,
                    "result_compression_overhead_bits": rcomp,
                    "result_adjusted_bt": radj,
                    "result_adjusted_reduction_pct":
                        (1 - radj / rbase[(prec, tb)]) * 100,
                })
            rows.append(row)
    return rows


def results_by_variant(axes, results, nlayers: int):
    """``values[layer][variant]``: each variant's precision's results."""
    per_prec = {prec: results(prec) for prec, _, _ in axes}
    return [[per_prec[prec][li] for prec, _, _ in axes]
            for li in range(nlayers)]


def result_packets(layers: Sequence[Layer], cfg: pk.Mesh, tbl, rw: int,
                   maxp) -> int:
    """Result packets: per layer, per (PE, MC) pair, ceil(results / rw)."""
    m, p = cfg.num_mcs, len(cfg.pe_nodes)
    sched = pk._Schedule(m, tbl)
    total, g0 = 0, 0
    for inp, _ in layers:
        n = int(inp.shape[0]) if maxp is None else min(int(inp.shape[0]),
                                                       maxp)
        g = g0 + np.arange(n, dtype=np.int64)
        g0 += n
        _, counts = np.unique(g % p * m + sched.mc(g), return_counts=True)
        total += int((-(-counts // rw)).sum())
    return total


def _drain_groups(parts: Dict[tuple, list], nv: int) -> Dict[int, list]:
    """Drain each geometry's combos as one batch -> combo -> lane results
    in variant order."""
    out = {}
    for geo, items in parts.items():
        got = drain(geo, pk.concat([s for _, s in items]))
        for k, (ci, _) in enumerate(items):
            out[ci] = got[k * nv:(k + 1) * nv]
    return out


# The columns compared, and those that do not depend on the image.
COLUMNS = ("total_bt", "adjusted_bt", "overhead_bits",
           "compression_overhead_bits", "cycles", "flits", "bt_per_flit",
           "mean_hops", "reduction_pct", "adjusted_reduction_pct",
           "result_bt", "result_cycles", "result_flits",
           "result_overhead_bits", "result_compression_overhead_bits",
           "result_adjusted_bt", "result_adjusted_reduction_pct")
SHAPE_COLUMNS = ("overhead_bits", "cycles", "flits", "mean_hops",
                 "result_cycles", "result_flits", "result_overhead_bits")
KEY = ("mesh", "placement", "affinity", "model", "compression", "precision",
       "tiebreak", "transform")


def row_key(row: dict) -> tuple:
    return tuple(row[k] for k in KEY)


def mismatches(got: Sequence[dict], want: Sequence[dict],
               columns: Sequence[str] = COLUMNS) -> List[str]:
    """Every (row, column) where ``got`` differs from ``want``, exactly, and
    every row one side lacks."""
    gmap = {row_key(r): r for r in got}
    wmap = {row_key(r): r for r in want}
    out = [f"{k}: missing" for k in wmap if k not in gmap]
    out += [f"{k}: unexpected" for k in gmap if k not in wmap]
    if len(gmap) != len(got):
        out.append("duplicate row keys")
    for k, w in wmap.items():
        g = gmap.get(k)
        if g is None:
            continue
        for c in columns:
            if g.get(c) != w[c]:
                out.append(f"{k}.{c}: {g.get(c)!r} != {w[c]!r}")
    return out
