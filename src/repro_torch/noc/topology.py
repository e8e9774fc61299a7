"""2D-mesh NoC topology: coordinates, X-Y routing, MC placement.

The port's copy of ``repro.noc.topology`` (host-side metadata, numpy). The
paper's evaluated configurations (Sec. V-B) are a 4x4 mesh with 2 memory
controllers and 8x8 meshes with 4 or 8 MCs, dimension-ordered X-Y routing.

Port numbering (inputs and outputs symmetric):
    0=N  1=E  2=S  3=W  4=Local (input side: injection from the MC/PE NI;
                                 output side: ejection to the PE)

MC placements (``edge``/``corner``/``interleaved``) and the packet->MC
affinity tables are the reference's, copied, and so is the fault routing:
the alive-channel mask and the detour table around dead links and routers
(a host-side BFS, as in the reference).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["NocConfig", "PORT_N", "PORT_E", "PORT_S", "PORT_W", "PORT_LOCAL",
           "NUM_PORTS", "OPPOSITE", "xy_route", "neighbor_table", "PAPER_NOCS",
           "PLACEMENTS", "AFFINITIES", "mc_placement", "make_noc",
           "mesh_by_name", "mean_hop_counts", "xy_link_loads",
           "affinity_mc_table", "packet_mean_hops", "alive_link_mask",
           "fault_route_table"]

PORT_N, PORT_E, PORT_S, PORT_W, PORT_LOCAL = 0, 1, 2, 3, 4
NUM_PORTS = 5
# The flit leaving out-port p of a router enters in-port OPPOSITE[p] of the
# neighbor: N<->S, E<->W.
OPPOSITE = np.array([PORT_S, PORT_W, PORT_N, PORT_E, PORT_LOCAL])


@dataclasses.dataclass(frozen=True)
class NocConfig:
    """Static NoC parameters (paper defaults: 4 VCs x 4-flit buffers)."""

    rows: int
    cols: int
    mc_nodes: Tuple[int, ...]      # router ids hosting memory controllers
    num_vcs: int = 4
    vc_depth: int = 4
    lanes: int = 16                # values per flit (512b/f32, 128b/fx8)

    @property
    def num_routers(self) -> int:
        return self.rows * self.cols

    @property
    def num_mcs(self) -> int:
        return len(self.mc_nodes)

    @property
    def pe_nodes(self) -> Tuple[int, ...]:
        return tuple(r for r in range(self.num_routers) if r not in self.mc_nodes)

    @property
    def num_inter_router_links(self) -> int:
        """Bidirectional inter-router links (112 for the paper's 8x8)."""
        return self.rows * (self.cols - 1) + self.cols * (self.rows - 1)

    def coords(self, node: int) -> Tuple[int, int]:
        return divmod(node, self.cols)

    def node(self, r: int, c: int) -> int:
        return r * self.cols + c


def xy_route(cfg: NocConfig) -> torch.Tensor:
    """X-Y routing table: ``out_port[router, dest]`` (int32)."""
    nr = cfg.num_routers
    table = np.zeros((nr, nr), dtype=np.int32)
    for cur in range(nr):
        r, c = divmod(cur, cfg.cols)
        for dst in range(nr):
            dr, dc = divmod(dst, cfg.cols)
            if dc > c:
                table[cur, dst] = PORT_E
            elif dc < c:
                table[cur, dst] = PORT_W
            elif dr > r:
                table[cur, dst] = PORT_S
            elif dr < r:
                table[cur, dst] = PORT_N
            else:
                table[cur, dst] = PORT_LOCAL
    return torch.from_numpy(table)


def neighbor_table(cfg: NocConfig) -> torch.Tensor:
    """``neighbor[router, out_port]`` -> downstream router id, -1 at the
    mesh edge (int32)."""
    nr = cfg.num_routers
    nb = -np.ones((nr, NUM_PORTS), dtype=np.int32)
    for cur in range(nr):
        r, c = divmod(cur, cfg.cols)
        if r > 0:
            nb[cur, PORT_N] = cfg.node(r - 1, c)
        if c < cfg.cols - 1:
            nb[cur, PORT_E] = cfg.node(r, c + 1)
        if r < cfg.rows - 1:
            nb[cur, PORT_S] = cfg.node(r + 1, c)
        if c > 0:
            nb[cur, PORT_W] = cfg.node(r, c - 1)
    return torch.from_numpy(nb)


def _border(rows: int, cols: int):
    # top row L->R, right col T->B, bottom row R->L, left col B->T;
    # single-row/column meshes revisit the same coordinates going back
    border = [(0, c) for c in range(cols)]
    border += [(r, cols - 1) for r in range(1, rows)]
    border += [(rows - 1, c) for c in range(cols - 2, -1, -1)]
    border += [(r, 0) for r in range(rows - 2, 0, -1)]
    return list(dict.fromkeys(border))


def _edge_spread(rows: int, cols: int, n: int) -> Tuple[int, ...]:
    """n MCs evenly spaced along the mesh boundary."""
    border = _border(rows, cols)
    step = len(border) / n
    picks = [border[int(i * step)] for i in range(n)]
    return tuple(r * cols + c for r, c in picks)


def _corner_spread(rows: int, cols: int, n: int) -> Tuple[int, ...]:
    """Corners first (diagonal-opposite pairs), then evenly along the rest
    of the boundary. n=2 gives the two opposite corners, which on square
    meshes is the evenly spaced edge spread."""
    corners = [(0, 0), (rows - 1, cols - 1), (0, cols - 1), (rows - 1, 0)]
    picks = list(dict.fromkeys(corners))[:n]
    need = n - len(picks)
    if need > 0:
        rest = [b for b in _border(rows, cols) if b not in set(picks)]
        step = len(rest) / need
        picks += [rest[int(i * step)] for i in range(need)]
    return tuple(r * cols + c for r, c in picks)


def _interleave_spread(rows: int, cols: int, n: int) -> Tuple[int, ...]:
    """MCs evenly spaced through the row-major node list, ``int(i * nr /
    n)``. As in the reference, on every paper mesh and on 16x16_mc16 this
    puts all the MCs in column 0, not in the interior."""
    nr = rows * cols
    return tuple(int(i * nr / n) for i in range(n))


PLACEMENTS = ("edge", "corner", "interleaved")
_PLACEMENT_FNS = {
    "edge": _edge_spread,
    "corner": _corner_spread,
    "interleaved": _interleave_spread,
}


def mc_placement(rows: int, cols: int, num_mcs: int,
                 strategy: str = "edge") -> Tuple[int, ...]:
    """Router ids hosting the memory controllers under a placement strategy:
    ``edge`` (evenly along the boundary, the paper's layout), ``corner``
    (corners first, then evenly along the rest of the boundary) or
    ``interleaved`` (evenly through the row-major node list; may place
    more MCs than the boundary holds). Deterministic, distinct nodes, at
    least one PE router left."""
    if strategy not in _PLACEMENT_FNS:
        raise KeyError(f"unknown MC placement {strategy!r}; "
                       f"supported: {sorted(_PLACEMENT_FNS)}")
    if num_mcs >= rows * cols:
        raise ValueError(f"{num_mcs} MCs on a {rows}x{cols} mesh leave no "
                         "PE routers to receive traffic")
    boundary = rows * cols - max(rows - 2, 0) * max(cols - 2, 0)
    if num_mcs < 1 or (strategy != "interleaved" and num_mcs > boundary):
        raise ValueError(f"cannot place {num_mcs} MCs on a "
                         f"{rows}x{cols} mesh boundary ({boundary} routers)")
    return _PLACEMENT_FNS[strategy](rows, cols, num_mcs)


def mean_hop_counts(cfg: NocConfig) -> np.ndarray:
    """Per-MC mean Manhattan hop count to the config's PE routers."""
    pes = np.asarray(cfg.pe_nodes, np.int64)
    pr, pc = pes // cfg.cols, pes % cfg.cols
    out = np.zeros(cfg.num_mcs)
    for i, mc in enumerate(cfg.mc_nodes):
        r, c = divmod(mc, cfg.cols)
        out[i] = (np.abs(pr - r) + np.abs(pc - c)).mean() if pes.size else 0.0
    return out


# Packet->MC affinity: "roundrobin" deals packet g to MC g % M (the
# paper's); "nearest" serves each PE's packets from its hop-minimising MC.
AFFINITIES = ("roundrobin", "nearest")


def affinity_mc_table(cfg: NocConfig) -> np.ndarray:
    """Per-PE serving MC minimising the X-Y hop count: ``table[i]`` is the
    MC stream index (position in ``cfg.mc_nodes``) serving every packet
    destined for ``cfg.pe_nodes[i]``. Ties go to the MC with the fewest PEs
    assigned so far (greedy over PEs in node order), then to the lower
    index. Packet g goes to PE ``g % num_pes``, so its MC is
    ``table[g % num_pes]``."""
    pes = np.asarray(cfg.pe_nodes, np.int64)
    mcs = np.asarray(cfg.mc_nodes, np.int64)
    if not mcs.size:
        raise ValueError("config has no memory controllers")
    pr, pc = pes // cfg.cols, pes % cfg.cols
    mr, mc = mcs // cfg.cols, mcs % cfg.cols
    hops = (np.abs(pr[:, None] - mr[None, :])
            + np.abs(pc[:, None] - mc[None, :]))        # (num_pes, M)
    table = np.zeros(len(pes), np.int64)
    load = np.zeros(len(mcs), np.int64)
    for i in range(len(pes)):
        best = np.flatnonzero(hops[i] == hops[i].min())
        table[i] = best[np.argmin(load[best])]          # argmin: first tie
        load[table[i]] += 1
    return table


def packet_mean_hops(cfg: NocConfig, num_packets: int,
                     mc_table: Optional[np.ndarray] = None) -> float:
    """Exact mean MC<->PE Manhattan hop count over the first ``num_packets``
    packets: packet g computes at PE ``g % num_pes`` and is served by MC
    ``mc_table[g % len(mc_table)]`` (any periodic table) or ``g % num_mcs``
    (round-robin, the default). The request and result phases both travel
    this distance."""
    if num_packets <= 0:
        return 0.0
    pes = np.asarray(cfg.pe_nodes, np.int64)
    mcs = np.asarray(cfg.mc_nodes, np.int64)
    g = np.arange(num_packets, dtype=np.int64)
    pe = pes[g % len(pes)]
    if mc_table is not None:
        tbl = np.asarray(mc_table, np.int64)
        mc = mcs[tbl[g % len(tbl)]]
    else:
        mc = mcs[g % len(mcs)]
    hops = (np.abs(pe // cfg.cols - mc // cfg.cols)
            + np.abs(pe % cfg.cols - mc % cfg.cols))
    return float(hops.mean())


def xy_link_loads(cfg: NocConfig, lengths) -> np.ndarray:
    """Expected flits per directed inter-router link, (NR, 4) by out-port,
    with each MC's ``lengths[i]`` flits spread uniformly over the PEs."""
    loads = np.zeros((cfg.num_routers, 4))
    pes = cfg.pe_nodes
    if not pes:
        return loads
    for i, mc in enumerate(cfg.mc_nodes):
        if i >= len(lengths):
            break
        w = float(lengths[i]) / len(pes)
        r0, c0 = divmod(mc, cfg.cols)
        for pe in pes:
            r1, c1 = divmod(pe, cfg.cols)
            for c in range(c0, c1):                     # X first: east
                loads[r0 * cfg.cols + c, PORT_E] += w
            for c in range(c0, c1, -1):                 # or west
                loads[r0 * cfg.cols + c, PORT_W] += w
            for r in range(r0, r1):                     # then Y: south
                loads[r * cfg.cols + c1, PORT_S] += w
            for r in range(r0, r1, -1):                 # or north
                loads[r * cfg.cols + c1, PORT_N] += w
    return loads


# The paper's three evaluated NoC configurations (Sec. V-B).
PAPER_NOCS = {
    "4x4_mc2": NocConfig(4, 4, _edge_spread(4, 4, 2)),
    "8x8_mc4": NocConfig(8, 8, _edge_spread(8, 8, 4)),
    "8x8_mc8": NocConfig(8, 8, _edge_spread(8, 8, 8)),
}


def make_noc(rows: int, cols: int, num_mcs: int, placement: str = "edge",
             **kw) -> NocConfig:
    """Any mesh size under any MC placement strategy (:data:`PLACEMENTS`)."""
    return NocConfig(rows, cols, mc_placement(rows, cols, num_mcs, placement),
                     **kw)


_MESH_NAME = re.compile(r"^(\d+)x(\d+)_mc(\d+)$")


def mesh_by_name(name: str) -> NocConfig:
    """Resolve a ``RxC_mcN`` mesh name; PAPER_NOCS names resolve exactly."""
    if name in PAPER_NOCS:
        return PAPER_NOCS[name]
    m = _MESH_NAME.match(name)
    if not m:
        raise KeyError(
            f"unknown mesh {name!r}: expected one of {sorted(PAPER_NOCS)} "
            "or a 'RxC_mcN' spec")
    rows, cols, mcs = map(int, m.groups())
    return make_noc(rows, cols, mcs)


def alive_link_mask(cfg: NocConfig, dead_links: Tuple[Tuple[int, int], ...] = (),
                    dead_routers: Tuple[int, ...] = ()) -> np.ndarray:
    """``(NR, 4)`` bool: which inter-router out-directions survive the hard
    faults. A dead link ``(router, out_port)`` kills the bidirectional
    channel; a dead router kills all four of its channels. Directions off
    the mesh edge are dead by construction."""
    nr = cfg.num_routers
    nb = neighbor_table(cfg).numpy()
    alive = nb[:, :4] >= 0
    for router, port in dead_links:
        if not (0 <= router < nr and 0 <= port < 4):
            raise ValueError(f"dead link ({router}, {port}) out of range for "
                             f"a {cfg.rows}x{cfg.cols} mesh")
        other = int(nb[router, port])
        if other < 0:
            raise ValueError(f"dead link ({router}, {port}) points off the "
                             "mesh edge - no physical channel there")
        alive[router, port] = False
        alive[other, int(OPPOSITE[port])] = False
    for router in dead_routers:
        if not 0 <= router < nr:
            raise ValueError(f"dead router {router} out of range")
        alive[router, :] = False
        for port in range(4):
            other = int(nb[router, port])
            if other >= 0:
                alive[other, int(OPPOSITE[port])] = False
    return alive


def fault_route_table(cfg: NocConfig,
                      dead_links: Tuple[Tuple[int, int], ...] = (),
                      dead_routers: Tuple[int, ...] = ()):
    """``(table, reachable)``: the out-port per (router, dest), (NR, NR)
    int32, and whether a packet injected at ``src`` can reach ``dest``.

    The X-Y table, repaired only where the X-Y path is broken: a router
    whose whole X-Y path to the destination is alive keeps its X-Y port
    (with no hard faults the table is :func:`xy_route`'s), and a broken
    but reachable entry steps to a neighbor strictly closer in BFS
    distance (X-Y port first, then N/E/S/W). Entries of unreachable pairs
    keep their X-Y port and mean nothing: callers drop such packets."""
    nr = cfg.num_routers
    alive = alive_link_mask(cfg, dead_links, dead_routers)
    nb = neighbor_table(cfg).numpy()
    dead_r = np.zeros(nr, bool)
    dead_r[list(dead_routers)] = True
    table = xy_route(cfg).numpy().copy()
    reachable = np.zeros((nr, nr), dtype=bool)
    unreach = nr + 1
    rows = np.arange(nr) // cfg.cols
    cols = np.arange(nr) % cfg.cols
    for d in range(nr):
        if dead_r[d]:
            continue
        # BFS distance to d over alive channels (killed both ways, so the
        # reverse search from d is forward reachability to d).
        dist = np.full(nr, unreach, np.int32)
        dist[d] = 0
        frontier = [d]
        while frontier:
            nxt = []
            for cur in frontier:
                for port in range(4):
                    n = int(nb[cur, port])
                    if n >= 0 and alive[cur, port] and dist[n] == unreach:
                        dist[n] = dist[cur] + 1
                        nxt.append(n)
            frontier = nxt
        reachable[:, d] = dist < unreach
        # X-Y-intact routers, nearest first: each X-Y hop lands closer.
        good = np.zeros(nr, bool)
        good[d] = True
        manhattan = np.abs(rows - rows[d]) + np.abs(cols - cols[d])
        for r in np.argsort(manhattan, kind="stable"):
            if r == d:
                continue
            port = int(table[r, d])
            n = int(nb[r, port])
            good[r] = n >= 0 and alive[r, port] and good[n]
        for r in range(nr):
            if r == d or good[r] or dist[r] == unreach:
                continue
            prefs = [int(table[r, d])]
            prefs += [p for p in range(4) if p not in prefs]
            for port in prefs:
                n = int(nb[r, port])
                if n >= 0 and alive[r, port] and dist[n] == dist[r] - 1:
                    table[r, d] = port
                    break
    return table, reachable
