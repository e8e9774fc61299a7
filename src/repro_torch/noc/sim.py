"""Cycle-level NoC simulator on PyTorch tensors.

The port of ``repro.noc.sim``: a 2D mesh with X-Y routing, 4 VCs per input
port with 4-flit FIFOs, conservative one-cycle credits, round-robin switch
allocation per output port, one flit per link per cycle, and the paper's
Fig. 8 BT recorder on every link and every NI link. See the reference's
module docstring and DESIGN.md for the modelling choices; the arithmetic
here is the same, operation for operation.

Two implementations of a router cycle, selected by ``backend=``:

* ``plain_step`` - eager PyTorch, a copy of ``repro.noc.sim._make_step``
  with ``faults=None``, batched over a leading variants axis. It runs on
  any device and is the CPU path. ``tracked_step`` is the same cycle with
  the reference's ``track=True`` (a packet-id lane in the FIFOs and the
  ``eject_pkt`` ledger of tail ejections) and, optionally, its
  ``timestamps=True`` ledgers (``inj_time`` / ``eject_time``). Given a
  fault spec (``faults=``, a ``noc.faults.StepFaults``) it is also the
  reference's faulty step: the detour route table, the seeded flip
  schedule on router and NI links, and the ``flip_pkt`` / ``bad_pkt``
  ledgers of flips and of protection-detected corrupt flits.
* the Hopper kernel ``repro_torch.kernels.router_step`` - a whole chunk of
  cycles per launch, bit-identical to the plain step on every real router
  row. ``backend="auto"`` uses it for CUDA tensors. Like the reference's
  Pallas step it carries no ledger and no faults: a drain with
  ``check_conservation``, ``timestamps`` or faults runs the tracked plain
  step on the same device.

State is always batched: every leaf carries a leading variants axis B;
``simulate`` drains one Traffic as a batch of one. ``simulate_batch(devices=)``
deals the lanes over several devices (a device may repeat), one contiguous
block a device, each block's state on its own device.
"""
from __future__ import annotations

import dataclasses
import itertools
from contextlib import nullcontext
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .. import tree
from .._device import DeviceLike, resolve_device
from ..core.bits import popcount32
from ..core.wire import PROTECTION_BITS, protection_syndrome_masks
from .topology import NocConfig, NUM_PORTS, OPPOSITE, PORT_E, PORT_LOCAL, \
    PORT_N, PORT_S, PORT_W, fault_route_table

__all__ = ["Traffic", "Wire", "SimState", "Ledger", "SimResult",
           "DrainTimeout", "simulate", "simulate_batch", "make_state",
           "make_ledger", "fuse_traffic", "pack_sideband", "plain_step",
           "tracked_step", "BACKENDS", "META_PAYLOAD", "META_TAIL"]

# Flit meta bitfield
META_PAYLOAD = 1
META_TAIL = 2

# Packed sideband word layout (one int32 lane stacked after the payload):
#   bits 0..8    destination router id (up to 512 routers; 16x16 = 256)
#   bits 9..10   META bitfield (META_PAYLOAD | META_TAIL)
#   bits 11..15  static VC index (up to 32 VCs)
SIDE_DEST_BITS = 9
SIDE_META_SHIFT = 9
SIDE_VC_SHIFT = 11
_DEST_MASK = (1 << SIDE_DEST_BITS) - 1
_META_MASK = 3
MAX_ROUTERS = 1 << SIDE_DEST_BITS
MAX_VCS = 1 << (16 - SIDE_VC_SHIFT)

BACKENDS = ("auto", "plain", "cuda")


class Traffic(NamedTuple):
    """Per-source injection streams, padded to a common length T.

    words:  (M, T, L) int32 - flit payloads (uint32 bit patterns)
    dest:   (M, T) int32    - destination router id
    meta:   (M, T) int32    - META_* bitfield
    vc:     (M, T) int32    - static VC assignment (round-robin per packet)
    pkt:    (M, T) int32    - packet id
    length: (M,) int32      - real stream length per source
    num_packets: int        - packet-id count (-1: unknown)

    A batched Traffic carries one extra leading variants axis B on every
    tensor field.
    """

    words: torch.Tensor
    dest: torch.Tensor
    meta: torch.Tensor
    vc: torch.Tensor
    pkt: torch.Tensor
    length: torch.Tensor
    num_packets: int = -1

    def variant(self, i) -> "Traffic":
        """One variant row of a batched Traffic (metadata preserved)."""
        return self._replace(
            words=self.words[i], dest=self.dest[i], meta=self.meta[i],
            vc=self.vc[i], pkt=self.pkt[i], length=self.length[i])


class Wire(NamedTuple):
    """Fused wire-format traffic, batched: the simulator's input.

    wire: (B, M, T, LF) int32 - payload lanes, then the packed sideband lane.
    length: (B, M) int32
    """

    wire: torch.Tensor
    length: torch.Tensor


def pack_sideband(dest: torch.Tensor, meta: torch.Tensor,
                  vc: torch.Tensor) -> torch.Tensor:
    """Pack (dest, META, VC) into the one-word sideband layout (int32)."""
    return (dest.to(torch.int32) | (meta.to(torch.int32) << SIDE_META_SHIFT)
            | (vc.to(torch.int32) << SIDE_VC_SHIFT))


def fuse_traffic(traffic: Traffic, track_pkt: bool = False) -> Wire:
    """Stack payload lanes with the packed sideband (and, for a tracked
    drain, the packet-id lane), with a leading variants axis (an unbatched
    Traffic gets B = 1)."""
    if traffic.length.dim() == 1:
        traffic = Traffic(*(t[None] for t in traffic[:6]),
                          num_packets=traffic.num_packets)
    side = pack_sideband(traffic.dest, traffic.meta, traffic.vc)
    parts = [traffic.words.to(torch.int32), side[..., None]]
    if track_pkt:
        parts.append(traffic.pkt.to(torch.int32)[..., None])
    wire = torch.cat(parts, dim=-1)
    return Wire(wire.contiguous(), traffic.length.to(torch.int32).contiguous())


class SimState(NamedTuple):
    """Batched simulator state: 13 int32 leaves, each with a leading B."""

    fifo: torch.Tensor        # (B, NR+1, P, V, D, LF) payload | sideband
    head: torch.Tensor        # (B, NR+1, P, V)
    count: torch.Tensor       # (B, NR+1, P, V)
    rr: torch.Tensor          # (B, NR, P) round-robin pointer per out-port
    link_last: torch.Tensor   # (B, NR, P, L) last word per output link
    link_bt: torch.Tensor     # (B, NR, P) accumulated transitions
    link_flits: torch.Tensor  # (B, NR, P) flits traversed
    inj_ptr: torch.Tensor     # (B, M)
    inj_last: torch.Tensor    # (B, M, L) NI link state
    inj_bt: torch.Tensor      # (B, M)
    ejected: torch.Tensor     # (B,) flits delivered
    cycle: torch.Tensor       # (B,)
    drained_at: torch.Tensor  # (B,) first cycle with everything ejected, -1

    def take(self, idx: torch.Tensor) -> "SimState":
        """The lanes ``idx`` of every leaf (lane compaction)."""
        return SimState(*(leaf.index_select(0, idx) for leaf in self))


# inj_time sentinel: "never injected"
_TIME_UNSET = 2**31 - 1


class Ledger(NamedTuple):
    """Per-packet ledgers of a tracked drain, each (B, NP+1) int32, packet
    id ``i`` at column ``i`` and a dump slot last (the reference's
    ``SimState.eject_pkt`` / ``inj_time`` / ``eject_time`` / ``flip_pkt``
    / ``bad_pkt``).

    eject_pkt:  tail ejections per packet id (the conservation ledger).
    inj_time:   cycle the header left its NI (``_TIME_UNSET`` until then);
                None unless the drain runs with ``timestamps``.
    eject_time: cycle the tail ejected (-1 until then); likewise.
    flip_pkt:   bit-flip events per packet id, whatever the protection;
                None unless the drain has faults.
    bad_pkt:    flits whose protection check failed at ejection, per
                packet id; likewise.
    """

    eject_pkt: torch.Tensor
    inj_time: Optional[torch.Tensor] = None
    eject_time: Optional[torch.Tensor] = None
    flip_pkt: Optional[torch.Tensor] = None
    bad_pkt: Optional[torch.Tensor] = None

    def take(self, idx: torch.Tensor) -> "Ledger":
        """The lanes ``idx`` of every ledger (lane compaction)."""
        return Ledger(*(None if x is None else x.index_select(0, idx)
                        for x in self))


@dataclasses.dataclass
class SimResult:
    cycles: int
    ejected: int
    injected: int
    link_bt: np.ndarray      # (NR, P) per-output-link transitions
    link_flits: np.ndarray
    inj_bt: np.ndarray       # (M,) NI-link transitions
    total_bt: int            # inter-router + ejection + NI links
    inter_router_bt: int
    # Exact cycle the last flit ejected; ``cycles`` is chunk-quantized.
    drain_cycle: Optional[int] = None
    # Per-packet header-injection / tail-ejection cycles, (num_packets,)
    # int32, from a drain with ``timestamps=True``; None otherwise.
    inj_time: Optional[np.ndarray] = None
    eject_time: Optional[np.ndarray] = None

    @property
    def bt_per_flit(self) -> float:
        return self.total_bt / max(int(self.link_flits.sum()), 1)


class DrainTimeout(RuntimeError):
    """A drain hit ``max_cycles`` with flits still in the network.

    Attributes: ``cycle``, ``ejected``, ``total``; ``occupancy`` lists
    ``(router, port, flits)`` for every non-empty input-FIFO block, busiest
    first; ``pending`` lists ``(stream, flits_not_yet_injected)``;
    ``undelivered`` lists the packet ids with no tail ejection when the
    drain ran with the packet ledger armed (None otherwise).
    """

    def __init__(self, message: str, *, cycle: int, ejected: int, total: int,
                 occupancy=None, pending=None, undelivered=None):
        super().__init__(message)
        self.cycle = cycle
        self.ejected = ejected
        self.total = total
        self.occupancy = occupancy or []
        self.pending = pending or []
        self.undelivered = undelivered


def _drain_timeout(context: str, cycle: int, ejected: int, total: int,
                   count: np.ndarray, inj_ptr: np.ndarray,
                   lengths: np.ndarray,
                   eject_pkt: Optional[np.ndarray] = None,
                   npkt: int = 0) -> DrainTimeout:
    """Build the watchdog diagnostic from one lane's final state leaves."""
    nr = count.shape[0] - 1                      # drop the phantom row
    occ = count[:nr].sum(axis=-1)                # (NR, P) flits over VCs
    rp = np.argwhere(occ > 0)
    order = np.argsort(-occ[occ > 0], kind="stable")
    occupancy = [(int(r), int(p_), int(occ[r, p_])) for r, p_ in rp[order]]
    pending = [(int(i), int(lengths[i] - inj_ptr[i]))
               for i in np.flatnonzero(inj_ptr < lengths)]
    undelivered = None
    if eject_pkt is not None and npkt > 0:
        undelivered = np.flatnonzero(eject_pkt[:npkt] == 0).tolist()
    parts = [f"{context} did not drain: {ejected}/{total} flits ejected "
             f"after {cycle} cycles"]
    if pending:
        parts.append(f"{sum(n for _, n in pending)} flits uninjected across "
                     f"{len(pending)} streams")
    if occupancy:
        parts.append("occupied FIFOs (router, port, flits): "
                     f"{occupancy[:8]}" + (" ..." if len(occupancy) > 8 else ""))
    if undelivered is not None:
        parts.append(f"{len(undelivered)} undelivered packet ids: "
                     f"{undelivered[:16]}"
                     + (" ..." if len(undelivered) > 16 else ""))
    return DrainTimeout("; ".join(parts), cycle=cycle, ejected=ejected,
                        total=total, occupancy=occupancy, pending=pending,
                        undelivered=undelivered)


def make_state(cfg: NocConfig, num_mcs: int, batch: int = 1,
               device: DeviceLike = None, track: bool = False) -> SimState:
    """Zeroed batched simulator state; ``track`` gives the FIFOs a
    packet-id lane after the sideband (a tracked drain's)."""
    dev = resolve_device(device)
    nr, p, v, d, l = (cfg.num_routers, NUM_PORTS, cfg.num_vcs, cfg.vc_depth,
                      cfg.lanes)
    if nr > MAX_ROUTERS:
        raise ValueError(f"{nr} routers exceed the {SIDE_DEST_BITS}-bit "
                         f"sideband dest field ({MAX_ROUTERS} max)")
    if cfg.num_vcs > MAX_VCS:
        raise ValueError(f"{cfg.num_vcs} VCs exceed the sideband VC field "
                         f"({MAX_VCS} max)")

    def z(*shape):
        return torch.zeros((batch,) + shape, dtype=torch.int32, device=dev)

    return SimState(
        fifo=z(nr + 1, p, v, d, l + 1 + int(track)), head=z(nr + 1, p, v),
        count=z(nr + 1, p, v), rr=z(nr, p), link_last=z(nr, p, l),
        link_bt=z(nr, p), link_flits=z(nr, p), inj_ptr=z(num_mcs),
        inj_last=z(num_mcs, l), inj_bt=z(num_mcs), ejected=z(),
        cycle=z(), drained_at=torch.full((batch,), -1, dtype=torch.int32,
                                         device=dev))


def make_ledger(npkt: int, batch: int = 1, timestamps: bool = False,
                device: DeviceLike = None,
                fault_ledgers: bool = False) -> Ledger:
    """Zeroed ledgers for packet ids ``0..npkt-1`` (and the dump slot);
    ``fault_ledgers`` adds ``flip_pkt`` / ``bad_pkt`` (it needs
    ``timestamps``, as the reference's ``make_state`` does)."""
    if npkt <= 0:
        raise ValueError(f"a ledger needs npkt > 0, got {npkt}")
    if fault_ledgers and not timestamps:
        raise ValueError("fault_ledgers=True requires timestamps=True (the "
                         "fault step needs the timing ledgers for retries)")
    dev = resolve_device(device)

    def full(value):
        return torch.full((batch, npkt + 1), value, dtype=torch.int32,
                          device=dev)

    return Ledger(full(0), full(_TIME_UNSET) if timestamps else None,
                  full(-1) if timestamps else None,
                  full(0) if fault_ledgers else None,
                  full(0) if fault_ledgers else None)


def _mesh_key(cfg: NocConfig):
    return (cfg.rows, cfg.cols, cfg.num_vcs, cfg.vc_depth, cfg.lanes)


_GEOMETRY = {}


def _geometry(mesh_key, device: torch.device):
    """Routing constants of ``_make_step`` (same derivation, same names),
    as tensors on ``device``; cached per (mesh, device)."""
    key = (mesh_key, str(device))
    if key in _GEOMETRY:
        return _GEOMETRY[key]
    rows, cols, num_vcs, vc_depth, lanes = mesh_key
    nr = rows * cols
    coords = np.arange(nr)
    rrow_np, rcol_np = coords // cols, coords % cols
    delta_np = np.array([-cols, 1, cols, -1, 0])
    down_np = coords[:, None] + delta_np[None, :]
    dir_ok = np.stack([rrow_np > 0, rcol_np < cols - 1, rrow_np < rows - 1,
                       rcol_np > 0, np.zeros(nr, bool)], axis=1)
    opp4 = OPPOSITE[:4]

    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    geo = dict(
        rrow=t(rrow_np[:, None, None], torch.int32),
        rcol=t(rcol_np[:, None, None], torch.int32),
        nb_blk=t(np.where(dir_ok[:, :4], down_np[:, :4] * NUM_PORTS
                          + opp4[None, :], nr * NUM_PORTS).reshape(-1)),
        src_ok=t(dir_ok[:, :4], torch.bool),
        src_po=t((np.where(dir_ok[:, :4], down_np[:, :4], 0) * NUM_PORTS
                  + opp4[None, :]).reshape(-1)),
        rcv_base=t(coords[:, None] * NUM_PORTS + np.arange(4)[None, :],
                   torch.int32),
        front_base=t(np.arange(nr * NUM_PORTS * num_vcs) * vc_depth),
        slots=t(np.arange(NUM_PORTS * num_vcs), torch.int32),
        outs=t(np.arange(NUM_PORTS)[None, None, :, None], torch.int32),
        r2=t(np.arange(nr)[:, None], torch.int32),
        o_local=t(np.arange(NUM_PORTS) == PORT_LOCAL, torch.bool),
    )
    _GEOMETRY[key] = geo
    return geo


_U32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` on int64 carriers of uint32 values: ``c`` split
    in 16-bit halves, so no product passes 2^48 (no signed overflow)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _U32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The reference's SplitMix32 finalizer (``repro.noc.sim._mix32``) on
    int64 carriers: the uint32 value of ``x`` in, a uint32 value out in
    [0, 2^32), with logical shifts and multiplies that wrap at 2^32
    (ROADMAP C1 / C5: on int32 carriers ``>>`` is arithmetic and the
    schedule goes wrong for every hash with bit 31 set)."""
    x = x.to(torch.int64) & _U32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 carriers of uint32 values -> the int32 bit patterns."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


_FAULTS = {}


def _fault_consts(mesh_key, faults, m: int, device: torch.device):
    """The faulty step's constants (``_make_step``'s ``faults`` block):
    the detour table, the flip threshold and the per-link seed hashes
    (router links ``0..NR*P-1``, the local port included, then NI links
    ``NR*P + stream``), the protection code width and syndrome masks;
    cached per (mesh, spec, streams, device)."""
    key = (mesh_key, tuple(faults), m, str(device))
    if key in _FAULTS:
        return _FAULTS[key]
    rows, cols, num_vcs, vc_depth, lanes = mesh_key
    cfg = NocConfig(rows, cols, (), num_vcs=num_vcs, vc_depth=vc_depth,
                    lanes=lanes)
    route, _ = fault_route_table(cfg, tuple(faults.dead_links),
                                 tuple(faults.dead_routers))
    rate = float(faults.rate)
    pbits = PROTECTION_BITS[faults.protect]
    fc = dict(froute=torch.as_tensor(route.reshape(-1), device=device),
              flips=rate > 0.0, pbits=pbits)
    if fc["flips"]:
        fc["thresh"] = min(int(round(rate * 2.0**32)), 2**32 - 1)
        seed = int(faults.seed) & _U32
        lid = torch.arange(rows * cols * NUM_PORTS + m, dtype=torch.int64,
                           device=device)
        fc["lid_hash"] = _mix32((lid + seed) & _U32)
    if pbits:
        fc["syn"] = torch.tensor(
            protection_syndrome_masks(faults.protect, lanes), device=device)
    _FAULTS[key] = fc
    return fc


def protection_code(payload: torch.Tensor, syn: torch.Tensor) -> torch.Tensor:
    """Each flit's protection code from its payload lanes (..., L) and the
    syndrome masks (code_bits, L): bit ``j`` is the parity of
    ``payload & syn[j]`` (int64, below ``2^code_bits``)."""
    par = popcount32(payload[..., None, :] & syn).sum(-1) & 1
    return (par << torch.arange(syn.shape[0], device=syn.device)).sum(-1)


def _flip_mask(h: torch.Tensor, hit: torch.Tensor, lanes: int) -> torch.Tensor:
    """The one-bit XOR mask, (..., L) int32, of each flit ``hit`` marks:
    lane and bit from a second hash of its link hash ``h``."""
    bitpos = _mix32(h ^ 0x632BE5AB) % (32 * lanes)
    word = _as_int32(torch.ones_like(bitpos) << (bitpos % 32))
    lane_ax = torch.arange(lanes, device=h.device)
    sel = (lane_ax == (bitpos // 32)[..., None]) & hit[..., None]
    return torch.where(sel, word[..., None], 0)


def plain_step(state: SimState, wire: Wire, mc_nodes: torch.Tensor,
               mesh_key, count_headers: bool) -> SimState:
    """One router cycle for every lane, in eager PyTorch.

    A copy of ``repro.noc.sim._make_step`` (``faults=None``,
    ``track=False``) with a leading variants axis: front sideband gather,
    X-Y route, credit check, masked-min round-robin allocation, pops, the
    winners' flit gather, link BT, receiver-side pushes, injection, NI-link
    BT, drain detection. Returns a new state; ``state`` is not modified.
    """
    return _step(state, None, wire, mc_nodes, mesh_key, count_headers)[0]


def tracked_step(state: SimState, ledger: Ledger, wire: Wire,
                 mc_nodes: torch.Tensor, mesh_key, count_headers: bool,
                 faults=None):
    """:func:`plain_step` with the reference's packet ledgers
    (``_make_step(track=True)``, and ``timestamps=True`` when ``ledger``
    holds the time ledgers): the FIFOs and the wire carry a packet-id lane
    after the sideband; a tail flit ejecting adds one to its id's
    ``eject_pkt`` and stamps ``eject_time`` with the cycle (max); a header
    flit leaving its NI stamps ``inj_time`` (min). Ids past the ledger, or
    negative, go to its dump slot. Returns ``(state, ledger)``, both new.

    ``faults`` (a ``noc.faults.StepFaults``; the ledger must hold the time
    and fault ledgers) is the reference's ``_make_step(faults=)``: routes
    from the detour table, a seeded one-bit flip of a winner's payload
    (before the link recorder, ``link_last``, the push and the ejection
    check) and of the injected flit (before the NI recorder and the
    write), each hash of (seed, this lane's cycle, link id) below the
    rate's threshold; ``flip_pkt`` counts flips, ``bad_pkt`` the ejected
    flits whose protection code (sideband bits 16+) no longer matches."""
    return _step(state, ledger, wire, mc_nodes, mesh_key, count_headers,
                 faults)


def _ledger_index(mask: torch.Tensor, pkt: torch.Tensor,
                  npcap: int) -> torch.Tensor:
    """Ledger column per flit: its packet id where ``mask`` holds (ids
    past the ledger, or negative, at the dump slot ``npcap``), else the
    dump slot; flattened to (B, -1) int64."""
    b = mask.shape[0]
    ok = mask & (pkt >= 0)
    return torch.where(ok, torch.clamp(pkt, max=npcap), npcap).reshape(
        b, -1).long()


def _step(state: SimState, ledger: Optional[Ledger], wire: Wire,
          mc_nodes: torch.Tensor, mesh_key, count_headers: bool,
          faults=None):
    rows, cols, v, d, l = mesh_key
    nr, p = rows * cols, NUM_PORTS
    lf = state.fifo.shape[-1]
    if lf != l + 1 + (ledger is not None) or wire.wire.shape[-1] != lf:
        raise ValueError(f"state and wire carry {lf} and "
                         f"{wire.wire.shape[-1]} words a flit; a "
                         f"{'tracked' if ledger is not None else 'plain'} "
                         f"step on {l} lanes needs "
                         f"{l + 1 + (ledger is not None)}")
    nslots = p * v
    g = _geometry(mesh_key, state.fifo.device)
    b = state.fifo.shape[0]
    m = wire.length.shape[1]
    t_cap = wire.wire.shape[2]
    bidx = torch.arange(b, device=state.fifo.device)[:, None]
    fc, flips, pbits = None, False, 0
    if faults is not None:
        if (ledger is None or ledger.inj_time is None
                or ledger.flip_pkt is None):
            raise ValueError("fault injection requires a ledger with the "
                             "timestamps and the fault ledgers "
                             "(make_ledger(timestamps=True, "
                             "fault_ledgers=True))")
        fc = _fault_consts(mesh_key, faults, m, state.fifo.device)
        flips, pbits = fc["flips"], fc["pbits"]
        if flips:
            cyc_h = _mul32(state.cycle.to(torch.int64), 0x9E3779B9)[:, None]

    head_r = state.head[:, :nr]                         # (B, NR, P, V)
    count_r = state.count[:, :nr]
    valid = count_r > 0
    fifo_rows = state.fifo.reshape(b, -1, lf)           # (B, rows, LF)

    # --- front sideband: one word per FIFO ---
    front_row = g["front_base"][None, :] + head_r.reshape(b, -1)
    fside = fifo_rows[:, :, l].gather(1, front_row).reshape(b, nr, p, v)
    fd = fside & _DEST_MASK

    # --- route computation (X-Y, closed form; the detour table under
    # faults, where garbage dests of empty FIFOs are masked by ``valid``) ---
    if fc is None:
        dr, dc = fd // cols, fd % cols
        rrow, rcol = g["rrow"], g["rcol"]
        out_port = torch.where(
            dc > rcol, PORT_E, torch.where(
                dc < rcol, PORT_W, torch.where(
                    dr > rrow, PORT_S, torch.where(
                        dr < rrow, PORT_N, PORT_LOCAL)))).to(torch.int32)
    else:
        out_port = fc["froute"][
            (g["r2"][..., None] * nr + torch.clamp(fd, max=nr - 1)).long()]

    # --- credit check: downstream FIFO (same VC) has space ---
    is_eject = out_port == PORT_LOCAL
    count_blocks = state.count.reshape(b, (nr + 1) * p, v)
    ok = count_blocks[:, g["nb_blk"]].reshape(b, nr, 4, v) < d
    space = torch.where(
        out_port == PORT_N, ok[:, :, None, PORT_N, :], torch.where(
            out_port == PORT_E, ok[:, :, None, PORT_E, :], torch.where(
                out_port == PORT_S, ok[:, :, None, PORT_S, :],
                ok[:, :, None, PORT_W, :])))
    request = valid & (is_eject | space)                # (B, NR, P, V)

    # --- switch allocation: round-robin per (router, out_port) ---
    slot_req = request.reshape(b, nr, nslots)
    slot_out = out_port.reshape(b, nr, nslots)
    req_po = slot_req[:, :, None, :] & (slot_out[:, :, None, :] == g["outs"])
    slots = g["slots"]
    rel = slots - state.rr[..., None]
    rel = torch.where(rel < 0, rel + nslots, rel)
    min_rel = torch.where(req_po, rel, nslots).amin(dim=3)   # (B, NR, P)
    has = min_rel < nslots
    winner = state.rr + min_rel
    winner = torch.where(winner >= nslots, winner - nslots, winner)
    rr_new = winner + 1
    rr_new = torch.where(rr_new >= nslots, rr_new - nslots, rr_new)
    rr_new = torch.where(has, rr_new, state.rr)

    # --- pops ---
    pop = ((slots == winner[..., None]) & has[..., None]).any(dim=2)
    pop = pop.reshape(b, nr, p, v)
    head_new = torch.where(pop, (head_r + 1) % d, head_r)
    count_new = count_r - pop.to(torch.int32)
    head2 = torch.cat([head_new, state.head[:, nr:]], dim=1)
    count2 = torch.cat([count_new, state.count[:, nr:]], dim=1)

    # --- gather the winners' flits only: (B, NR, P_out, LF) ---
    win_p = winner // v
    win_v = winner % v
    win_pv = ((g["r2"] * p + win_p) * v + win_v).reshape(b, -1).long()
    win_head = state.head.reshape(b, -1).gather(1, win_pv)
    win_row = win_pv * d + win_head
    mv = fifo_rows[bidx, win_row].reshape(b, nr, p, lf)
    if flips:
        # Router-link soft error: the winner's payload traversing the link
        # this cycle, before every reader of ``mv`` below.
        h = _mix32(fc["lid_hash"][None, :nr * p] ^ cyc_h).reshape(b, nr, p)
        hit = has & (h < fc["thresh"])
        mv = torch.cat([mv[..., :l] ^ _flip_mask(h, hit, l), mv[..., l:]],
                       dim=-1)
    mv_side = mv[..., l]
    mv_meta = (mv_side >> SIDE_META_SHIFT) & _META_MASK

    # --- link BT recording (the Fig. 8 recorder) ---
    tog = popcount32(state.link_last ^ mv[..., :l]).sum(-1, dtype=torch.int32)
    counted = has if count_headers else has & ((mv_meta & META_PAYLOAD) > 0)
    link_bt = state.link_bt + torch.where(counted, tog, 0)
    link_flits = state.link_flits + has.to(torch.int32)
    link_last = torch.where(has[..., None], mv[..., :l], state.link_last)

    # --- pushes, receiver-side ---
    src_po = g["src_po"]
    inc_ok = has.reshape(b, -1)[:, src_po].reshape(b, nr, 4) & g["src_ok"]
    inc_vc = win_v.reshape(b, -1)[:, src_po].reshape(b, nr, 4)
    inc_w = mv.reshape(b, nr * p, lf)[:, src_po]        # (B, NR*4, LF)
    wc4 = (head2[:, :nr, :4, :] + count2[:, :nr, :4, :]) % d
    wslot = wc4[..., 0]
    for vi in range(1, v):
        wslot = torch.where(inc_vc == vi, wc4[..., vi], wslot)
    ejected = state.ejected + (has & g["o_local"]).sum(
        dim=(1, 2), dtype=torch.int32)

    # --- conservation ledger: tail flits ejecting at their destination ---
    if ledger is not None:
        flip_pkt, bad_pkt = ledger.flip_pkt, ledger.bad_pkt
        npcap = ledger.eject_pkt.shape[1] - 1
        ej_tail = has & g["o_local"] & ((mv_meta & META_TAIL) > 0)
        lidx = _ledger_index(ej_tail, mv[..., l + 1], npcap)
        eject_pkt = ledger.eject_pkt.scatter_add(
            1, lidx, ej_tail.reshape(b, -1).to(torch.int32))
        eject_time = ledger.eject_time
        if eject_time is not None:
            # A tail ejects once: max() against the -1 init records the
            # cycle; other rows write -1 into the dump slot, a no-op.
            eject_time = eject_time.scatter_reduce(
                1, lidx, torch.where(ej_tail, state.cycle[:, None, None],
                                     -1).reshape(b, -1), reduce="amax")
        if flips:
            # Ground truth: every flip marks its packet, whatever the code.
            flip_pkt = flip_pkt.scatter_add(
                1, _ledger_index(hit, mv[..., l + 1], npcap),
                hit.reshape(b, -1).to(torch.int32))
        if pbits:
            # Detection at ejection: the code re-derived over the payload
            # against the carried sideband bits. The codes are linear, so a
            # mismatch depends on the flip mask alone, never the payload.
            carried = (mv_side >> 16) & ((1 << pbits) - 1)
            mism = (has & g["o_local"]
                    & (protection_code(mv[..., :l], fc["syn"]) != carried))
            bad_pkt = bad_pkt.scatter_add(
                1, _ledger_index(mism, mv[..., l + 1], npcap),
                mism.reshape(b, -1).to(torch.int32))

    # --- injection: one flit per MC per cycle into the local in-port ---
    ptr = state.inj_ptr
    active = ptr < wire.length
    safe_ptr = torch.clamp(ptr, max=t_cap - 1).long()
    midx = torch.arange(m, device=ptr.device)[None, :]
    iw = wire.wire[bidx, midx, safe_ptr]                 # (B, M, LF)
    iside = iw[..., l]
    imeta = (iside >> SIDE_META_SHIFT) & _META_MASK
    ivc = iside >> SIDE_VC_SHIFT
    if pbits:
        ivc = ivc & (MAX_VCS - 1)   # protection codes ride bits 16+
    head2_flat = head2.reshape(b, -1)
    count2_flat = count2.reshape(b, -1)
    mc_pv = ((mc_nodes * p + PORT_LOCAL) * v + ivc).long()
    mc_cnt = count2_flat.gather(1, mc_pv)
    can = active & (mc_cnt < d)
    if flips:
        # NI-link soft error on the flit entering the mesh, before the
        # write and the NI recorder.
        ih = _mix32(fc["lid_hash"][None, nr * p:] ^ cyc_h)
        ihit = can & (ih < fc["thresh"])
        iw = torch.cat([iw[..., :l] ^ _flip_mask(ih, ihit, l), iw[..., l:]],
                       dim=-1)
    inj_pv = torch.where(can, mc_pv, (nr * p + PORT_LOCAL) * v + ivc.long())
    islot = (head2_flat.gather(1, inj_pv) + count2_flat.gather(1, inj_pv)) % d

    # --- one combined push+inject scatter (disjoint FIFO targets) ---
    phantom_row = nr * p * v * d
    rcv_row = torch.where(inc_ok, (g["rcv_base"] * v + inc_vc) * d + wslot,
                          phantom_row)
    cat_row = torch.cat([rcv_row.reshape(b, -1).long(), inj_pv * d + islot],
                        dim=1)
    cat_w = torch.cat([inc_w, iw], dim=1)
    fifo_new = fifo_rows.clone()
    fifo_new[bidx, cat_row] = cat_w
    vcs4 = torch.arange(v, device=ptr.device, dtype=torch.int32)
    count_inc = ((vcs4 == inc_vc[..., None])
                 & inc_ok[..., None]).to(torch.int32)   # (B, NR, 4, V)
    count_new = count2.clone()
    count_new[:, :nr, :4, :] += count_inc
    count_new = count_new.reshape(b, -1)
    count_new.scatter_add_(1, inj_pv, can.to(torch.int32))
    ptr_new = ptr + can.to(torch.int32)

    # NI-link BT (MC -> router); the ordering unit sits right before it.
    itog = popcount32(state.inj_last ^ iw[..., :l]).sum(-1, dtype=torch.int32)
    icounted = can if count_headers else can & ((imeta & META_PAYLOAD) > 0)
    inj_bt = state.inj_bt + torch.where(icounted, itog, 0)
    inj_last = torch.where(can[..., None], iw[..., :l], state.inj_last)

    if ledger is not None:
        inj_time = ledger.inj_time
        if inj_time is not None:
            # The header leaving the NI stamps the injection cycle: min()
            # against the UNSET init; everything else dumps.
            inj_hdr = can & ((imeta & META_PAYLOAD) == 0)
            tidx = _ledger_index(inj_hdr, iw[..., l + 1], npcap)
            inj_time = inj_time.scatter_reduce(
                1, tidx, torch.where(inj_hdr, state.cycle[:, None],
                                     _TIME_UNSET), reduce="amin")
        if flips:
            flip_pkt = flip_pkt.scatter_add(
                1, _ledger_index(ihit, iw[..., l + 1], npcap),
                ihit.to(torch.int32))
        ledger = Ledger(eject_pkt, inj_time, eject_time, flip_pkt, bad_pkt)

    total = wire.length.sum(dim=1, dtype=torch.int32)
    drained_at = torch.where((state.drained_at < 0) & (ejected >= total),
                             state.cycle + 1, state.drained_at)

    return SimState(fifo_new.reshape(state.fifo.shape), head2,
                    count_new.reshape(count2.shape), rr_new, link_last,
                    link_bt, link_flits, ptr_new, inj_last, inj_bt, ejected,
                    state.cycle + 1, drained_at), ledger


def _resolve_backend(backend: str, device: torch.device,
                     track: bool = False, faults: bool = False) -> str:
    """``auto`` -> the kernel for CUDA tensors, the plain step for CPU
    tensors and for every drain with a packet ledger (``track``: the
    conservation check or the timestamps) or with faults, which the kernel
    does not carry. An explicit ``cuda`` with either, or on CPU tensors,
    raises."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "cuda" and faults:
        raise ValueError(
            "backend='cuda' cannot inject faults: the Hopper router kernel "
            "has no fault hooks and no packet ledger, as the reference's "
            "Pallas step has none. Use backend='auto' (a fault drain runs "
            "the plain step on the traffic's device).")
    track = track or faults
    if backend == "cuda" and track:
        raise ValueError(
            "backend='cuda' cannot honor check_conservation / timestamps: "
            "the Hopper router kernel carries no packet-ledger lane, as the "
            "reference's Pallas step carries none. Use backend='auto' (a "
            "drain with the ledger runs the plain step on the same device) "
            "or drop the ledger.")
    if backend == "auto":
        return "cuda" if device.type == "cuda" and not track else "plain"
    if backend == "cuda" and device.type != "cuda":
        raise ValueError("backend='cuda' runs the Hopper router kernel and "
                         f"needs CUDA tensors; the traffic is on {device}")
    return backend


def _run_chunk(state: SimState, ledger: Optional[Ledger], wire: Wire,
               mc_nodes: torch.Tensor, mesh_key, count_headers: bool,
               chunk: int, backend: str):
    """``chunk`` cycles: the tracked plain step when there is a ledger,
    else the kernel or the plain step. Returns ``(state, ledger)``."""
    from ..kernels import ops, ref
    if ledger is not None:
        for _ in range(chunk):
            state, ledger = tracked_step(state, ledger, wire, mc_nodes,
                                         mesh_key, count_headers)
        return state, ledger
    step = ref.router_step_ref if backend == "plain" else ops.router_step
    return step(state, wire, mc_nodes, chunk, mesh_key, count_headers), None


def _validate_fields(cfg: NocConfig, traffic: Traffic) -> None:
    """Range-check the fields that feed packed sidebands."""
    if not traffic.dest.numel():
        return
    dmax = int(traffic.dest.max())
    if dmax >= cfg.num_routers:
        raise ValueError(f"traffic dest {dmax} out of range for a "
                         f"{cfg.num_routers}-router config")
    vmax = int(traffic.vc.max())
    if vmax >= cfg.num_vcs:
        raise ValueError(f"traffic vc {vmax} out of range for a "
                         f"{cfg.num_vcs}-VC config")


def _mc_array(cfg: NocConfig, traffic: Traffic, m: int,
              batched: bool) -> np.ndarray:
    """Per-stream injection node ids padded to ``m``; padding streams must be
    empty."""
    if m < cfg.num_mcs:
        raise ValueError(
            f"traffic has {m} MC streams, config has {cfg.num_mcs}")
    length = traffic.length.cpu().numpy()
    pad = length[..., cfg.num_mcs:] if batched else length[cfg.num_mcs:]
    if m > cfg.num_mcs and np.any(pad != 0):
        raise ValueError(
            f"traffic has {m} MC streams for a {cfg.num_mcs}-MC config and "
            "the extra streams are not empty padding")
    return np.asarray(tuple(cfg.mc_nodes) + (0,) * (m - cfg.num_mcs),
                      np.int32)


def _result(leaves, total: int, times=None) -> SimResult:
    (link_bt, link_flits, inj_bt, ejected, cycle, drained_at) = leaves
    drain = int(drained_at)
    inj_time, eject_time = times if times is not None else (None, None)
    return SimResult(
        cycles=int(cycle), ejected=int(ejected), injected=total,
        link_bt=link_bt, link_flits=link_flits, inj_bt=inj_bt,
        total_bt=int(link_bt.sum() + inj_bt.sum()),
        inter_router_bt=int(link_bt[:, :PORT_LOCAL].sum()),
        drain_cycle=drain if drain >= 0 else int(cycle),
        inj_time=inj_time, eject_time=eject_time)


def _conservation_error(length: np.ndarray, meta: np.ndarray,
                        pkt: np.ndarray, eject_pkt: np.ndarray,
                        npkt: int) -> Optional[str]:
    """Check every injected pkt id ejected exactly once; None when clean
    (a copy of the reference's)."""
    valid = np.arange(meta.shape[1])[None, :] < length[:, None]
    tails = valid & ((meta & META_TAIL) > 0)
    injected = np.bincount(pkt[tails].reshape(-1), minlength=npkt)[:npkt]
    ejected = eject_pkt[:npkt]
    bad_inj = np.flatnonzero(injected > 1)
    if bad_inj.size:
        return (f"packet ids injected more than once: {bad_inj[:8].tolist()}"
                f" (counts {injected[bad_inj[:8]].tolist()})")
    present = injected > 0
    bad = np.flatnonzero(ejected[present] != 1)
    if bad.size:
        ids = np.flatnonzero(present)[bad]
        return (f"packet ids not ejected exactly once: {ids[:8].tolist()}"
                f" (eject counts {ejected[ids[:8]].tolist()})")
    stray = np.flatnonzero(~present & (ejected != 0))
    if stray.size:
        return f"ejections for never-injected packet ids: {stray[:8].tolist()}"
    return None


def _npkt(traffic: Traffic) -> int:
    """Packet ids to track: ``num_packets``, or ``pkt.max() + 1`` for a
    hand-built Traffic without it."""
    n = int(traffic.num_packets)
    if n >= 0:
        return n
    return int(traffic.pkt.max()) + 1 if traffic.pkt.numel() else 0


class _Snapshot:
    """Host copy of a small device tensor taken now, read later.

    On CUDA the copy goes to pinned memory behind an event, so the next
    chunk can be launched before the value is read (the pipelined driver of
    the reference, which dispatches chunk k+1 before reading chunk k's
    bookkeeping). On the CPU it is a plain copy.
    """

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t.clone()
            self._event = None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _checked_mc(cfg: NocConfig, mc_nodes, shape) -> np.ndarray:
    """Caller-given injection nodes as int32, shape- and range-checked."""
    mc = np.ascontiguousarray(np.asarray(mc_nodes, np.int32))
    if mc.shape != shape:
        raise ValueError(f"mc_nodes must have shape {shape}, got {mc.shape}")
    if mc.size and (mc.min() < 0 or mc.max() >= cfg.num_routers):
        raise ValueError("mc_nodes out of range for a "
                         f"{cfg.num_routers}-router config")
    return mc


def _lane_devices(devices, device: DeviceLike = None) -> List[torch.device]:
    """The devices a batched drain deals its lanes to, in shard order.

    ``devices=None``: ``[device]`` (CUDA unless the caller passes
    ``device="cpu"``). Otherwise a sequence of devices or device names, in
    which a device may repeat, or a 1-D mesh with a ``devices`` array and
    ``axis_names`` (``dist.sharding.LocalMesh``); ``device`` must then be
    None.
    """
    if devices is None:
        return [resolve_device(device)]
    if device is not None:
        raise ValueError("pass device= or devices=, not both")
    if hasattr(devices, "axis_names"):
        if len(devices.axis_names) != 1:
            raise ValueError("simulate_batch wants a 1-D device mesh, got "
                             f"axes {tuple(devices.axis_names)}")
        devices = list(np.asarray(devices.devices).flat)
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("devices= names no device")
    return devs


class _Shard(NamedTuple):
    """One device's contiguous block of a drain's lanes."""

    state: SimState
    ledger: Optional[Ledger]
    wire: Wire
    mc: torch.Tensor


def _blocks(rows: int, ndev: int) -> List[range]:
    """The rows of a ``rows``-lane batch (a multiple of ``ndev``) that each
    device holds: contiguous blocks in device order, the reference's
    ``P(axis)`` over the leading dim. Placement and compaction both deal
    lanes by this rule."""
    k = rows // ndev
    return [range(i * k, (i + 1) * k) for i in range(ndev)]


def _regroup(shards: List[_Shard], rows, devs) -> List[_Shard]:
    """Rows ``rows`` (indices into the batch that ``shards`` hold as equal
    contiguous blocks; a row may repeat) dealt over ``devs`` by
    :func:`_blocks`. A block that is one whole source shard, in order, is
    moved; every other block is gathered, so no two shards share memory
    (a compaction always narrows the blocks, so only a one-device
    placement moves a whole shard)."""
    rows = list(rows)
    k = int(shards[0].state.ejected.shape[0])
    src = [tree.leaves(sh) for sh in shards]
    out = []
    for dev, blk in zip(devs, _blocks(len(rows), len(devs))):
        runs = [(s, [r - s * k for r in grp]) for s, grp in itertools.groupby(
            (rows[i] for i in blk), key=lambda r: r // k)]
        leaves = []
        for j in range(len(src[0])):
            pieces = []
            for s, loc in runs:
                x = src[s][j]
                if loc != list(range(k)):
                    x = x.index_select(0, torch.as_tensor(loc,
                                                          device=x.device))
                pieces.append(x.to(dev))
            leaves.append(pieces[0] if len(pieces) == 1 else torch.cat(pieces))
        out.append(tree.unflatten(shards[0], leaves))
    return out


def _on(dev: torch.device):
    """Where a shard launches: under its CUDA device (a kernel launches on
    the current device's current stream); nothing to enter on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def _rows_np(parts) -> np.ndarray:
    """One leaf's shard parts, read to the host in batch-row order."""
    return np.concatenate([t.cpu().numpy() for t in parts])


def simulate_batch(cfg: NocConfig, traffic: Traffic, *,
                   count_headers: bool = True, max_cycles: int = 2_000_000,
                   chunk: int = 4096, check_conservation: bool = False,
                   timestamps: bool = False, devices=None, mc_nodes=None,
                   retire: bool = True, backend: str = "auto",
                   compact_ratio: float = 0.5,
                   device: DeviceLike = None) -> List[SimResult]:
    """Drain B traffic variants (leading axis) together.

    The driver of ``repro.noc.sim.simulate_batch``: chunks of ``chunk``
    cycles, pipelined (chunk k+1 is launched before chunk k's ejected counts
    are read), lanes retire at their exact ``drain_cycle`` and the live
    lanes are compacted into a narrower power-of-two batch once
    ``live <= compact_ratio * rows`` (0.5, the reference's default, halves;
    0.0 never compacts; ``noc.tune`` measures the alternatives).
    ``retire=False``: no lane retires, every lane steps until the slowest
    one drains (``cycles`` then reads the last chunk's for every lane). The
    traffic is moved to ``device`` (CUDA unless the caller passes
    ``device="cpu"``). ``backend``: ``"auto"`` (the Hopper kernel on CUDA,
    the plain step on the CPU), ``"plain"`` or ``"cuda"``.

    ``devices``: deal the lanes over several devices - a sequence of
    devices or device names, in which a device may repeat (lanes never talk
    to each other, so two shards on one device are still two shards), or a
    1-D ``dist.sharding.LocalMesh`` - instead of ``device``. The batch is
    padded with empty lanes to a multiple of the shard count and split into
    contiguous blocks, each shard's state, wire and ``mc`` rows on its own
    device; every chunk launches each shard, CUDA shards first (the kernel
    under that device, on its current stream; a CPU shard runs the plain
    step), and then reads the ejected counts back. Compaction keeps a
    multiple of the shard count and re-deals the survivors by the same
    blocks. Results, ledgers and timeouts are the single-device drain's,
    bit for bit. ``None`` or one device is the plain driver on that device.

    ``check_conservation``: track tail ejections per packet id and raise
    ``RuntimeError`` unless every injected id ejects exactly once.
    ``timestamps``: each result carries its packets' ``inj_time`` and
    ``eject_time``. Either arms the packet ledger, which only the plain
    step carries: ``auto`` then runs the plain step on every shard's
    device, and ``cuda`` raises. Results are the same with and without the
    ledger.
    """
    if not 0.0 <= compact_ratio <= 1.0:
        raise ValueError(f"compact_ratio must be in [0, 1], "
                         f"got {compact_ratio!r}")
    devs = _lane_devices(devices, device)
    if traffic.length.dim() != 2:
        raise ValueError("simulate_batch wants a leading variants axis; "
                         "use simulate() for a single Traffic")
    want_ledger = check_conservation or timestamps
    bks = [_resolve_backend(backend, d, want_ledger) for d in devs]
    b, m = traffic.length.shape
    if mc_nodes is None:
        mc = np.broadcast_to(_mc_array(cfg, traffic, m, batched=True),
                             (b, m)).copy()
    else:
        mc = _checked_mc(cfg, mc_nodes, (b, m))
    _validate_fields(cfg, traffic)
    npkt = _npkt(traffic) if want_ledger else 0
    track = npkt > 0
    lengths_host = traffic.length.cpu().numpy()
    totals = lengths_host.sum(axis=1).astype(np.int64)
    ndev, dev0 = len(devs), devs[0]
    wire = fuse_traffic(Traffic(*(t.to(dev0) for t in traffic[:6]),
                                num_packets=traffic.num_packets), track)
    # Empty lanes (zero length, zero mc rows, zero totals) pad the batch to
    # a multiple of the shard count; they drain at once.
    bp = -(-b // ndev) * ndev
    if bp != b:
        wire = Wire(*(torch.cat([x, x.new_zeros((bp - b,) + x.shape[1:])])
                      for x in wire))
        mc = np.concatenate([mc, np.zeros((bp - b, m), np.int32)])
        totals = np.concatenate([totals, np.zeros(bp - b, np.int64)])
    shards = _regroup([_Shard(
        make_state(cfg, m, batch=bp, device=dev0, track=track),
        make_ledger(npkt, bp, timestamps, dev0) if track else None, wire,
        torch.as_tensor(mc, dtype=torch.int32, device=dev0))], range(bp), devs)
    del wire
    key = _mesh_key(cfg)
    # CUDA shards launch first: the card works while a CPU shard steps.
    order = sorted(range(ndev), key=lambda i: devs[i].type != "cuda")

    def snap(shs):
        out = [None] * ndev
        for i in order:
            with _on(devs[i]):
                out[i] = _Snapshot(shs[i].state.ejected)
        return out

    def run(shs):
        out = list(shs)
        for i in order:
            sh = shs[i]
            with _on(devs[i]):
                st, lg = _run_chunk(sh.state, sh.ledger, sh.wire, sh.mc, key,
                                    count_headers, chunk, bks[i])
            out[i] = sh._replace(state=st, ledger=lg)
        return out, snap(out)

    def read_ejected(snaps) -> np.ndarray:
        return np.concatenate([s.numpy() for s in snaps])

    harvested = {}      # lane id -> host bookkeeping leaves
    ledgers = {}        # lane id -> host ledger rows

    def harvest(shs, pairs):
        leaves = [_rows_np(getattr(sh.state, f) for sh in shs)
                  for f in ("link_bt", "link_flits", "inj_bt", "ejected",
                            "cycle", "drained_at")]
        books = None
        if shs[0].ledger is not None:
            books = [None if x is None
                     else _rows_np(sh.ledger[j] for sh in shs)
                     for j, x in enumerate(shs[0].ledger)]
        for lane, row in pairs:
            harvested[lane] = tuple(a[row] for a in leaves)
            if books is not None:
                ledgers[lane] = [None if x is None else x[row] for x in books]

    if totals.sum() == 0:   # empty traffic: nothing to drain
        harvest(shards, [(lane, lane) for lane in range(bp)])
    else:
        live = list(range(bp))                  # lanes still draining
        prim = {lane: lane for lane in live}    # lane -> batch row
        shards, ej = run(shards)
        nch = 1
        while True:
            shards2, ej2 = run(shards)
            nch += 1
            e = read_ejected(ej)                # ejected after chunk nch-1
            done = [lane for lane in live if e[prim[lane]] >= totals[lane]]
            if len(done) == len(live):
                harvest(shards2, [(lane, prim[lane]) for lane in live])
                break
            if (nch - 1) * chunk >= max_cycles:
                lag = sorted(set(live) - set(done))
                row = prim[lag[0]]
                k = int(shards2[0].state.ejected.shape[0])
                st = shards2[row // k].state
                e2 = read_ejected(ej2)
                raise _drain_timeout(
                    f"NoC variants {lag} "
                    f"({[int(e2[prim[x]]) for x in lag]}/"
                    f"{[int(totals[x]) for x in lag]} flits; "
                    f"diagnostic for variant {lag[0]})",
                    nch * chunk, int(e2[row]), int(totals[lag[0]]),
                    st.count[row % k].cpu().numpy(),
                    st.inj_ptr[row % k].cpu().numpy(), lengths_host[lag[0]])
            if retire and done:
                harvest(shards2, [(lane, prim[lane]) for lane in done])
                gone = set(done)
                live = [lane for lane in live if lane not in gone]
                cur = len(e)
                target = -(-_next_pow2(len(live)) // ndev) * ndev
                if len(live) <= int(cur * compact_ratio) and target < cur:
                    keep = [prim[lane] for lane in live]
                    shards2 = _regroup(
                        shards2, keep + [keep[0]] * (target - len(keep)),
                        devs)
                    ej2 = snap(shards2)
                    prim = {lane: i for i, lane in enumerate(live)}
            shards, ej = shards2, ej2

    if check_conservation and track:
        length = lengths_host
        meta = traffic.meta.cpu().numpy()
        pkt = traffic.pkt.cpu().numpy()
        for i in range(b):
            err = _conservation_error(length[i], meta[i], pkt[i],
                                      ledgers[i][0], npkt)
            if err:
                raise RuntimeError(
                    f"packet conservation violated (variant {i}): {err}")
    return [_result(harvested[i], int(totals[i]),
                    _times(ledgers.get(i), npkt, timestamps))
            for i in range(b)]


def _times(books, npkt: int, timestamps: bool):
    """``(inj_time, eject_time)`` of one lane's host ledger rows, cut to
    the packet ids (empty without packets), or None without timestamps."""
    if not timestamps:
        return None
    if books is None:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32))
    return books[1][:npkt], books[2][:npkt]


def simulate(cfg: NocConfig, traffic: Traffic, *, count_headers: bool = True,
             max_cycles: int = 2_000_000, chunk: int = 4096,
             check_conservation: bool = False, timestamps: bool = False,
             mc_nodes=None, backend: str = "auto",
             device: DeviceLike = None) -> SimResult:
    """Run the NoC until one Traffic drains; per-link BT counts.

    ``mc_nodes``: optional per-stream injection-node ids (``cfg.mc_nodes``
    by default). ``check_conservation``, ``timestamps``, ``backend`` and
    ``device`` as in :func:`simulate_batch`.
    """
    dev = resolve_device(device)
    if traffic.length.dim() != 1:
        raise ValueError("simulate wants an unbatched Traffic; use "
                         "simulate_batch() for a variants axis")
    m = int(traffic.length.shape[0])
    if mc_nodes is None:
        mc = _mc_array(cfg, traffic, m, batched=False)
    else:
        mc = _checked_mc(cfg, mc_nodes, (m,))
    _validate_fields(cfg, traffic)
    want_ledger = check_conservation or timestamps
    bk = _resolve_backend(backend, dev, want_ledger)
    npkt = _npkt(traffic) if want_ledger else 0
    track = npkt > 0
    batched = Traffic(*(t[None].to(dev) for t in traffic[:6]),
                      num_packets=traffic.num_packets)
    wire = fuse_traffic(batched, track)
    mc_dev = torch.as_tensor(mc[None], dtype=torch.int32, device=dev)
    state = make_state(cfg, m, batch=1, device=dev, track=track)
    ledger = make_ledger(npkt, 1, timestamps, dev) if track else None
    total = int(traffic.length.sum())
    while total:    # empty traffic: nothing to drain (and T may be 0)
        state, ledger = _run_chunk(state, ledger, wire, mc_dev,
                                   _mesh_key(cfg), count_headers, chunk, bk)
        if (int(state.ejected[0]) == total
                or int(state.cycle[0]) >= max_cycles):
            break
    books = ([None if x is None else x[0].cpu().numpy() for x in ledger]
             if track else None)
    if int(state.ejected[0]) != total:
        raise _drain_timeout(
            "NoC", int(state.cycle[0]), int(state.ejected[0]), total,
            state.count[0].cpu().numpy(), state.inj_ptr[0].cpu().numpy(),
            traffic.length.cpu().numpy(),
            eject_pkt=books[0] if track else None, npkt=npkt)
    if check_conservation and track:
        err = _conservation_error(
            traffic.length.cpu().numpy(), traffic.meta.cpu().numpy(),
            traffic.pkt.cpu().numpy(), books[0], npkt)
        if err:
            raise RuntimeError(f"packet conservation violated: {err}")
    return _result((state.link_bt[0].cpu().numpy(),
                    state.link_flits[0].cpu().numpy(),
                    state.inj_bt[0].cpu().numpy(), state.ejected[0],
                    state.cycle[0], state.drained_at[0]), total,
                   _times(books, npkt, timestamps))
