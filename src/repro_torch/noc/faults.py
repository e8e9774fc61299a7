"""Fault injection for the NoC: soft errors, dead links, protection, retry.

The port of ``repro.noc.faults`` (see its docstring and DESIGN.md "Fault
model & protection"). Two axes:

* **Transient faults** - a seeded per-link soft-error process flips one
  payload bit of a traversing flit with probability ``rate`` per flit-hop,
  inside the router step and before the BT recorders. The schedule is a
  pure counter hash of ``(seed, cycle, link)``: replays are bit-exact, and
  a lower rate's flips are a subset of a higher rate's.
* **Permanent faults** - ``dead_links`` / ``dead_routers`` are masked out
  of the routing table before the run (``topology.fault_route_table``);
  packets whose destination became unreachable are dropped before
  injection with ``STATUS_DROPPED``.

Protection (``none | parity | crc8``) stamps each flit's code into sideband
bits 16+ (:func:`protect_wire`) and the step re-derives it at ejection.
Both codes are linear with zero init, so detection depends on the flip mask
alone, never on the payload: a fault drain's timing (cycles, retries,
statuses) is schedule-determined, and the O0/O1/O2 variants of one traffic
drain in lockstep as lanes of one batch (:func:`simulate_faulty_batch`).
Detected corrupt packets are retransmitted from their clean flits
(:func:`drain_with_retries`) under a bounded retry budget with exponential
ACK backoff.

The faulty step is the tracked plain step (``sim.tracked_step(faults=)``)
on the traffic's device: the Hopper router kernel has no fault hooks and
no ledger, as the reference's Pallas step has none.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.wire import (PROTECTION_BITS, protection_overhead_bits,
                         protection_syndrome_masks)
from .online import FAR_RELEASE, _drain_gated, _lanes_agree
from .sim import (META_TAIL, SimResult, Traffic, Wire, _checked_mc,
                  _mc_array, _next_pow2, protection_code)
from .topology import NocConfig, fault_route_table
from .traffic import filter_packets, stack_traffics

__all__ = [
    "FaultModel", "StepFaults", "FaultDrain",
    "STATUS_DELIVERED", "STATUS_DROPPED", "STATUS_RETRY_EXHAUSTED",
    "STATUS_UNSENT",
    "protect_wire", "drain_with_retries", "simulate_faulty",
    "simulate_faulty_batch",
]

# Per-packet terminal status: the four values partition every packet id,
# and the ledger asserts ``delivered + dropped + retry_exhausted + unsent
# == injected_packets``.
STATUS_DELIVERED = 0        # tail ejected, last transmission clean/undetected
STATUS_DROPPED = 1          # destination unreachable under hard faults
STATUS_RETRY_EXHAUSTED = 2  # still detected-corrupt after the retry budget
STATUS_UNSENT = 3           # never delivered: gated off, truncated, or its
                            # retry never completed


class StepFaults(NamedTuple):
    """Hashable static fault spec threaded into the faulty step (and the
    cache key of its constants)."""

    rate: float
    seed: int
    protect: str
    dead_links: Tuple[Tuple[int, int], ...]
    dead_routers: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """One fault-injection scenario (deterministic given ``seed``).

    rate: per-flit-hop single-bit soft-error probability (NI links and
        router output links alike).
    protect: flit protection scheme (``core.wire.PROTECTION_BITS``), its
        bits charged on *transmitted* flits, retries included.
    dead_links: ``(router, port)`` output links that are permanently dead
        (both directions of the channel die together).
    dead_routers: routers whose every channel is dead.
    max_retries: retransmission budget per packet beyond the first send.
    ack_latency: cycles from tail ejection to the NACK reaching the
        source NI (round 1 re-release = eject + ack_latency).
    backoff: multiplicative ACK-latency backoff per retry round.
    """

    rate: float = 0.0
    seed: int = 0
    protect: str = "none"
    dead_links: Tuple[Tuple[int, int], ...] = ()
    dead_routers: Tuple[int, ...] = ()
    max_retries: int = 3
    ack_latency: int = 32
    backoff: int = 2

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"fault rate must be in [0, 1], got {self.rate!r}")
        if self.protect not in PROTECTION_BITS:
            raise ValueError(f"unknown protection scheme {self.protect!r}; "
                             f"supported: {sorted(PROTECTION_BITS)}")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.ack_latency < 0:
            raise ValueError("ack_latency must be >= 0")
        if self.backoff < 1:
            raise ValueError("backoff must be >= 1")
        object.__setattr__(self, "dead_links",
                           tuple((int(r), int(p)) for r, p in self.dead_links))
        object.__setattr__(self, "dead_routers",
                           tuple(int(r) for r in self.dead_routers))

    @property
    def is_null(self) -> bool:
        """True when the model injects nothing and protects nothing."""
        return (self.rate == 0.0 and self.protect == "none"
                and not self.dead_links and not self.dead_routers)

    @property
    def has_hard_faults(self) -> bool:
        return bool(self.dead_links or self.dead_routers)

    def static(self) -> StepFaults:
        return StepFaults(float(self.rate), int(self.seed), self.protect,
                          self.dead_links, self.dead_routers)

    def overhead_bits(self, num_flits: int) -> int:
        return protection_overhead_bits(self.protect, num_flits)


def protect_wire(wire: Wire, protect: str, lanes: int) -> Wire:
    """Stamp each flit's protection code into sideband bits ``16..``,
    computed over the payload lanes with the syndrome masks the step's
    ejection check uses, so a clean flit always verifies. The sideband is
    outside the BT recorders; the bits are charged analytically."""
    if not PROTECTION_BITS[protect]:
        return wire
    masks = torch.tensor(protection_syndrome_masks(protect, lanes),
                         device=wire.wire.device)
    pay = wire.wire[..., :lanes]
    side = (wire.wire[..., lanes]
            | (protection_code(pay, masks) << 16).to(torch.int32))
    return Wire(torch.cat([pay, side[..., None], wire.wire[..., lanes + 1:]],
                          dim=-1), wire.length)


@dataclasses.dataclass
class FaultDrain:
    """One fault drain: cumulative recorders plus per-packet outcomes.

    ``sim`` accumulates link / NI BT over every transmission round;
    ``status`` is the terminal ``STATUS_*`` per packet; ``corrupted`` marks
    silent corruption among delivered packets; ``ledger`` carries the
    conservation identity and the per-round breakdown.
    """

    sim: SimResult
    inj_time: np.ndarray        # (NP,) first-injection cycles
    eject_time: np.ndarray      # (NP,) last tail-ejection cycle, -1 never
    eject_counts: np.ndarray    # (NP+1,) tail ejections per packet id
    status: np.ndarray          # (NP,) int32 STATUS_*
    corrupted: np.ndarray       # (NP,) bool silent corruption
    retries: np.ndarray         # (NP,) int32 retransmissions used
    rounds: list                # per-round dict breakdown
    ledger: dict
    drained: bool


def _geometry(traffic: Traffic):
    """Host ``(meta, pkt, dest, length)`` of variant 0 of lockstep
    variants (the packets every variant shares)."""
    one = traffic.variant(0)
    return tuple(x.cpu().numpy() for x in (one.meta, one.pkt, one.dest,
                                           one.length))


def _packet_endpoints(traffic: Traffic, mc_nodes: np.ndarray,
                      npkt: int) -> Tuple[np.ndarray, np.ndarray]:
    """(source_router, dest_router) per packet id (-1 for absent ids)."""
    meta, pkt, dest, length = _geometry(traffic)
    valid = np.arange(meta.shape[1])[None, :] < length[:, None]
    tails = valid & ((meta & META_TAIL) > 0)
    rows, _ = np.nonzero(tails)
    psrc = np.full(npkt, -1, np.int64)
    pdst = np.full(npkt, -1, np.int64)
    ids = pkt[tails]
    psrc[ids] = np.asarray(mc_nodes, np.int64)[rows]
    pdst[ids] = dest[tails]
    return psrc, pdst


def _gate_counts(traffic: Traffic, keepf: np.ndarray,
                 inc: np.ndarray) -> np.ndarray:
    """Kept-flit count per (stream, gate) after a flit keep-mask: gate k
    still unlocks exactly its own surviving flits once ``filter_packets``
    compacts the stream (compaction keeps the order)."""
    inc = np.asarray(inc, np.int64)
    m, k = inc.shape
    cum = np.cumsum(inc, axis=1)
    pos = np.arange(keepf.shape[1])
    out = np.zeros((m, k), np.int64)
    for i in range(m):
        gates = np.searchsorted(cum[i], pos, side="right")
        np.add.at(out[i], np.clip(gates[keepf[i]], 0, k - 1), 1)
    return out


def _per_packet_gates(traffic: Traffic, release_per_pkt: np.ndarray,
                      npkt: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-packet gates for a retry round: gate j of stream m unlocks that
    stream's j-th retried packet at its NACK-derived release cycle,
    monotone along the stream (the NI retransmit queue is in order). Gate
    counts are padded to a power of two, as the reference pads them."""
    meta, pkt, _, length = _geometry(traffic)
    m, t = meta.shape
    valid = np.arange(t)[None, :] < length[:, None]
    tails = valid & ((meta & META_TAIL) > 0)
    kmax = int(tails.sum(axis=1).max()) if m else 0
    kpad = _next_pow2(max(kmax, 1))
    inc = np.zeros((m, kpad), np.int64)
    rel = np.full((m, kpad), int(FAR_RELEASE), np.int64)
    for i in range(m):
        tpos = np.flatnonzero(tails[i])
        if not tpos.size:
            continue
        counts = np.diff(np.concatenate([[-1], tpos]))
        ids = pkt[i, tpos]
        inc[i, :ids.size] = counts
        rel[i, :ids.size] = release_per_pkt[ids]
    rel = np.maximum.accumulate(np.minimum(rel, int(FAR_RELEASE)), axis=1)
    return inc, rel


def _filter(traffic: Traffic, keep_ids) -> Traffic:
    """``filter_packets`` on each lockstep variant (the same flits survive
    in every variant)."""
    return stack_traffics([filter_packets(traffic.variant(i), keep_ids)
                           for i in range(traffic.length.shape[0])])


def _check_lockstep(traffic: Traffic) -> None:
    """Lockstep variants differ in their payload words alone."""
    for name in ("dest", "meta", "vc", "pkt", "length"):
        x = getattr(traffic, name)
        if not bool((x == x[:1]).all()):
            raise ValueError(f"fault-drain variants must share their "
                             f"packets: {name} differs between variants")


def _drain_with_retries(cfg: NocConfig, traffic: Traffic, model: FaultModel,
                        mc_nodes: np.ndarray, release, inc,
                        count_headers: bool, chunk: int, max_cycles: int,
                        allow_truncation: bool, backend: str,
                        controller=None) -> List[FaultDrain]:
    """The retry loop of :func:`drain_with_retries` over the lanes of a
    batched Traffic (lockstep variants); one FaultDrain a lane.
    ``controller`` (one lane only) is consulted in round 0."""
    npkt = int(traffic.num_packets)
    m = int(traffic.length.shape[-1])
    spec = model.static()
    status = np.full(npkt, STATUS_UNSENT, np.int32)
    base = traffic
    if release is None:
        rel0 = np.zeros((m, 1), np.int64)
        inc0 = _geometry(traffic)[3].astype(np.int64)[:, None]
    else:
        rel0 = np.asarray(release, np.int64)
        inc0 = np.asarray(inc, np.int64)

    # --- hard-fault reachability precheck: drop before injecting.
    if model.has_hard_faults:
        _, reachable = fault_route_table(cfg, spec.dead_links,
                                         spec.dead_routers)
        psrc, pdst = _packet_endpoints(traffic, mc_nodes, npkt)
        present = psrc >= 0
        dead_r = np.zeros(cfg.num_routers, bool)
        if spec.dead_routers:
            dead_r[list(spec.dead_routers)] = True
        s0, d0 = np.clip(psrc, 0, None), np.clip(pdst, 0, None)
        dropped = present & (~reachable[s0, d0] | dead_r[s0] | dead_r[d0])
        if dropped.any():
            status[dropped] = STATUS_DROPPED
            meta, pkt, _, length = _geometry(traffic)
            valid = np.arange(meta.shape[1])[None, :] < length[:, None]
            keepf = valid & ~dropped[np.clip(pkt, 0, npkt - 1)]
            inc0 = _gate_counts(traffic, keepf, inc0)
            base = _filter(traffic, ~dropped)

    # --- never-release prefilter: gates pinned at FAR_RELEASE hold their
    # flits forever, so those packets stay STATUS_UNSENT and do not count
    # toward the drain target. Skipped under a controller, whose gates all
    # start at the far sentinel and open as arrivals are admitted.
    if controller is None and (np.asarray(rel0) >= int(FAR_RELEASE)).any():
        inc_arr = np.asarray(inc0, np.int64)
        cum = np.cumsum(inc_arr, axis=1)
        ngates = inc_arr.shape[1]
        meta, pkt, _, length = _geometry(base)
        pos = np.arange(meta.shape[1])
        valid = pos[None, :] < length[:, None]
        openg = np.asarray(rel0) < int(FAR_RELEASE)
        keepf = np.zeros_like(valid)
        for i in range(m):
            gates = np.searchsorted(cum[i], pos, side="right")
            keepf[i] = valid[i] & openg[i][np.clip(gates, 0, ngates - 1)]
        if not keepf[valid].all():
            keep_pkt = np.zeros(npkt, bool)
            keep_pkt[np.unique(pkt[keepf])] = True
            inc0 = _gate_counts(base, keepf, inc_arr)
            base = _filter(base, keep_pkt)

    sent = np.zeros(npkt, bool)
    _, pkt0, _, length0 = _geometry(base)
    valid0 = np.arange(pkt0.shape[1])[None, :] < length0[:, None]
    sent[np.unique(pkt0[valid0])] = True

    cur, cur_rel, cur_inc = base, rel0, inc0
    state = None
    prev_flip = np.zeros(npkt, np.int64)
    prev_bad = np.zeros(npkt, np.int64)
    prev_ep = np.zeros(npkt, np.int64)
    final_bad = np.zeros(npkt, np.int64)   # detections in the final round
    last_dep = np.zeros(npkt, np.int64)    # ejections in the final round
    final_flip = np.zeros(npkt, np.int64)
    retries = np.zeros(npkt, np.int32)
    tx_mask = sent.copy()                  # packets transmitted this round
    total_tx_flits = 0
    rounds = []
    drained = True
    res = inj_t = ej_t = ep_full = None

    for rnd in range(model.max_retries + 1):
        flits = int(_geometry(cur)[3].sum())
        total_tx_flits += flits
        res, inj_t, ej_t, ep_full, rnd_drained, state = _drain_gated(
            cfg, cur, mc_nodes, cur_rel, cur_inc,
            count_headers=count_headers, chunk=chunk, max_cycles=max_cycles,
            allow_truncation=allow_truncation, faults=spec, state=state,
            controller=controller if rnd == 0 else None, backend=backend)
        drained = drained and rnd_drained
        lg = state[1]
        flip_now, bad_now = (
            _lanes_agree(list(x.cpu().numpy()), what)[:npkt].astype(np.int64)
            for x, what in ((lg.flip_pkt, "flip_pkt"),
                            (lg.bad_pkt, "bad_pkt")))
        ep_now = ep_full[:npkt].astype(np.int64)
        dflip = flip_now - prev_flip
        dbad = bad_now - prev_bad
        dep = ep_now - prev_ep
        prev_flip, prev_bad, prev_ep = flip_now, bad_now, ep_now
        tx = np.flatnonzero(tx_mask)
        final_bad[tx] = dbad[tx]
        final_flip[tx] = dflip[tx]
        last_dep[tx] = dep[tx]
        bad_ids = tx[dbad[tx] > 0]
        rounds.append({
            "round": rnd,
            "packets": int(tx.size),
            "flits": flits,
            "flip_events": int(dflip.sum()),
            "detected_bad_flits": int(dbad.sum()),
            "corrupt_packets": int(bad_ids.size),
            "drain_cycle": res[0].drain_cycle,
        })
        if controller is not None and controller.restart_needed:
            # Admission restart protocol: the caller replays the whole
            # fault drain with the enlarged shed set and discards this one.
            drained = False
            break
        if not rnd_drained or not bad_ids.size or rnd == model.max_retries:
            break
        retries[bad_ids] += 1
        cur = _filter(base, bad_ids)
        delay = model.ack_latency * model.backoff ** rnd
        per_pkt_rel = np.full(npkt, int(FAR_RELEASE), np.int64)
        per_pkt_rel[bad_ids] = ej_t[bad_ids].astype(np.int64) + delay
        cur_inc, cur_rel = _per_packet_gates(cur, per_pkt_rel, npkt)
        tx_mask = np.zeros(npkt, bool)
        tx_mask[bad_ids] = True
        # Re-arm the injection pointers for the round's fresh wire; every
        # other leaf (recorders, ledgers, link state, cycle) carries over.
        st, lg = state
        state = (st._replace(inj_ptr=torch.zeros_like(st.inj_ptr)), lg)

    delivered = sent & (last_dep > 0) & (final_bad == 0)
    exhausted = sent & (last_dep > 0) & (final_bad > 0)
    status[delivered] = STATUS_DELIVERED
    status[exhausted] = STATUS_RETRY_EXHAUSTED
    corrupted = delivered & (final_flip > 0)

    counts = {
        "delivered": int((status == STATUS_DELIVERED).sum()),
        "dropped": int((status == STATUS_DROPPED).sum()),
        "retry_exhausted": int((status == STATUS_RETRY_EXHAUSTED).sum()),
        "unsent": int((status == STATUS_UNSENT).sum()),
    }
    ledger = {
        "injected_packets": npkt,
        **counts,
        "conservation_ok": sum(counts.values()) == npkt,
        "silent_corrupt": int(corrupted.sum()),
        "flip_events": int(prev_flip.sum()),
        "detected_bad_flits": int(prev_bad.sum()),
        "tail_ejections": int(prev_ep.sum()),
        "retried_packets": int((retries > 0).sum()),
        "total_retries": int(retries.sum()),
        "transmission_rounds": len(rounds),
        "transmitted_flits": total_tx_flits,
        "protection_overhead_bits":
            protection_overhead_bits(model.protect, total_tx_flits),
        "drained": drained,
    }
    return [FaultDrain(
        sim=dataclasses.replace(r, injected=total_tx_flits),
        inj_time=inj_t.copy(), eject_time=ej_t.copy(),
        eject_counts=ep_full.copy(), status=status.copy(),
        corrupted=corrupted.copy(), retries=retries.copy(),
        rounds=[dict(x) for x in rounds], ledger=dict(ledger),
        drained=drained) for r in res]


def _lanes_on(traffic: Traffic, device: DeviceLike) -> Traffic:
    """The traffic on ``device``, with a leading variants axis (an
    unbatched Traffic becomes a batch of one)."""
    dev = resolve_device(device)
    lead = (lambda t: t[None]) if traffic.length.dim() == 1 else (
        lambda t: t)
    return Traffic(*(lead(t).to(dev) for t in traffic[:6]),
                   num_packets=traffic.num_packets)


def drain_with_retries(cfg: NocConfig, traffic: Traffic, model: FaultModel, *,
                       mc_nodes: Union[np.ndarray, Sequence[int]],
                       release: Optional[np.ndarray] = None,
                       inc: Optional[np.ndarray] = None,
                       count_headers: bool = True, chunk: int = 2048,
                       max_cycles: int = 2_000_000,
                       allow_truncation: bool = False,
                       controller=None, backend: str = "auto",
                       device: DeviceLike = None) -> FaultDrain:
    """Drain ``traffic`` under ``model`` with bounded retransmission.

    Round 0 sends everything the hard-fault reachability precheck admits
    (unreachable packets are ``STATUS_DROPPED`` up front, their flits
    removed and their gate budgets shrunk). After each round, packets whose
    protection check flagged a corrupt flit are rebuilt from the clean
    source flits and re-released at ``eject + ack_latency *
    backoff**round`` through the same gated step, the state carried
    forward (injection pointers zeroed), so recorders, cycle count and
    ledgers accumulate. A round starts where the last one stopped, at a
    chunk boundary: ``chunk`` is part of the drain's semantics.
    ``max_cycles`` is a whole-drain budget.

    release / inc: optional ``(M, K)`` gate schedule for round 0; default
        one gate per stream, open at cycle 0 (the offline drain).
    controller: an admission controller (``online._AdmissionController``),
        consulted in round 0 only: retries of admitted packets are never
        shed. When it needs a restart the drain stops with ``drained``
        false, for the caller to replay.
    backend: ``auto`` or ``plain`` run the tracked plain step on
        ``device`` (CUDA unless the caller passes ``device="cpu"``);
        ``cuda`` raises (the router kernel has no fault hooks).
    """
    npkt = int(traffic.num_packets)
    if npkt <= 0:
        raise ValueError("fault drains need Traffic with num_packets set")
    if traffic.words.dim() != 3:
        raise ValueError("fault drains take unbatched Traffic")
    m = int(traffic.length.shape[0])
    mc = _checked_mc(cfg, mc_nodes, (m,))
    return _drain_with_retries(
        cfg, _lanes_on(traffic, device), model, mc, release, inc,
        count_headers, chunk, max_cycles, allow_truncation, backend,
        controller)[0]


def simulate_faulty(cfg: NocConfig, traffic: Traffic, model: FaultModel, *,
                    mc_nodes: Optional[Sequence[int]] = None,
                    count_headers: bool = True, chunk: int = 2048,
                    max_cycles: int = 2_000_000,
                    allow_truncation: bool = False, backend: str = "auto",
                    device: DeviceLike = None) -> FaultDrain:
    """Offline fault drain: every gate open at cycle 0, one retry loop
    around the gated step. ``model.is_null`` reproduces ``simulate``'s
    BT and drain figures exactly. ``mc_nodes``: per-stream injection
    nodes, ``cfg.mc_nodes`` by default (the reference ignores the
    argument, ROADMAP C14)."""
    if traffic.length.dim() != 1:
        raise ValueError("simulate_faulty wants an unbatched Traffic; use "
                         "simulate_faulty_batch() for lockstep variants")
    m = int(traffic.length.shape[0])
    nodes = (_mc_array(cfg, traffic, m, batched=False) if mc_nodes is None
             else mc_nodes)
    return drain_with_retries(
        cfg, traffic, model, mc_nodes=nodes, count_headers=count_headers,
        chunk=chunk, max_cycles=max_cycles,
        allow_truncation=allow_truncation, backend=backend, device=device)


def simulate_faulty_batch(cfg: NocConfig, traffic: Traffic,
                          model: FaultModel, *,
                          mc_nodes: Optional[Sequence[int]] = None,
                          count_headers: bool = True, chunk: int = 2048,
                          max_cycles: int = 2_000_000,
                          allow_truncation: bool = False,
                          backend: str = "auto",
                          device: DeviceLike = None) -> List[FaultDrain]:
    """:func:`simulate_faulty` of each variant of a batched Traffic whose
    variants share their packets (lengths, dests, VCs, ids; the O0/O1/O2
    orderings of one traffic), drained together as lanes of one batch.
    The schedule reads no payload value, so every variant's drain is the
    one :func:`simulate_faulty` gives it (the lanes are checked to agree
    on every ledger); only the BT recorders differ."""
    if traffic.length.dim() != 2:
        raise ValueError("simulate_faulty_batch wants a leading variants "
                         "axis; use simulate_faulty() for a single Traffic")
    if int(traffic.num_packets) <= 0:
        raise ValueError("fault drains need Traffic with num_packets set")
    _check_lockstep(traffic)
    m = int(traffic.length.shape[1])
    mc = (_mc_array(cfg, traffic, m, batched=True) if mc_nodes is None
          else _checked_mc(cfg, mc_nodes, (m,)))
    return _drain_with_retries(
        cfg, _lanes_on(traffic, device), model, mc, None, None,
        count_headers, chunk, max_cycles, allow_truncation, backend)
