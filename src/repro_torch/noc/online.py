"""The gated drain: a release schedule in front of the tracked step.

The port of the part of ``repro.noc.online`` that the fault drains use. A
stream's *effective length* at cycle c is the number of flits its release
schedule has unlocked by then, and the step's own ``ptr < length``
injection guard does the rest: the router pipeline, recorders and ledgers
are the tracked step's, unchanged. With every gate open from cycle 0 the
gated step is the offline step. Timing never reads payload values, so
variants of one schedule (the same packets under different orderings)
drain in lockstep as lanes of one batch.

The arrival processes, the admission controller and ``simulate_online``
belong to the serving slice of the port (ROADMAP A14).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .sim import (Ledger, SimResult, SimState, Traffic, Wire, _drain_timeout,
                  _mesh_key, _resolve_backend, _result, fuse_traffic,
                  make_ledger, make_state, tracked_step)
from .topology import NocConfig

__all__ = ["FAR_RELEASE", "gated_step"]

# Release-cycle sentinel for gates that must never open: far beyond any
# max_cycles, and still an int32.
FAR_RELEASE = np.int64(2**31 - 2)

_A14 = "the serving slice of the port (ROADMAP A14)"


class _GatedWire(NamedTuple):
    """Fused wire plus its release schedule, batched.

    wire:    (B, M, T, LF) int32 - the fused flits (``sim.Wire.wire``)
    inc:     (B, M, K) int32 - flits gate k unlocks on stream m
    release: (B, M, K) int32 - cycle gate k opens on stream m (non-decreasing
             along K; gates that stay locked hold ``FAR_RELEASE``)
    """

    wire: torch.Tensor
    inc: torch.Tensor
    release: torch.Tensor


def gated_step(state: SimState, ledger: Ledger, gwire: _GatedWire,
               mc_nodes: torch.Tensor, mesh_key, count_headers: bool,
               faults=None):
    """One tracked cycle (with ``faults``, the faulty one) whose stream
    lengths are the flits released by each lane's cycle:
    ``sum(where(release <= cycle, inc, 0))``."""
    eff = torch.where(gwire.release <= state.cycle[:, None, None], gwire.inc,
                      0).sum(-1, dtype=torch.int32)
    return tracked_step(state, ledger, Wire(gwire.wire, eff), mc_nodes,
                        mesh_key, count_headers, faults)


def _no_controller(controller) -> None:
    if controller is not None:
        raise NotImplementedError(
            f"controller= (admission control) arrives with {_A14}")


def _lanes_agree(lanes: List[np.ndarray], what: str) -> np.ndarray:
    """Lane 0's copy of a schedule-determined array, after checking every
    lane holds the same (lockstep variants share one schedule)."""
    for i, x in enumerate(lanes[1:], 1):
        if not np.array_equal(x, lanes[0]):
            raise RuntimeError(f"variant {i}'s {what} differs from variant "
                               "0's: lockstep variants must share one "
                               "schedule")
    return lanes[0]


def _drain_gated(cfg: NocConfig, traffic: Traffic, mc_nodes: np.ndarray,
                 release: np.ndarray, inc: np.ndarray, *,
                 count_headers: bool, chunk: int, max_cycles: int,
                 allow_truncation: bool, faults=None,
                 state: Optional[Tuple[SimState, Ledger]] = None,
                 controller=None, backend: str = "auto"):
    """Drain ``traffic`` under a release schedule; harvest the ledgers.

    ``traffic`` lies on the device the drain runs on; a batched Traffic is
    a set of lockstep variants (same packets, lengths, dests, VCs and ids;
    only the payload differs), which share ``release`` / ``inc`` (M, K).
    Returns ``(results, inj_time, eject_time, eject_pkt, drained, state)``:
    one SimResult a lane (a list for a batched Traffic), the ledgers as
    host arrays over the real packet ids (equal on every lane, checked),
    and the carried ``(SimState, Ledger)``. ``drain_cycle`` is rebuilt from
    the ejection ledger (the cycle after the last tail ejected): the step's
    own ``drained_at`` sees only released flits.

    faults: a ``faults.StepFaults`` threaded into the step; its protection
        code is stamped into the wire's sideband and the ledger carries the
        flip / detection counts.
    state: resume from a carried state (the retransmission rounds of
        ``faults.drain_with_retries``): recorders and ledgers accumulate,
        and the drain target is offset by the carried ``ejected`` count;
        ``results[i].injected`` is this round's flits alone.
    """
    _no_controller(controller)
    npkt = int(traffic.num_packets)
    if npkt <= 0:
        raise ValueError("gated drains need Traffic with num_packets set")
    dev = traffic.words.device
    _resolve_backend(backend, dev, track=True, faults=faults is not None)
    batched = traffic.length.dim() == 2
    wire = fuse_traffic(traffic, track_pkt=True)
    b, m = wire.length.shape
    if faults is not None and faults.protect != "none":
        from .faults import protect_wire
        wire = protect_wire(wire, faults.protect, cfg.lanes)
    if state is None:
        state = (make_state(cfg, m, batch=b, device=dev, track=True),
                 make_ledger(npkt, b, timestamps=True, device=dev,
                             fault_ledgers=faults is not None))
        start_ej = 0
    else:
        start_ej = int(state[0].ejected[0])

    def sched(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32,
                               device=dev).expand(b, -1, -1)

    gwire = _GatedWire(wire.wire, sched(inc), sched(release))
    nodes = torch.as_tensor(np.asarray(mc_nodes, np.int32),
                            device=dev).expand(b, -1)
    key = _mesh_key(cfg)
    lengths = wire.length.cpu().numpy().astype(np.int64)
    total = int(_lanes_agree(list(lengths.sum(axis=1, keepdims=True)),
                             "flit count")[0])
    st, lg = state
    drained = total == 0
    while not drained:
        for _ in range(chunk):
            st, lg = gated_step(st, lg, gwire, nodes, key, count_headers,
                                faults)
        if int(st.ejected[0]) - start_ej == total:
            drained = True
        elif int(st.cycle[0]) >= max_cycles:
            break
    state = (st, lg)
    books = {name: _lanes_agree(list(getattr(lg, name).cpu().numpy()), name)
             for name in ("eject_pkt", "inj_time", "eject_time")}
    cyc = _lanes_agree(list(st.cycle.cpu().numpy()[:, None]), "cycle")[0]
    ejected = _lanes_agree(list(st.ejected.cpu().numpy()[:, None]),
                           "ejected count")[0]
    if not drained and not allow_truncation:
        raise _drain_timeout(
            "closed-loop", int(cyc), int(ejected) - start_ej, total,
            st.count[0].cpu().numpy(), st.inj_ptr[0].cpu().numpy(),
            lengths[0], eject_pkt=books["eject_pkt"], npkt=npkt)
    inj_t = books["inj_time"][:npkt]
    ej_t = books["eject_time"][:npkt]
    drain_cycle = int(ej_t.max()) + 1 if (ej_t >= 0).any() else 0
    link_bt, link_flits, inj_bt = (x.cpu().numpy() for x in (
        st.link_bt, st.link_flits, st.inj_bt))
    results = [_result((link_bt[i], link_flits[i], inj_bt[i], ejected, cyc,
                        drain_cycle), total) for i in range(b)]
    return (results if batched else results[0], inj_t, ej_t,
            books["eject_pkt"], drained, state)
