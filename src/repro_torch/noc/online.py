"""Closed-loop (online) serving model: overlapped phases under load.

The port of ``repro.noc.online`` (see its docstring and DESIGN.md
"Closed-loop serving"). Back-to-back inferences stream through the mesh:

* an arrival process (:class:`ArrivalProcess`, the offered-load axis)
  releases inference k's request flits at ``arrival[k]``;
* a PE releases inference k's results once the request phase delivered
  that PE's last request packet of inference k, plus a compute latency;
* the gated drains carry the timestamp ledgers, and each packet's
  injection and ejection cycles become per-inference completions and
  latency percentiles.

Timing never reads payload values, so one gated drain per offered-load
point prices every ordering of one workload; the BT the closed loop
reports is the canonical per-inference phase drain (``simulate``).

The gate is a release schedule in front of the tracked step: a stream's
*effective length* at cycle c is the number of flits its schedule has
unlocked by then, and the step's own ``ptr < length`` injection guard does
the rest. With every gate open from cycle 0 the gated step is the offline
step. Variants of one schedule (the same packets under different
orderings) drain in lockstep as lanes of one batch.

The gated drains run the tracked plain step on the traffic's device: the
Hopper router kernel carries no ledger, as the reference's Pallas step
carries none. The canonical phase drains (``record_bt``) carry no ledger
unless ``check_conservation`` asks for one, and run the kernel on CUDA.
Admission control reads the ejection ledger once a chunk, one host read
a chunk as in the reference; the bookkeeping is host numpy.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .sim import (META_TAIL, Ledger, SimResult, SimState, Traffic, Wire,
                  _conservation_error, _drain_timeout, _mc_array, _mesh_key,
                  _resolve_backend, _result, fuse_traffic, make_ledger,
                  make_state, simulate, tracked_step)
from .topology import NocConfig
from .traffic import concat_inferences, filter_packets

__all__ = ["ArrivalProcess", "OnlineResult", "simulate_online",
           "percentile", "latency_percentiles", "ARRIVAL_KINDS",
           "FAR_RELEASE", "gated_step"]

# Release-cycle sentinel for gates that must never open (shed inferences,
# inferences whose upstream phase failed): far beyond any max_cycles, and
# still an int32.
FAR_RELEASE = np.int64(2**31 - 2)

ARRIVAL_KINDS = ("uniform", "poisson", "backtoback")


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Deterministic offered-load arrival process (cycles are the clock).

    kind: ``uniform`` spaces arrivals ``1000 / load`` cycles apart,
        ``poisson`` draws exponential gaps from numpy's PCG64 stream seeded
        by ``seed`` (the reference's draws exactly), ``backtoback``
        releases everything at cycle 0 (the saturation probe).
    load: offered load in inferences per 1000 cycles (ignored by
        ``backtoback``).
    """

    kind: str = "uniform"
    load: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.kind not in ARRIVAL_KINDS:
            raise ValueError(f"kind must be one of {ARRIVAL_KINDS}, "
                             f"got {self.kind!r}")
        if self.kind != "backtoback" and not self.load > 0:
            raise ValueError(f"offered load must be > 0, got {self.load!r}")

    def times(self, n: int) -> np.ndarray:
        """Arrival cycles of inferences ``0..n-1`` (non-decreasing int64;
        the first arrival is cycle 0)."""
        if n < 1:
            raise ValueError(f"need n >= 1 inferences, got {n}")
        if self.kind == "backtoback":
            return np.zeros(n, np.int64)
        mean_gap = 1000.0 / self.load
        if self.kind == "uniform":
            return np.floor(np.arange(n) * mean_gap).astype(np.int64)
        rng = np.random.Generator(np.random.PCG64(self.seed))
        gaps = rng.exponential(mean_gap, size=n - 1) if n > 1 else []
        return np.concatenate(
            [[0], np.floor(np.cumsum(gaps))]).astype(np.int64)


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


class _AdmissionController:
    """Chunk-boundary ingress admission control (the overload-shedding
    knob).

    The gated request drain calls :meth:`step` once a chunk, before the
    chunk runs. Arrivals inside ``[cycle, cycle + chunk)`` are decided
    then: an inference is admitted (its gates open at its arrival cycle)
    unless ``threshold`` admitted inferences are still incomplete, and then
    it is shed. Queue depth is read from the ejection ledger as of the
    chunk boundary, so admission sees completions up to one chunk late:
    the chunk is part of the admission semantics (ROADMAP C15).

    **Restart protocol.** A gate's increment is positional, so a gate that
    never opens mid-stream would make later gates unlock the wrong flits:
    shed flits must leave the wire. The first :meth:`step` that sheds a new
    inference (one not in ``preshed``) sets ``restart_needed``; the drain
    stops before its next chunk and the caller replays the whole drain with
    the enlarged shed set filtered out up front. A shed inference never
    injected, so the replay is cycle-identical up to the aborted boundary,
    and the protocol ends after one replay per shedding boundary.
    """

    def __init__(self, arrivals: np.ndarray, threshold: int,
                 inc: np.ndarray, chunk: int, npkt_per_inf: int,
                 preshed: Optional[np.ndarray] = None):
        self.arr = np.asarray(arrivals, np.int64)
        self.k = int(self.arr.size)
        self.threshold = int(threshold)
        self.inc = np.asarray(inc, np.int64)            # (M, K)
        self.chunk = int(chunk)
        self.npkt = int(npkt_per_inf)
        self.decided = np.zeros(self.k, bool)
        self.admitted = np.zeros(self.k, bool)
        self.release = np.full(self.inc.shape, FAR_RELEASE, np.int64)
        self.restart_needed = False
        if preshed is not None:
            self.decided |= np.asarray(preshed, bool)

    @property
    def done(self) -> bool:
        return bool(self.decided.all())

    @property
    def shed(self) -> np.ndarray:
        return self.decided & ~self.admitted

    def step(self, cycle: int, eject_time: np.ndarray):
        """Decide arrivals before ``cycle + chunk``; returns the updated
        ``(release, admitted_flit_total)`` or None when nothing changed."""
        if self.restart_needed:
            return None
        todo = np.flatnonzero(~self.decided & (self.arr < cycle + self.chunk))
        if not todo.size:
            return None
        et2 = np.asarray(eject_time).reshape(self.k, self.npkt)
        outstanding = self.admitted & (et2 < 0).any(axis=1)
        for j in todo:
            self.decided[j] = True
            if int(outstanding.sum()) >= self.threshold:
                self.restart_needed = True               # shed: replay
                continue
            self.admitted[j] = True
            outstanding[j] = True
            self.release[:, j] = self.arr[j]
        return self.release, int(self.inc[:, self.admitted].sum())


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
                 controller: Optional[_AdmissionController] = None,
                 backend: str = "auto"):
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
    controller: an :class:`_AdmissionController` consulted at every chunk
        boundary, before the chunk runs (one lane only: it reads one
        ejection ledger); the drain completes once the controller has
        decided every arrival and every admitted flit ejected, and stops
        before stepping once it needs a restart.
    """
    npkt = int(traffic.num_packets)
    if npkt <= 0:
        raise ValueError("gated drains need Traffic with num_packets set")
    dev = traffic.words.device
    _resolve_backend(backend, dev, track=True, faults=faults is not None)
    batched = traffic.length.dim() == 2
    wire = fuse_traffic(traffic, track_pkt=True)
    b, m = wire.length.shape
    if controller is not None and b != 1:
        raise ValueError("admission control reads one lane's ejection "
                         f"ledger; got a batch of {b} lanes")
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
        return torch.as_tensor(np.array(a, np.int32),
                               device=dev).expand(b, -1, -1)

    gwire = _GatedWire(wire.wire, sched(inc), sched(release))
    nodes = torch.as_tensor(np.asarray(mc_nodes, np.int32),
                            device=dev).expand(b, -1)
    key = _mesh_key(cfg)
    lengths = wire.length.cpu().numpy().astype(np.int64)
    total = int(_lanes_agree(list(lengths.sum(axis=1, keepdims=True)),
                             "flit count")[0])
    st, lg = state
    drained = False
    while True:
        if controller is not None:
            upd = controller.step(int(st.cycle[0]),
                                  lg.eject_time[0, :npkt].cpu().numpy())
            if upd is not None:
                new_rel, total = upd
                gwire = gwire._replace(release=sched(new_rel))
            if controller.restart_needed:
                # Stop before the next chunk: the caller replays with the
                # newly shed inferences filtered out of the wire, and
                # discards this drain.
                break
        settled = controller is None or controller.done
        if total == 0 and settled:
            drained = True
            break
        # With nothing admitted yet but arrivals pending, the chunk idles
        # the mesh so the controller's clock advances.
        for _ in range(chunk):
            st, lg = gated_step(st, lg, gwire, nodes, key, count_headers,
                                faults)
        if total and int(st.ejected[0]) - start_ej == total and settled:
            drained = True
            break
        if int(st.cycle[0]) >= max_cycles:
            break
    state = (st, lg)
    books = {name: _lanes_agree(list(getattr(lg, name).cpu().numpy()), name)
             for name in ("eject_pkt", "inj_time", "eject_time")}
    cyc = _lanes_agree(list(st.cycle.cpu().numpy()[:, None]), "cycle")[0]
    ejected = _lanes_agree(list(st.ejected.cpu().numpy()[:, None]),
                           "ejected count")[0]
    restarting = controller is not None and controller.restart_needed
    if not drained and not allow_truncation and not restarting:
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


def _packet_dest(traffic: Traffic) -> np.ndarray:
    """Destination router per packet id of an unbatched Traffic, read off
    the valid tail flits (-1 for ids that never appear)."""
    npkt = int(traffic.num_packets)
    dest = traffic.dest.cpu().numpy()
    meta = traffic.meta.cpu().numpy()
    pkt = traffic.pkt.cpu().numpy()
    valid = (np.arange(dest.shape[1])[None, :]
             < traffic.length.cpu().numpy()[:, None])
    tails = valid & ((meta & META_TAIL) > 0)
    out = np.full(npkt, -1, np.int64)
    out[pkt[tails]] = dest[tails]
    return out


@dataclasses.dataclass
class OnlineResult:
    """One closed-loop run: per-inference timing plus per-phase BT (the
    reference's fields, in its order, and the port's ``stepped_cycles``).

    completions[k] is the cycle after inference k's last result tail
    ejected, or -1 while still in flight at the cutoff (truncated runs
    only); latencies[k] = completions[k] - arrivals[k] (or -1). The
    ``request``/``result`` SimResults are the canonical per-inference
    phase drains (``None`` under ``record_bt=False``);
    ``sched_request``/``sched_result`` are the gated schedule drains whose
    timing every latency figure comes from.
    """

    arrivals: np.ndarray            # (K,) int64 arrival cycles
    completions: np.ndarray         # (K,) int64; -1 = in flight at cutoff
    latencies: np.ndarray           # (K,) int64; -1 = in flight at cutoff
    truncated: int                  # inferences still in flight at cutoff
    request_drain_cycle: int        # gated request-network drain
    result_drain_cycle: int         # gated result-network drain
    delivery: np.ndarray            # (K, NR) per-router request delivery
    release: np.ndarray             # (P, K) result-injection release cycles
    compute_latency: np.ndarray     # (P,) per-PE-stream compute cycles
    sched_request: SimResult
    sched_result: Optional[SimResult]
    request: Optional[SimResult]    # canonical request phase (BT contract)
    result: Optional[SimResult]
    request_inj_time: np.ndarray    # (K * NP_req,) per-packet ledgers
    request_eject_time: np.ndarray
    result_inj_time: np.ndarray
    result_eject_time: np.ndarray
    shed: Optional[np.ndarray] = None     # (K,) bool: refused admission
    failed: Optional[np.ndarray] = None   # (K,) bool: dropped/exhausted/
                                          # silently-corrupt packets
    deadline: Optional[int] = None        # per-inference latency SLO
    slo_attained: Optional[np.ndarray] = None  # (K,) bool when deadline set
    fault_ledger: Optional[dict] = None   # merged request+result ledger
    # Gated cycles stepped by both phases' drains, the admission replays'
    # aborted drains included (a port field: what the run cost).
    stepped_cycles: int = 0

    @property
    def completed(self) -> int:
        return int((self.completions >= 0).sum())

    @property
    def throughput(self) -> Optional[float]:
        """Completed inferences per 1000 cycles over the busy span."""
        done = self.completions[self.completions >= 0]
        if not done.size:
            return None
        span = int(done.max()) - int(self.arrivals.min())
        return float(done.size) * 1000.0 / max(span, 1)

    @property
    def num_shed(self) -> int:
        return int(self.shed.sum()) if self.shed is not None else 0

    @property
    def num_failed(self) -> int:
        return int(self.failed.sum()) if self.failed is not None else 0

    @property
    def slo_attainment(self) -> Optional[float]:
        """Fraction of OFFERED inferences that completed within the
        deadline (shed and failed inferences count against it)."""
        if self.slo_attained is None:
            return None
        return float(self.slo_attained.sum()) / max(self.slo_attained.size, 1)

    @property
    def goodput(self) -> Optional[float]:
        """SLO-attained inferences per 1000 cycles over the busy span
        (completed inferences when no deadline is set)."""
        ok = (self.slo_attained if self.slo_attained is not None
              else self.completions >= 0)
        done = self.completions[ok & (self.completions >= 0)]
        if not done.size:
            return None
        span = int(done.max()) - int(self.arrivals.min())
        return float(done.size) * 1000.0 / max(span, 1)


def _gated_phase(cfg: NocConfig, traffic: Traffic, nodes: np.ndarray,
                 release: np.ndarray, inc: np.ndarray, faults, controller,
                 **kw):
    """One gated phase drain, with retries under ``faults``: ``(sim,
    inj_time, eject_time, eject_counts, drained, fault_drain or None)``."""
    if faults is not None:
        from .faults import drain_with_retries
        fd = drain_with_retries(cfg, traffic, faults, mc_nodes=nodes,
                                release=release, inc=inc,
                                controller=controller,
                                device=traffic.words.device, **kw)
        return (fd.sim, fd.inj_time, fd.eject_time, fd.eject_counts,
                fd.drained, fd)
    res, it, et, ep, drained, _ = _drain_gated(
        cfg, traffic, nodes, release, inc, controller=controller, **kw)
    return res, it, et, ep, drained, None


def simulate_online(cfg: NocConfig, request: Traffic, result: Traffic, *,
                    arrivals: Union[ArrivalProcess, Sequence[int]],
                    num_inferences: Optional[int] = None,
                    compute_latency: Union[int, Sequence[int]] = 0,
                    count_headers: bool = True, chunk: int = 2048,
                    max_cycles: int = 2_000_000,
                    check_conservation: bool = False,
                    allow_truncation: bool = False,
                    record_bt: bool = True,
                    faults=None,
                    deadline: Optional[int] = None,
                    admit_queue_depth: Optional[int] = None,
                    device: DeviceLike = None) -> OnlineResult:
    """Closed-loop drain of ``num_inferences`` back-to-back inferences.

    request / result: ONE inference's unbatched phase traffics (e.g.
        ``build_traffic(...)`` and ``build_result_traffic(...).variant(i)``)
        with ``num_packets`` set. Result stream i injects at
        ``cfg.pe_nodes[i]`` (padding streams beyond the PE count must be
        empty).
    arrivals: an :class:`ArrivalProcess` (needs ``num_inferences``) or an
        explicit non-decreasing sequence of arrival cycles.
    compute_latency: cycles between a PE receiving its last request packet
        of an inference and releasing that inference's results - a scalar
        or one value per PE stream.
    allow_truncation: return partial results when ``max_cycles`` hits with
        inferences in flight (their completions and latencies are -1 and
        ``truncated`` counts them) instead of raising.
    record_bt: also run the canonical per-inference phase drains
        (``simulate``, clean even under ``faults``) and attach them as
        ``request`` / ``result``.
    faults: a ``faults.FaultModel``; both phases drain through
        ``drain_with_retries``. Inferences with dropped or retry-exhausted
        request packets never release results; silently corrupted
        deliveries complete but are marked ``failed``.
    deadline: per-inference latency SLO in cycles: ``slo_attained[k]`` =
        completed within the deadline and not failed.
    admit_queue_depth: arrivals are shed while that many admitted
        inferences are incomplete at the chunk boundary deciding them (the
        restart protocol of ``_AdmissionController``).
    device: where the drains run (CUDA unless ``"cpu"`` is given); the
        traffics are moved there.
    """
    if isinstance(arrivals, ArrivalProcess):
        if num_inferences is None:
            raise ValueError("ArrivalProcess arrivals need num_inferences")
        arr = arrivals.times(num_inferences)
    else:
        arr = np.asarray(arrivals, np.int64)
        if arr.ndim != 1 or not arr.size:
            raise ValueError("arrivals must be a non-empty 1-D sequence")
        if num_inferences is not None and num_inferences != arr.size:
            raise ValueError(f"num_inferences={num_inferences} disagrees "
                             f"with {arr.size} explicit arrivals")
    if (np.diff(arr) < 0).any() or arr[0] < 0:
        raise ValueError("arrival cycles must be non-negative and "
                         "non-decreasing")
    k = int(arr.size)
    if deadline is not None and not deadline > 0:
        raise ValueError(f"deadline must be a positive cycle count, "
                         f"got {deadline!r}")
    if admit_queue_depth is not None and not admit_queue_depth >= 1:
        raise ValueError(f"admit_queue_depth must be >= 1, "
                         f"got {admit_queue_depth!r}")
    dev = resolve_device(device)
    request = Traffic(*(t.to(dev) for t in request[:6]),
                      num_packets=request.num_packets)
    result = Traffic(*(t.to(dev) for t in result[:6]),
                     num_packets=result.num_packets)

    m_req = int(request.length.shape[0])
    req_nodes = _mc_array(cfg, request, m_req, batched=False)
    m_res = int(result.length.shape[0])
    pes = np.asarray(cfg.pe_nodes, np.int64)
    if m_res < pes.size:
        raise ValueError(f"result traffic has {m_res} streams, config has "
                         f"{pes.size} PEs")
    if m_res > pes.size and result.length[pes.size:].any():
        raise ValueError("result streams beyond the PE count must be empty "
                         "padding")
    res_nodes = np.concatenate(
        [pes, np.zeros(m_res - pes.size, np.int64)]).astype(np.int32)
    lat = np.broadcast_to(
        np.asarray(compute_latency, np.int64), (m_res,)).copy()
    if (lat < 0).any():
        raise ValueError("compute_latency must be >= 0")

    npkt_req = int(request.num_packets)
    npkt_res = int(result.num_packets)
    kw = dict(count_headers=count_headers, chunk=chunk,
              max_cycles=max_cycles, allow_truncation=allow_truncation)
    stepped = 0

    # --- request network: every inference's distribution traffic, gated
    # by the arrival process (all MC streams of inference k open together).
    req_cat = concat_inferences(request, k)
    req_len1 = request.length.cpu().numpy().astype(np.int64)
    req_rel = np.broadcast_to(arr[None, :], (m_req, k))
    req_inc = np.broadcast_to(req_len1[:, None], (m_req, k))
    ctrl = None
    preshed = np.zeros(k, bool)
    while True:
        req_cat_f, req_inc_f, req_rel_f = req_cat, req_inc, req_rel
        if admit_queue_depth is not None:
            ctrl = _AdmissionController(arr, admit_queue_depth, req_inc,
                                        chunk, npkt_req, preshed=preshed)
            req_rel_f = ctrl.release
            if preshed.any():
                # Shed flits must not sit in the wire (gate increments are
                # positional): filter them out and zero their gates.
                req_cat_f = filter_packets(req_cat,
                                           np.repeat(~preshed, npkt_req))
                req_inc_f = np.where(preshed[None, :], 0, req_inc)
        sched_req, req_it, req_et, req_ep, req_drained, fd_req = (
            _gated_phase(cfg, req_cat_f, req_nodes, req_rel_f, req_inc_f,
                         faults, ctrl, **kw))
        stepped += sched_req.cycles
        if ctrl is None or not ctrl.restart_needed:
            break
        preshed = ctrl.shed.copy()
    shed_k = ctrl.shed.copy() if ctrl is not None else np.zeros(k, bool)

    # --- per-(inference, router) delivery: the cycle the last request
    # packet destined to that router ejected. Routers never addressed fall
    # back to the arrival cycle (nothing to wait for, no results either).
    pdest = _packet_dest(request)
    et2 = req_et.reshape(k, npkt_req) if npkt_req else req_et.reshape(k, 0)
    delivery = np.broadcast_to(arr[:, None],
                               (k, cfg.num_routers)).astype(np.int64).copy()
    live = pdest >= 0
    if live.any():
        rows = np.repeat(np.arange(k), int(live.sum()))
        cols = np.tile(pdest[live], k)
        np.maximum.at(delivery, (rows, cols),
                      et2[:, live].astype(np.int64).reshape(-1))

    # --- result network: per-PE release = that PE's delivery + compute
    # latency, monotone along k over the inferences that release at all.
    # Inferences whose requests were cut off, shed, dropped or exhausted
    # never release: pinned at FAR_RELEASE (capped in int64, before the
    # int32 schedule is built, ROADMAP C5).
    rel = delivery[:, res_nodes.astype(np.int64)].T + lat[:, None]  # (P, K)
    blocked = ((et2 < 0).any(axis=1) if npkt_req
               else np.zeros(k, bool))      # lost/unsent request packets
    failed_req = np.zeros(k, bool)
    if fd_req is not None:
        from .faults import STATUS_DROPPED, STATUS_RETRY_EXHAUSTED
        st2 = fd_req.status.reshape(k, npkt_req)
        detected = ((st2 == STATUS_DROPPED)
                    | (st2 == STATUS_RETRY_EXHAUSTED)).any(axis=1)
        failed_req = (detected | fd_req.corrupted.reshape(
            k, npkt_req).any(axis=1)) & ~shed_k
        blocked |= detected     # the PE never assembled the full request
    rel = np.minimum(rel, FAR_RELEASE)
    if blocked.any():
        rel[:, blocked] = FAR_RELEASE
    open_idx = np.flatnonzero(~blocked)
    if open_idx.size:
        rel[:, open_idx] = np.maximum.accumulate(rel[:, open_idx], axis=1)
    res_cat = concat_inferences(result, k)
    res_len1 = result.length.cpu().numpy().astype(np.int64)
    res_inc = np.broadcast_to(res_len1[:, None], (m_res, k))
    fd_res = None
    if npkt_res:
        res_cat_f, res_inc_f = res_cat, res_inc
        if blocked.any():
            # Result flits of blocked inferences never release: keep them
            # out of the wire (and the drain target) entirely.
            res_cat_f = filter_packets(res_cat, np.repeat(~blocked, npkt_res))
            res_inc_f = np.where(blocked[None, :], 0, res_inc)
        sched_res, res_it, res_et, res_ep, res_drained, fd_res = (
            _gated_phase(cfg, res_cat_f, res_nodes, rel, res_inc_f, faults,
                         None, **kw))
        stepped += sched_res.cycles
    else:
        sched_res, res_it, res_et, res_ep, res_drained = (
            None, np.zeros(0, np.int32), np.zeros(0, np.int32),
            np.zeros(1, np.int32), True)

    failed_k = failed_req.copy()
    if fd_res is not None:
        from .faults import STATUS_DROPPED, STATUS_RETRY_EXHAUSTED
        rst2 = fd_res.status.reshape(k, npkt_res)
        failed_k |= (((rst2 == STATUS_DROPPED)
                      | (rst2 == STATUS_RETRY_EXHAUSTED)).any(axis=1)
                     | fd_res.corrupted.reshape(k, npkt_res).any(axis=1))
        failed_k &= ~shed_k

    drained = req_drained and res_drained
    if check_conservation and drained:
        _check_online_conservation(faults, fd_req, fd_res, ctrl, blocked,
                                   req_cat, res_cat, req_ep, res_ep, k,
                                   npkt_req, npkt_res)

    # --- per-inference completion: the cycle after the last result tail of
    # inference k ejected (request delivery for pure-distribution
    # workloads); -1 while any of its packets is in flight.
    if npkt_res:
        ret2 = res_et.reshape(k, npkt_res).astype(np.int64)
        done_k = (ret2 >= 0).all(axis=1)
        completions = np.where(done_k, ret2.max(axis=1) + 1, -1)
    else:
        done_k = ((et2 >= 0).all(axis=1) if npkt_req
                  else np.ones(k, bool))
        completions = np.where(done_k, delivery.max(axis=1) + 1, -1)
    latencies = np.where(completions >= 0, completions - arr, -1)

    slo = None
    if deadline is not None:
        slo = (completions >= 0) & (latencies <= deadline) & ~failed_k
    ledger = None
    if faults is not None:
        ledger = {"request": fd_req.ledger}
        if fd_res is not None:
            ledger["result"] = fd_res.ledger

    req_bt = res_bt = None
    if record_bt and drained:
        req_bt = simulate(cfg, request, count_headers=count_headers,
                          chunk=chunk, max_cycles=max_cycles,
                          check_conservation=check_conservation, device=dev)
        if npkt_res:
            res_bt = simulate(cfg, result, count_headers=count_headers,
                              chunk=chunk, max_cycles=max_cycles,
                              check_conservation=check_conservation,
                              mc_nodes=res_nodes, device=dev)

    degradation = ctrl is not None or faults is not None
    return OnlineResult(
        arrivals=arr, completions=completions, latencies=latencies,
        truncated=int(((completions < 0) & ~shed_k & ~failed_k).sum()),
        request_drain_cycle=sched_req.drain_cycle,
        result_drain_cycle=(sched_res.drain_cycle if sched_res else
                            sched_req.drain_cycle),
        delivery=delivery, release=rel, compute_latency=lat,
        sched_request=sched_req, sched_result=sched_res,
        request=req_bt, result=res_bt,
        request_inj_time=req_it, request_eject_time=req_et,
        result_inj_time=res_it, result_eject_time=res_et,
        shed=shed_k if degradation else None,
        failed=failed_k if degradation else None,
        deadline=deadline, slo_attained=slo, fault_ledger=ledger,
        stepped_cycles=stepped)


def _check_online_conservation(faults, fd_req, fd_res, ctrl, blocked,
                               req_cat: Traffic, res_cat: Traffic,
                               req_ep: np.ndarray, res_ep: np.ndarray,
                               k: int, npkt_req: int, npkt_res: int) -> None:
    """The closed loop's three conservation arms: the fault ledgers close;
    under admission control shed inferences eject nothing and admitted
    ones every packet once; otherwise every packet ejects once."""
    if faults is not None:
        for name, fd in (("request", fd_req), ("result", fd_res)):
            if fd is not None and not fd.ledger.get("conservation_ok"):
                raise RuntimeError(
                    f"closed-loop {name}-phase fault ledger violated "
                    f"conservation: {fd.ledger}")
    elif ctrl is not None:
        exp = np.repeat(ctrl.admitted.astype(req_ep.dtype), npkt_req)
        if not np.array_equal(req_ep[:k * npkt_req], exp):
            raise RuntimeError(
                "closed-loop request-phase conservation violated under "
                "admission control: ejection counts disagree with the "
                "admitted set")
        if npkt_res:
            exp_r = np.repeat((ctrl.admitted & ~blocked).astype(res_ep.dtype),
                              npkt_res)
            if not np.array_equal(res_ep[:k * npkt_res], exp_r):
                raise RuntimeError(
                    "closed-loop result-phase conservation violated under "
                    "admission control: ejection counts disagree with the "
                    "released set")
    else:
        for name, tr_cat, ep in (("request", req_cat, req_ep),
                                 ("result", res_cat, res_ep)):
            if int(tr_cat.num_packets) <= 0:
                continue
            err = _conservation_error(
                tr_cat.length.cpu().numpy(), tr_cat.meta.cpu().numpy(),
                tr_cat.pkt.cpu().numpy(), ep, int(tr_cat.num_packets))
            if err:
                raise RuntimeError(f"closed-loop {name}-phase "
                                   f"conservation violated: {err}")


# --- latency percentiles -------------------------------------------------


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile under linear interpolation: numpy's default
    ``np.percentile(values, q)`` (ties, single samples and endpoints
    included)."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile must be in [0, 100], got {q!r}")
    v = np.sort(np.asarray(values, np.float64))
    if not v.size:
        raise ValueError("percentile of an empty sample")
    if v.size == 1:
        return float(v[0])
    pos = (q / 100.0) * (v.size - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, v.size - 1)
    frac = pos - lo
    return float(v[lo] * (1.0 - frac) + v[hi] * frac)


def latency_percentiles(latencies: Sequence[int],
                        qs: Tuple[float, ...] = (50.0, 99.0)) -> dict:
    """Percentile summary of a per-inference latency ledger.

    Negative entries mark inferences in flight at the cutoff: they are left
    out of the percentiles and counted in ``truncated`` beside ``count``.
    Percentiles are ``None`` when nothing completed.
    """
    lat = np.asarray(latencies, np.int64)
    if lat.ndim != 1:
        raise ValueError("latencies must be 1-D")
    done = lat[lat >= 0]
    out = {"count": int(done.size), "truncated": int((lat < 0).sum())}
    for q in qs:
        key = f"p{q:g}"
        out[key] = percentile(done, q) if done.size else None
    if done.size:
        out["mean"] = float(done.mean())
        out["max"] = int(done.max())
    else:
        out["mean"] = out["max"] = None
    return out
