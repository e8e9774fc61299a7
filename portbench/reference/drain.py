"""Plain reference of the cycle-level mesh drain.

The router cycle: X-Y routing, 4 VCs an input port with 4-flit FIFOs, a
credit check on the downstream FIFO of the same VC, round-robin switch
allocation per output port, one flit per link per cycle, and the Fig. 8
bit-transition recorder on every router link and every NI link. Every
tensor carries a leading lane axis; lanes never interact.

On the card the cycle is replayed from a CUDA graph of ``GRAPH_CYCLES``
cycles (the same eager operations, captured once), so the reference's
drain is paced by the device and not by the host's launches. Nothing here
imports the program.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from .ordering import popcount32
from .packets import NUM_PORTS, PORT_E, PORT_LOCAL, PORT_N, PORT_S, \
    PORT_W, Streams

GRAPH_CYCLES = 64
_OPPOSITE = np.array([PORT_S, PORT_W, PORT_N, PORT_E, PORT_LOCAL])
_SIDE_META = 9
_SIDE_VC = 11
_DEST_MASK = (1 << 9) - 1


class State(NamedTuple):
    fifo: torch.Tensor        # (B, NR+1, P, V, D, L+1) payload | sideband
    head: torch.Tensor        # (B, NR+1, P, V)
    count: torch.Tensor       # (B, NR+1, P, V)
    rr: torch.Tensor          # (B, NR, P)
    link_last: torch.Tensor   # (B, NR, P, L)
    link_bt: torch.Tensor     # (B, NR, P)
    link_flits: torch.Tensor  # (B, NR, P)
    inj_ptr: torch.Tensor     # (B, M)
    inj_last: torch.Tensor    # (B, M, L)
    inj_bt: torch.Tensor      # (B, M)
    ejected: torch.Tensor     # (B,)
    cycle: torch.Tensor       # (B,)
    drained_at: torch.Tensor  # (B,)


class Drained(NamedTuple):
    """One lane's drain: the cycle its last flit ejected, the flits it
    injected, its total bit transitions (router, ejection and NI links) and
    the flits its links carried."""

    cycles: int
    flits: int
    total_bt: int
    link_flits: int


def _geometry(geo: tuple, dev):
    rows, cols, v, d, _ = geo
    nr = rows * cols
    coords = np.arange(nr)
    rrow, rcol = coords // cols, coords % cols
    down = coords[:, None] + np.array([-cols, 1, cols, -1])[None, :]
    ok = np.stack([rrow > 0, rcol < cols - 1, rrow < rows - 1, rcol > 0], 1)
    opp = _OPPOSITE[:4]

    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    return dict(
        rrow=t(rrow[:, None, None], torch.int32),
        rcol=t(rcol[:, None, None], torch.int32),
        nb_blk=t(np.where(ok, down * NUM_PORTS + opp[None, :],
                          nr * NUM_PORTS).reshape(-1)),
        src_ok=t(ok, torch.bool),
        src_po=t((np.where(ok, down, 0) * NUM_PORTS + opp[None, :]
                  ).reshape(-1)),
        rcv_base=t(coords[:, None] * NUM_PORTS + np.arange(4)[None, :],
                   torch.int32),
        front_base=t(np.arange(nr * NUM_PORTS * v) * d),
        slots=t(np.arange(NUM_PORTS * v), torch.int32),
        outs=t(np.arange(NUM_PORTS)[None, None, :, None], torch.int32),
        r2=t(np.arange(nr)[:, None], torch.int32),
        o_local=t(np.arange(NUM_PORTS) == PORT_LOCAL, torch.bool),
        bidx=None)


def _step(s: State, wire: torch.Tensor, length: torch.Tensor,
          inject: torch.Tensor, geo: tuple, g: dict) -> State:
    """One router cycle of every lane; ``s`` is not modified."""
    rows, cols, v, d, l = geo
    nr, p = rows * cols, NUM_PORTS
    lf = l + 1
    nslots = p * v
    b = s.fifo.shape[0]
    m = length.shape[1]
    t_cap = wire.shape[2]
    bidx = torch.arange(b, device=s.fifo.device)[:, None]
    head_r = s.head[:, :nr]
    count_r = s.count[:, :nr]
    valid = count_r > 0
    fifo_rows = s.fifo.reshape(b, -1, lf)

    # The front flit of every FIFO: its destination and its route.
    front = g["front_base"][None, :] + head_r.reshape(b, -1)
    fd = fifo_rows[:, :, l].gather(1, front).reshape(b, nr, p, v) & _DEST_MASK
    dr, dc = fd // cols, fd % cols
    out_port = torch.where(
        dc > g["rcol"], PORT_E, torch.where(
            dc < g["rcol"], PORT_W, torch.where(
                dr > g["rrow"], PORT_S, torch.where(
                    dr < g["rrow"], PORT_N, PORT_LOCAL)))).to(torch.int32)

    # Credit: room in the downstream FIFO of the same VC.
    ok = s.count.reshape(b, (nr + 1) * p, v)[:, g["nb_blk"]].reshape(
        b, nr, 4, v) < d
    space = torch.where(
        out_port == PORT_N, ok[:, :, None, PORT_N, :], torch.where(
            out_port == PORT_E, ok[:, :, None, PORT_E, :], torch.where(
                out_port == PORT_S, ok[:, :, None, PORT_S, :],
                ok[:, :, None, PORT_W, :])))
    request = valid & ((out_port == PORT_LOCAL) | space)

    # Round-robin allocation per (router, output port).
    slot_req = request.reshape(b, nr, nslots)
    slot_out = out_port.reshape(b, nr, nslots)
    req_po = slot_req[:, :, None, :] & (slot_out[:, :, None, :] == g["outs"])
    rel = g["slots"] - s.rr[..., None]
    rel = torch.where(rel < 0, rel + nslots, rel)
    min_rel = torch.where(req_po, rel, nslots).amin(dim=3)
    has = min_rel < nslots
    winner = s.rr + min_rel
    winner = torch.where(winner >= nslots, winner - nslots, winner)
    rr_new = winner + 1
    rr_new = torch.where(rr_new >= nslots, rr_new - nslots, rr_new)
    rr_new = torch.where(has, rr_new, s.rr)

    pop = ((g["slots"] == winner[..., None]) & has[..., None]).any(dim=2)
    pop = pop.reshape(b, nr, p, v)
    head2 = torch.cat([torch.where(pop, (head_r + 1) % d, head_r),
                       s.head[:, nr:]], dim=1)
    count2 = torch.cat([count_r - pop.to(torch.int32), s.count[:, nr:]],
                       dim=1)

    # The winners' flits cross their links.
    win_v = winner % v
    win_pv = ((g["r2"] * p + winner // v) * v + win_v).reshape(b, -1).long()
    win_row = win_pv * d + s.head.reshape(b, -1).gather(1, win_pv)
    mv = fifo_rows[bidx, win_row].reshape(b, nr, p, lf)
    tog = popcount32(s.link_last ^ mv[..., :l]).sum(-1, dtype=torch.int32)
    link_bt = s.link_bt + torch.where(has, tog, 0)
    link_flits = s.link_flits + has.to(torch.int32)
    link_last = torch.where(has[..., None], mv[..., :l], s.link_last)

    # Pushes into the downstream routers' input FIFOs.
    src_po = g["src_po"]
    inc_ok = has.reshape(b, -1)[:, src_po].reshape(b, nr, 4) & g["src_ok"]
    inc_vc = win_v.reshape(b, -1)[:, src_po].reshape(b, nr, 4)
    inc_w = mv.reshape(b, nr * p, lf)[:, src_po]
    wc4 = (head2[:, :nr, :4, :] + count2[:, :nr, :4, :]) % d
    wslot = wc4[..., 0]
    for vi in range(1, v):
        wslot = torch.where(inc_vc == vi, wc4[..., vi], wslot)
    ejected = s.ejected + (has & g["o_local"]).sum(dim=(1, 2),
                                                   dtype=torch.int32)

    # Injection: one flit a stream a cycle into its router's local port.
    ptr = s.inj_ptr
    active = ptr < length
    safe = torch.clamp(ptr, max=t_cap - 1).long()
    iw = wire[bidx, torch.arange(m, device=ptr.device)[None, :], safe]
    ivc = iw[..., l] >> _SIDE_VC
    head_f = head2.reshape(b, -1)
    count_f = count2.reshape(b, -1)
    mc_pv = ((inject * p + PORT_LOCAL) * v + ivc).long()
    can = active & (count_f.gather(1, mc_pv) < d)
    inj_pv = torch.where(can, mc_pv, (nr * p + PORT_LOCAL) * v + ivc.long())
    islot = (head_f.gather(1, inj_pv) + count_f.gather(1, inj_pv)) % d

    rcv_row = torch.where(inc_ok, (g["rcv_base"] * v + inc_vc) * d + wslot,
                          nr * p * v * d)
    cat_row = torch.cat([rcv_row.reshape(b, -1).long(), inj_pv * d + islot],
                        dim=1)
    fifo_new = fifo_rows.clone()
    fifo_new[bidx, cat_row] = torch.cat([inc_w, iw], dim=1)
    count_inc = ((torch.arange(v, device=ptr.device, dtype=torch.int32)
                  == inc_vc[..., None]) & inc_ok[..., None]).to(torch.int32)
    count_new = count2.clone()
    count_new[:, :nr, :4, :] += count_inc
    count_new = count_new.reshape(b, -1)
    count_new.scatter_add_(1, inj_pv, can.to(torch.int32))

    itog = popcount32(s.inj_last ^ iw[..., :l]).sum(-1, dtype=torch.int32)
    inj_bt = s.inj_bt + torch.where(can, itog, 0)
    inj_last = torch.where(can[..., None], iw[..., :l], s.inj_last)
    total = length.sum(dim=1, dtype=torch.int32)
    drained_at = torch.where((s.drained_at < 0) & (ejected >= total),
                             s.cycle + 1, s.drained_at)
    return State(fifo_new.reshape(s.fifo.shape), head2,
                 count_new.reshape(count2.shape), rr_new, link_last, link_bt,
                 link_flits, ptr + can.to(torch.int32), inj_last, inj_bt,
                 ejected, s.cycle + 1, drained_at)


def _zero_state(geo: tuple, b: int, m: int, dev) -> State:
    rows, cols, v, d, l = geo
    nr, p = rows * cols, NUM_PORTS

    def z(*shape):
        return torch.zeros((b,) + shape, dtype=torch.int32, device=dev)

    return State(z(nr + 1, p, v, d, l + 1), z(nr + 1, p, v), z(nr + 1, p, v),
                 z(nr, p), z(nr, p, l), z(nr, p), z(nr, p), z(m), z(m, l),
                 z(m), z(), z(), torch.full((b,), -1, dtype=torch.int32,
                                            device=dev))


def drain(geo: tuple, streams: Streams, max_cycles: int = 2_000_000
          ) -> List[Drained]:
    """Drain every lane of ``streams`` on a mesh of geometry ``geo`` =
    (rows, cols, VCs, FIFO depth, lanes) until each has ejected all its
    flits; headers count in the BT totals, as payload flits do."""
    dev = streams.words.device
    side = (streams.dest | (streams.meta << _SIDE_META)
            | (streams.vc << _SIDE_VC))
    wire = torch.cat([streams.words, side[..., None]], dim=-1).contiguous()
    length = streams.length.contiguous()
    inject = streams.inject.contiguous()
    b, m = length.shape
    g = _geometry(geo, dev)
    state = _zero_state(geo, b, m, dev)

    def step(s):
        return _step(s, wire, length, inject, geo, g)

    def done(s):
        return bool((s.drained_at >= 0).all())

    if dev.type == "cuda":
        side_stream = torch.cuda.Stream()
        side_stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side_stream):
            for _ in range(2):
                step(state)
        torch.cuda.current_stream().wait_stream(side_stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = state
            for _ in range(GRAPH_CYCLES):
                out = step(out)
            for dst, src in zip(state, out):
                dst.copy_(src)
        while not done(state):
            if int(state.cycle[0]) >= max_cycles:
                raise RuntimeError(f"reference drain passed {max_cycles} "
                                   "cycles")
            graph.replay()
        del graph
    else:
        while not done(state):
            if int(state.cycle[0]) >= max_cycles:
                raise RuntimeError(f"reference drain passed {max_cycles} "
                                   "cycles")
            for _ in range(GRAPH_CYCLES):
                state = step(state)
    lens = length.sum(1).cpu().numpy()
    bt = (state.link_bt.sum((1, 2), dtype=torch.int64)
          + state.inj_bt.sum(1, dtype=torch.int64)).cpu().numpy()
    lf = state.link_flits.sum((1, 2), dtype=torch.int64).cpu().numpy()
    at = state.drained_at.cpu().numpy()
    return [Drained(int(at[i]), int(lens[i]), int(bt[i]), int(lf[i]))
            for i in range(b)]
