"""Plain reference of the mesh and of packetization: MC placements,
packet->MC affinity, the per-MC request streams (header flit, paired
payload, META bits, VCs) and the per-PE result streams.

Host numpy for the skeletons, plain PyTorch for the payload scatter.
Nothing here imports the program.
"""
from __future__ import annotations

import dataclasses
import re
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import ordering as od

META_PAYLOAD = 1
META_TAIL = 2
PORT_N, PORT_E, PORT_S, PORT_W, PORT_LOCAL = 0, 1, 2, 3, 4
NUM_PORTS = 5
RESULT_WINDOW = 64


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 2-D mesh, 4 VCs of 4 flits an input port, 16 lanes a flit."""

    rows: int
    cols: int
    mc_nodes: Tuple[int, ...]
    num_vcs: int = 4
    vc_depth: int = 4
    lanes: int = 16

    @property
    def num_routers(self) -> int:
        return self.rows * self.cols

    @property
    def num_mcs(self) -> int:
        return len(self.mc_nodes)

    @property
    def pe_nodes(self) -> Tuple[int, ...]:
        return tuple(r for r in range(self.num_routers)
                     if r not in self.mc_nodes)

    @property
    def geometry(self) -> tuple:
        return (self.rows, self.cols, self.num_vcs, self.vc_depth,
                self.lanes)


def _border(rows: int, cols: int):
    border = [(0, c) for c in range(cols)]
    border += [(r, cols - 1) for r in range(1, rows)]
    border += [(rows - 1, c) for c in range(cols - 2, -1, -1)]
    border += [(r, 0) for r in range(rows - 2, 0, -1)]
    return list(dict.fromkeys(border))


def _edge(rows: int, cols: int, n: int) -> Tuple[int, ...]:
    """n MCs evenly spaced along the boundary, clockwise from (0, 0)."""
    border = _border(rows, cols)
    step = len(border) / n
    return tuple(r * cols + c for r, c in
                 (border[int(i * step)] for i in range(n)))


def _corner(rows: int, cols: int, n: int) -> Tuple[int, ...]:
    """Corners first (diagonal pairs), then evenly along the rest."""
    corners = [(0, 0), (rows - 1, cols - 1), (0, cols - 1), (rows - 1, 0)]
    picks = list(dict.fromkeys(corners))[:n]
    need = n - len(picks)
    if need > 0:
        rest = [b for b in _border(rows, cols) if b not in set(picks)]
        step = len(rest) / need
        picks += [rest[int(i * step)] for i in range(need)]
    return tuple(r * cols + c for r, c in picks)


def _interleaved(rows: int, cols: int, n: int) -> Tuple[int, ...]:
    """n MCs evenly through the row-major node list."""
    return tuple(int(i * rows * cols / n) for i in range(n))


PLACEMENTS = {"edge": _edge, "corner": _corner, "interleaved": _interleaved}


def mesh(name: str, placement: str = "edge") -> Mesh:
    """``RxC_mcN`` under an MC placement."""
    m = re.match(r"^(\d+)x(\d+)_mc(\d+)$", name)
    if not m:
        raise KeyError(f"unknown mesh {name!r}")
    rows, cols, mcs = map(int, m.groups())
    return Mesh(rows, cols, PLACEMENTS[placement](rows, cols, mcs))


def affinity_table(cfg: Mesh) -> np.ndarray:
    """Per-PE serving MC: the fewest X-Y hops; ties to the MC with the
    fewest PEs so far (PEs in node order), then the lower index."""
    pes = np.asarray(cfg.pe_nodes, np.int64)
    mcs = np.asarray(cfg.mc_nodes, np.int64)
    hops = (np.abs(pes[:, None] // cfg.cols - mcs[None, :] // cfg.cols)
            + np.abs(pes[:, None] % cfg.cols - mcs[None, :] % cfg.cols))
    table = np.zeros(len(pes), np.int64)
    load = np.zeros(len(mcs), np.int64)
    for i in range(len(pes)):
        best = np.flatnonzero(hops[i] == hops[i].min())
        table[i] = best[np.argmin(load[best])]
        load[table[i]] += 1
    return table


def mean_hops(cfg: Mesh, num_packets: int, table=None) -> float:
    """Mean MC<->PE hops over packets 0..n-1 (PE ``g % num_pes``)."""
    if num_packets <= 0:
        return 0.0
    pes = np.asarray(cfg.pe_nodes, np.int64)
    mcs = np.asarray(cfg.mc_nodes, np.int64)
    g = np.arange(num_packets, dtype=np.int64)
    pe = pes[g % len(pes)]
    mc = (mcs[np.asarray(table, np.int64)[g % len(table)]]
          if table is not None else mcs[g % len(mcs)])
    return float((np.abs(pe // cfg.cols - mc // cfg.cols)
                  + np.abs(pe % cfg.cols - mc % cfg.cols)).mean())


class Streams(NamedTuple):
    """Per-source injection streams of B lanes, padded to T flits.

    words (B, M, T, L) int32; dest, meta, vc (B, M, T) int32; length (B, M)
    int32; inject (B, M) int32 router of each stream (router 0 for an
    empty padding stream)."""

    words: torch.Tensor
    dest: torch.Tensor
    meta: torch.Tensor
    vc: torch.Tensor
    length: torch.Tensor
    inject: torch.Tensor


class _Schedule:
    """Packet g's MC: ``g % M``, or ``table[g % Q]`` for an affinity table;
    ``before(g)`` counts the earlier packets at g's MC."""

    def __init__(self, m: int, table=None):
        tbl = (np.arange(m, dtype=np.int64) if table is None
               else np.asarray(table, np.int64))
        self.q, self.tbl = len(tbl), tbl
        self.cnt = np.bincount(tbl, minlength=m).astype(np.int64)
        onehot = np.zeros((len(tbl) + 1, m), np.int64)
        onehot[np.arange(1, len(tbl) + 1), tbl] = 1
        self.cum = np.cumsum(onehot, axis=0)

    def mc(self, g):
        return self.tbl[g % self.q]

    def before(self, g):
        mc = self.tbl[g % self.q]
        return (g // self.q) * self.cnt[mc] + self.cum[g % self.q, mc]

    def counts_before(self, g: int) -> np.ndarray:
        return (g // self.q) * self.cnt + self.cum[g % self.q]


def request_streams(payloads: Sequence[torch.Tensor], cfg: Mesh,
                    table=None) -> Streams:
    """Per-MC request streams of per-layer (B, n, F, L) payloads: packet g
    (layers in order) goes to PE ``pe_nodes[g % num_pes]`` from MC
    ``mc(g)``; a header flit (dest, packet id, payload flits) leads it; VC
    = earlier packets at its MC, mod the VC count; its flits follow the
    earlier packets at that MC."""
    dev = payloads[0].device
    nv = payloads[0].shape[0]
    m, lanes = cfg.num_mcs, cfg.lanes
    pes = np.asarray(cfg.pe_nodes, np.int64)
    sched = _Schedule(m, table)
    shapes = [(int(p.shape[1]), int(p.shape[2])) for p in payloads]
    g0s = np.concatenate([[0], np.cumsum([n for n, _ in shapes])]
                         ).astype(np.int64)
    cbs = [sched.counts_before(int(g)) for g in g0s]
    bases = [np.zeros(m, np.int64)]
    for (n, fpay), cb0, cb1 in zip(shapes, cbs, cbs[1:]):
        bases.append(bases[-1] + (cb1 - cb0) * (fpay + 1))
    lengths = bases[-1]
    t = int(lengths.max()) if m else 0
    words = torch.zeros((nv, m, t, lanes), dtype=torch.int32, device=dev)
    dest_a = np.zeros((m, t), np.int32)
    meta_a = np.zeros((m, t), np.int32)
    vc_a = np.zeros((m, t), np.int32)
    for li, ((n, fpay), pay) in enumerate(zip(shapes, payloads)):
        if n == 0:
            continue
        f = fpay + 1
        gids = g0s[li] + np.arange(n, dtype=np.int64)
        mcs = sched.mc(gids)
        dest = pes[gids % len(pes)].astype(np.int32)
        before = sched.before(gids)
        flit0 = bases[li][mcs] + (before - cbs[li][mcs]) * f
        cols = (flit0[:, None] + np.arange(f)[None, :]).reshape(-1)
        rows = np.repeat(mcs, f)
        hdr = np.zeros((n, lanes), np.int64)
        hdr[:, 0] = dest
        hdr[:, 1] = gids & 0xFFFFFFFF
        hdr[:, 2] = fpay
        full = torch.empty((nv, n, f, lanes), dtype=torch.int32, device=dev)
        full[:, :, 0, :] = torch.as_tensor(hdr.astype(np.uint32).view(
            np.int32), device=dev)
        full[:, :, 1:, :] = pay
        md = np.full((f,), META_PAYLOAD, np.int32)
        md[0] = 0
        md[-1] |= META_TAIL
        words[:, torch.as_tensor(rows, device=dev),
              torch.as_tensor(cols, device=dev)] = full.reshape(nv, n * f,
                                                                lanes)
        dest_a[rows, cols] = np.repeat(dest, f)
        meta_a[rows, cols] = np.broadcast_to(md, (n, f)).reshape(-1)
        vc_a[rows, cols] = np.repeat((before % cfg.num_vcs).astype(np.int32),
                                     f)
    return _streams(words, dest_a, meta_a, vc_a, lengths, cfg.mc_nodes, dev)


def _streams(words, dest, meta, vc, lengths, nodes, dev) -> Streams:
    nv = words.shape[0]

    def tile(a):
        x = torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                            device=dev)
        return x.expand((nv,) + tuple(x.shape)).contiguous()

    return Streams(words, tile(dest), tile(meta), tile(vc), tile(lengths),
                   tile(np.asarray(nodes, np.int64)))


def result_streams(values: Sequence[Sequence[torch.Tensor]], cfg: Mesh,
                   variants, table=None, window: int = RESULT_WINDOW,
                   compression: str = "none") -> Streams:
    """Per-PE result streams: request packet g's one result value returns
    from PE ``g % num_pes`` to MC ``mc(g)``; the results of one (PE, MC)
    pair within a layer travel in packets of up to ``window`` values, each
    window ordered by the variant's transform. ``values[layer][variant]``
    are the (quantized) result values; ``variants`` the (transform,
    tiebreak) of each."""
    dev = values[0][0].device
    m, lanes, nv = cfg.num_mcs, cfg.lanes, len(variants)
    pes = np.asarray(cfg.pe_nodes, np.int64)
    p = len(pes)
    w = window
    sched = _Schedule(m, table)
    mcs_nodes = np.asarray(cfg.mc_nodes, np.int64)
    fw = (-(-w // lanes) if compression == "none"
          else od.compressed_payload_flits(w, lanes))
    stream_len = np.zeros(p, np.int64)
    stream_pkts = np.zeros(p, np.int64)
    scatters = []
    pkt_id = 0
    g0 = 0
    for vals in values:
        n = int(vals[0].shape[0])
        if n == 0:
            continue
        gids = g0 + np.arange(n, dtype=np.int64)
        g0 += n
        src = gids % p
        key = src * m + sched.mc(gids)
        order = np.argsort(key, kind="stable")
        uniq, start, counts = np.unique(key[order], return_index=True,
                                        return_counts=True)
        grp = np.repeat(np.arange(len(uniq)), counts)
        rank = np.arange(n) - np.repeat(start, counts)
        pkts_per_grp = -(-counts // w)
        pkt_base = np.concatenate([[0], np.cumsum(pkts_per_grp)])
        slot = torch.as_tensor((pkt_base[grp] + rank // w) * w + rank % w,
                               device=dev)
        order_t = torch.as_tensor(order, device=dev)
        npkt = int(pkt_base[-1])
        words_v = []
        for (tr, tb), v in zip(variants, vals):
            win = torch.zeros(npkt * w, dtype=v.dtype, device=dev)
            win[slot] = v[order_t]
            words_v.append(od.result_words(tr, tb, win.reshape(npkt, w),
                                           lanes, compression))
        words_v = torch.stack(words_v)
        pk_grp = np.repeat(np.arange(len(uniq)), pkts_per_grp)
        pk_src = uniq[pk_grp] // m
        pk_mc = uniq[pk_grp] % m
        pk_c = np.minimum(counts[pk_grp] - (np.arange(npkt)
                                            - pkt_base[pk_grp]) * w, w)
        pk_fpay = np.asarray(-(-pk_c // lanes) if compression == "none"
                             else od.compressed_payload_flits(pk_c, lanes)
                             ).astype(np.int64)
        assert words_v.shape[2] == fw
        f_tot = pk_fpay + 1
        dest_pk = mcs_nodes[pk_mc].astype(np.int32)
        ids_pk = (pkt_id + np.arange(npkt)).astype(np.int64)
        s_counts = np.bincount(pk_src, minlength=p)
        s_first = np.concatenate([[0], np.cumsum(s_counts)])[:-1]
        within = np.arange(npkt) - np.repeat(s_first, s_counts)
        vc_pk = ((stream_pkts[pk_src] + within) % cfg.num_vcs).astype(np.int32)
        fcum = np.cumsum(f_tot) - f_tot
        run0 = fcum[np.minimum(s_first, max(npkt - 1, 0))]
        flit0 = stream_len[pk_src] + fcum - np.repeat(run0, s_counts)
        total_f = int(f_tot.sum())
        fl_pk = np.repeat(np.arange(npkt), f_tot)
        j = np.arange(total_f) - np.repeat(np.cumsum(f_tot) - f_tot, f_tot)
        md = np.where(j == 0, 0, META_PAYLOAD).astype(np.int32)
        md[j == f_tot[fl_pk] - 1] |= META_TAIL
        flit_words = words_v[:, torch.as_tensor(fl_pk, device=dev),
                             torch.as_tensor(np.maximum(j - 1, 0),
                                             device=dev)]
        hdr = np.zeros((npkt, lanes), np.int64)
        hdr[:, 0] = dest_pk
        hdr[:, 1] = ids_pk & 0xFFFFFFFF
        hdr[:, 2] = pk_fpay
        flit_words[:, torch.as_tensor(j == 0, device=dev)] = torch.as_tensor(
            hdr.astype(np.uint32).view(np.int32), device=dev)
        scatters.append((pk_src[fl_pk], flit0[fl_pk] + j, flit_words,
                         dest_pk[fl_pk], md, vc_pk[fl_pk]))
        stream_len += np.bincount(pk_src, weights=f_tot,
                                  minlength=p).astype(np.int64)
        stream_pkts += s_counts
        pkt_id += npkt
    t = int(stream_len.max()) if p else 0
    words = torch.zeros((nv, p, t, lanes), dtype=torch.int32, device=dev)
    dest_a = np.zeros((p, t), np.int32)
    meta_a = np.zeros((p, t), np.int32)
    vc_a = np.zeros((p, t), np.int32)
    for rows, cols, fw_, d_, md, vc_ in scatters:
        words[:, torch.as_tensor(rows, device=dev),
              torch.as_tensor(cols, device=dev)] = fw_
        dest_a[rows, cols] = d_
        meta_a[rows, cols] = md
        vc_a[rows, cols] = vc_
    return _streams(words, dest_a, meta_a, vc_a, stream_len, cfg.pe_nodes,
                    dev)


def concat(parts: Sequence[Streams]) -> Streams:
    """Lanes of several Streams in one batch, streams and flits padded
    (a padding stream is empty and injects at router 0)."""
    m = max(p.words.shape[1] for p in parts)
    t = max(p.words.shape[2] for p in parts)

    def pad(x, dims):
        spec = []
        for d in reversed(range(x.dim())):
            spec += [0, dims.get(d, x.shape[d]) - x.shape[d]]
        return F.pad(x, spec)

    return Streams(*(torch.cat([pad(getattr(p, f), {1: m, 2: t})
                                for p in parts])
                     for f in Streams._fields))
