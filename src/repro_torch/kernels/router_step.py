"""Hopper router-step kernel (``csrc/router_step.cu``): a chunk of NoC
router cycles per launch, each lane's routing state in shared memory.

Replaces ``repro/kernels/router_step.py`` (``make_router_step`` /
``router_step_pallas``, body ``_make_kernel``), which ran one cycle per
``pallas_call`` under the simulator's ``lax.scan``. Here one thread block
owns one variant lane and loops over the chunk's cycles itself. At launch
start it loads the lane's routing state - head, count, round-robin
pointers, link and NI-link counters, and the sideband word of every FIFO
slot - into shared memory, and stores it back at the end; ``link_last``
and the FIFO payload join it where they fit (:func:`smem_layout`). A cycle
is two phases between ``__syncthreads()``: route + credit (which also
records every FIFO's tail slot and count, each stream's next local FIFO,
fetches wire rows ``INJ_RING - 1`` cycles ahead and settles the previous
cycle's bookkeeping), then arbitration, pops, pushes and injection: the
popping thread writes the flit straight into the downstream FIFO's tail
slot, and into a full local FIFO that pops, its stream's next flit.
Masked-out writes are skipped, so the phantom router row of the FIFO is
never written.

Bound on the card: the cycles form a dependent chain, and each is a few
thousand integer ops per lane behind two block barriers, so neither the
memory rate nor the ALU rate is the limit; the latency of one cycle is.

The state is updated in place: the tensors of ``state`` are the tensors of
the returned state.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, NamedTuple, Tuple

import torch

from ._build import I32, P, SMEM_BYTES, CudaKernel, check_arg, stream

__all__ = ["KERNEL", "router_step", "smem_layout", "SmemLayout",
           "LAYOUT_FIELDS", "OPTIONAL_LEAVES", "MAX_THREADS"]

KERNEL = CudaKernel(
    "router_step", "router_step.cu", "router_step_run",
    [P] * 16 + [I32] * 10 + [P, I32, I32, I32, P],
    replaces="src/repro/kernels/router_step.py:269 make_router_step")

# The arrays of one lane in the kernel's shared memory, in the order of the
# kernel's ``Layout`` struct. The first sixteen always live there (the
# routing state - rr in two buffers - and the per-cycle work arrays: the wire
# rows fetched so far, each stream's next local FIFO, tail slots, request
# bytes, the ring of fetched wire rows, each local FIFO's injecting stream);
# the last three are the optional leaves.
LAYOUT_FIELDS = ("head", "count", "rr", "link_bt", "link_flits", "inj_ptr",
                 "inj_bt", "inj_last", "length", "mc", "inj_top", "inj_next",
                 "tail", "req", "inj_row", "local_stream", "side", "link_last",
                 "payload")
# Placed in this order while they fit; the payload only with the sideband.
OPTIONAL_LEAVES = ("side", "link_last", "payload")
MAX_THREADS = 1024
# Threads per injecting stream in the kernel's phase 2 (its GROUP).
INJ_GROUP = 16
# Wire rows the kernel keeps fetched ahead per stream (its RING).
INJ_RING = 4
_STATIC_BYTES = 64      # the kernel's static shared words, rounded up
_PORTS = 5


class SmemLayout(NamedTuple):
    """Where one lane's arrays live: ``offsets`` in 4-byte words of dynamic
    shared memory (-1: in global memory), ``bytes`` of dynamic shared
    memory, and the block's ``threads``."""

    offsets: Dict[str, int]
    bytes: int
    threads: int

    @property
    def in_shared(self) -> Tuple[str, ...]:
        return tuple(n for n in OPTIONAL_LEAVES if self.offsets[n] >= 0)

    @property
    def in_global(self) -> Tuple[str, ...]:
        return tuple(n for n in OPTIONAL_LEAVES if self.offsets[n] < 0)


@lru_cache(maxsize=None)
def smem_layout(mesh_key, num_mcs: int) -> SmemLayout:
    """The shared-memory layout of one lane for a mesh and stream count.

    The routing state and the per-cycle work arrays always go to shared
    memory; then the FIFO sideband words, ``link_last`` and the FIFO
    payload, in that order, each while it fits in what a block may have
    (``SMEM_BYTES``). A rule chosen by shape: at L = 16, V = D = 4 a 4x4
    lane holds everything, an 8x8 lane everything but the payload, a 16x16
    lane the sideband but not ``link_last`` - except in its result drain,
    whose 240 PE streams' wire rings leave no room for the sideband either.
    Raises ``ValueError`` if the routing state alone does not fit.

    Threads: enough that route + credit covers the lane's FIFOs in as few
    rounds of at most 1,024 as it can, the rounds evenly filled, and that
    the second phase (two threads per router out-port from a warp boundary
    on, then ``INJ_GROUP`` per stream) takes one round where 1,024 can
    (8x8 with 8 streams: 768 threads, two rounds of route + credit).
    """
    rows, cols, v, d, lanes = mesh_key
    nr = rows * cols
    npo = nr * _PORTS
    nf = npo * v
    nslots = _PORTS * v
    words = {
        "head": nf, "count": nf, "rr": 2 * npo, "link_bt": npo,
        "link_flits": npo, "inj_ptr": num_mcs, "inj_bt": num_mcs,
        "inj_last": num_mcs * (lanes + 1), "length": num_mcs, "mc": num_mcs,
        "inj_top": num_mcs, "inj_next": num_mcs, "tail": nf,
        "req": nr * -(-nslots // 4),
        "inj_row": num_mcs * INJ_RING * (lanes + 1), "local_stream": nr * v,
        "side": nf * d, "link_last": npo * (lanes + 1),
        "payload": nf * d * (lanes + 1),
    }
    budget = (SMEM_BYTES - _STATIC_BYTES) // 4
    offsets = {name: -1 for name in LAYOUT_FIELDS}
    top = 0
    for name in LAYOUT_FIELDS:
        optional = name in OPTIONAL_LEAVES
        if name == "payload" and offsets["side"] < 0:
            continue
        size = -(-words[name] // 4) * 4        # 16-byte aligned
        if top + size > budget:
            if optional:
                continue
            raise ValueError(
                f"router_step: a {rows}x{cols} lane (V={v}, D={d}, "
                f"{num_mcs} streams) needs more than {SMEM_BYTES} bytes of "
                "shared memory for its routing state alone; a block has "
                f"{SMEM_BYTES}")
        offsets[name] = top
        top += size
    rounds = -(-nf // MAX_THREADS)
    phase2 = -(-2 * npo // 32) * 32 + INJ_GROUP * num_mcs
    threads = min(MAX_THREADS, max(-(-nf // rounds), phase2))
    return SmemLayout(offsets, top * 4, -(-threads // 32) * 32)


def router_step(state, wire, mc_nodes: torch.Tensor, cycles: int, mesh_key,
                count_headers: bool):
    """Advance every lane of ``state`` (a ``noc.sim.SimState``) by
    ``cycles`` router cycles on the card, in place; returns ``state``.

    ``wire``: a ``noc.sim.Wire`` ((B, M, T, L+1) int32 words, (B, M)
    lengths); ``mc_nodes``: (B, M) int32 injection routers.
    """
    rows, cols, v, d, lanes = mesh_key
    nr, p = rows * cols, _PORTS
    b, m, t, lf = wire.wire.shape
    if lf != lanes + 1:
        raise ValueError(f"router_step: wire has {lf} words per flit, the "
                         f"mesh needs {lanes + 1}")
    shapes = {
        "fifo": (b, nr + 1, p, v, d, lf), "head": (b, nr + 1, p, v),
        "count": (b, nr + 1, p, v), "rr": (b, nr, p),
        "link_last": (b, nr, p, lanes), "link_bt": (b, nr, p),
        "link_flits": (b, nr, p), "inj_ptr": (b, m),
        "inj_last": (b, m, lanes), "inj_bt": (b, m), "ejected": (b,),
        "cycle": (b,), "drained_at": (b,),
    }
    for name, leaf in zip(state._fields, state):
        check_arg("router_step", name, leaf, shapes[name])
    check_arg("router_step", "wire", wire.wire, (b, m, t, lf))
    check_arg("router_step", "length", wire.length, (b, m))
    check_arg("router_step", "mc_nodes", mc_nodes, (b, m))
    lay = smem_layout(tuple(mesh_key), m)
    if b and cycles > 0:
        offs = (ctypes.c_int * len(LAYOUT_FIELDS))(
            *(lay.offsets[n] for n in LAYOUT_FIELDS))
        KERNEL.launch(*(leaf.data_ptr() for leaf in state),
                      wire.wire.data_ptr(), wire.length.data_ptr(),
                      mc_nodes.data_ptr(), b, rows, cols, v, d, lanes, m, t,
                      int(cycles), int(bool(count_headers)),
                      ctypes.cast(offs, ctypes.c_void_p), INJ_RING,
                      lay.threads, lay.bytes, stream())
    return state
