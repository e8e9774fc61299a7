"""Hopper router-step kernel (``csrc/router_step.cu``): a chunk of NoC
router cycles per launch.

Replaces ``repro/kernels/router_step.py`` (``make_router_step`` /
``router_step_pallas``, body ``_make_kernel``), which ran one cycle per
``pallas_call`` under the simulator's ``lax.scan``. Here one thread block
owns one variant lane and loops over the chunk's cycles itself, with a
``__syncthreads()`` between the four phases of a cycle (route/credit,
allocation/pops/link BT, pushes/injection reads, injection
writes/bookkeeping). The FIFO tensor stays in global memory (L2-resident),
the injection-row gather moves inside the kernel, and masked-out writes
are skipped, so the phantom router row of the FIFO is never written.

Bound on the card: the cycles form a dependent chain, and each is a few
hundred integer ops per router behind four block barriers, so neither the
memory rate nor the ALU rate is the limit; the barrier-separated latency of
one cycle is. The design answers with one launch per chunk (no per-cycle
launch) and one block per lane so the variants run side by side.

The state is updated in place: the tensors of ``state`` are the tensors of
the returned state.
"""
from __future__ import annotations

import torch

from ._build import I32, P, CudaKernel, check_arg, stream

__all__ = ["KERNEL", "router_step"]

KERNEL = CudaKernel(
    "router_step", "router_step.cu", "router_step_run",
    [P] * 16 + [I32] * 10 + [P],
    replaces="src/repro/kernels/router_step.py:269 make_router_step")


def router_step(state, wire, mc_nodes: torch.Tensor, cycles: int, mesh_key,
                count_headers: bool):
    """Advance every lane of ``state`` (a ``noc.sim.SimState``) by
    ``cycles`` router cycles on the card, in place; returns ``state``.

    ``wire``: a ``noc.sim.Wire`` ((B, M, T, L+1) int32 words, (B, M)
    lengths); ``mc_nodes``: (B, M) int32 injection routers.
    """
    rows, cols, v, d, lanes = mesh_key
    nr, p = rows * cols, 5
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
    if b and cycles > 0:
        KERNEL.launch(*(leaf.data_ptr() for leaf in state),
                      wire.wire.data_ptr(), wire.length.data_ptr(),
                      mc_nodes.data_ptr(), b, rows, cols, v, d, lanes, m, t,
                      int(cycles), int(bool(count_headers)), stream())
    return state
