"""What the Hopper router kernel's design relies on, pinned on the CPU.

``csrc/router_step.cu`` lets the thread that pops a flit write it straight
into the downstream FIFO, at the tail slot recorded from the start-of-cycle
``head`` and ``count``, in the same phase as every other pop. That is right
only because of four properties of the router cycle, checked here cycle by
cycle on the plain step (the kernel's oracle), which is itself held to the
reference's ``repro.noc.sim._make_step`` on the same numpy inputs:

* every push lands in slot ``(head + count) % D`` of the start-of-cycle
  state, and no other slot of any FIFO changes;
* no push slot is a slot popped in the same cycle;
* each receiving FIFO gets at most one push a cycle;
* local-port FIFOs get no router push (only injections), and an
  injection into a local FIFO that was full lands in the slot that FIFO
  pops in the same cycle (the kernel's popping thread writes it).

The same on a result-phase batch, where the PEs inject (14 streams on
4x4_mc2) and the MCs receive. Also the wrapper's shared-memory layout rule
(``router_step.smem_layout``): bytes within ``SMEM_BYTES`` and which leaves
it places where, at MC stream counts and at the result drains' PE stream
counts (14, 60, 240).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.noc import sim as jsim  # noqa: E402
from repro.noc.topology import NocConfig as JNocConfig  # noqa: E402
from repro_torch.kernels import router_step as rs  # noqa: E402
from repro_torch.kernels._build import SMEM_BYTES  # noqa: E402
from repro_torch.noc import sim  # noqa: E402
from repro_torch.noc import topology  # noqa: E402
from repro_torch.noc.topology import OPPOSITE, PORT_LOCAL, mesh_by_name  # noqa: E402
from repro_torch.noc.traffic import TrafficAssembler  # noqa: E402

from test_torch_traffic import (_layers_np, _variants,  # noqa: E402,F401
                                one_torch_thread, ref, ref_layers)
from repro_torch.noc import traffic  # noqa: E402


def _key(cfg):
    return (cfg.rows, cfg.cols, cfg.num_vcs, cfg.vc_depth, cfg.lanes)


def _synthetic(cfg, packets, flits, seed):
    """Random payload words on the packetizer's real skeleton (one lane)."""
    rng = np.random.default_rng(seed)
    asm = TrafficAssembler([(packets, flits)], cfg, device="cpu")
    w = rng.integers(0, 2**32, (1, packets, flits, cfg.lanes),
                     dtype=np.uint64).astype(np.uint32)
    asm.add_chunk(0, 0, torch.from_numpy(w.view(np.int32)))
    return asm.finish()


def _pinned(ref_layers, mesh, variant):
    return traffic.build_traffic_batch(
        _layers_np(ref_layers), mesh_by_name(mesh),
        _variants(True)[variant:variant + 1], max_packets_per_layer=8,
        device="cpu")


def _neighbor(cols, r, port):
    return r + (-cols, 1, cols, -1)[port]


def _check_cycle(s0, s1, key):
    """The four properties on one plain-step transition ``s0 -> s1``."""
    rows, cols, v, d, lanes = key
    nr = rows * cols
    h0, c0 = s0.head[:, :nr].long(), s0.count[:, :nr].long()
    h1, c1 = s1.head[:, :nr].long(), s1.count[:, :nr].long()
    pop = h1 != h0                          # D > 1: a pop always moves head
    assert torch.equal(h1[pop], (h0[pop] + 1) % d)
    arrive = c1 - c0 + pop.long()           # pushes + injections per FIFO
    # At most one arrival per FIFO a cycle, and only into a FIFO with room:
    # at the start of the cycle for a push (the credit check), after the
    # pops for an injection.
    assert int(arrive.min()) >= 0 and int(arrive.max()) <= 1
    push = arrive[:, :, :PORT_LOCAL] > 0
    assert bool((c0[:, :, :PORT_LOCAL][push] < d).all())
    inj = arrive[:, :, PORT_LOCAL] > 0
    assert bool(((c0 - pop.long())[:, :, PORT_LOCAL][inj] < d).all())
    full_inj = inj & (c0[:, :, PORT_LOCAL] == d)
    assert bool(pop[:, :, PORT_LOCAL][full_inj].all())
    # Local in-ports get injections only: as many as the streams advanced.
    injected = (s1.inj_ptr - s0.inj_ptr).sum(dim=1)
    assert torch.equal(arrive[:, :, PORT_LOCAL].sum(dim=(1, 2)), injected)
    # Every arrival lands in the start-of-cycle tail slot, and no other FIFO
    # slot changes; a push slot is never the slot popped in the same cycle.
    tail = (h0 + c0) % d
    slot = torch.arange(d)
    changed = (s1.fifo[:, :nr] != s0.fifo[:, :nr]).any(dim=-1)
    allowed = (arrive[..., None] > 0) & (slot == tail[..., None])
    assert not bool((changed & ~allowed).any())
    assert not bool((pop[:, :, :PORT_LOCAL] & push
                     & (tail == h0)[:, :, :PORT_LOCAL]).any())
    # Each push carries the flit that crossed the upstream link this cycle.
    for b, r, ip, vc in push.nonzero().tolist():
        up, o = _neighbor(cols, r, ip), int(OPPOSITE[ip])
        assert int(s1.link_flits[b, up, o] - s0.link_flits[b, up, o]) == 1
        row = s1.fifo[b, r, ip, vc, int(tail[b, r, ip, vc])]
        assert torch.equal(row[:lanes], s1.link_last[b, up, o])
    return int(c0.max()), int(full_inj.sum())


def _jax_cfg(cfg):
    return JNocConfig(cfg.rows, cfg.cols, tuple(cfg.mc_nodes),
                      num_vcs=cfg.num_vcs, vc_depth=cfg.vc_depth,
                      lanes=cfg.lanes)


def _assert_same_as_reference(state, jstate, nr):
    lf = state.fifo.shape[-1]
    got = state.fifo[0, :nr].numpy().view(np.uint32)
    want = np.asarray(jstate.fifo)[:nr, ..., :lf]
    np.testing.assert_array_equal(got, want)
    for name in ("head", "count", "rr", "link_bt", "link_flits", "inj_ptr",
                 "inj_bt", "ejected", "cycle", "drained_at"):
        np.testing.assert_array_equal(getattr(state, name)[0].numpy(),
                                      np.asarray(getattr(jstate, name)),
                                      name)
    for name in ("link_last", "inj_last"):
        np.testing.assert_array_equal(
            getattr(state, name)[0].numpy().view(np.uint32),
            np.asarray(getattr(jstate, name)), name)


def _drive(cfg, t, cycles, headers):
    """Run the plain step and the reference's step side by side from zero
    state for ``cycles`` cycles, checking the properties on every cycle;
    returns the fullest FIFO seen, the injections into full local FIFOs
    and the flits ejected."""
    key = _key(cfg)
    wire = sim.fuse_traffic(t)
    m = wire.length.shape[1]
    mc = torch.as_tensor(np.asarray(tuple(cfg.mc_nodes)
                                    + (0,) * (m - cfg.num_mcs),
                                    np.int32)[None])
    state = sim.make_state(cfg, m, device="cpu")
    jstep = jax.jit(jsim._make_step(key, headers, track=False))
    jwire = jsim.Wire(jnp.asarray(wire.wire[0].numpy().view(np.uint32)),
                      jnp.asarray(wire.length[0].numpy()))
    jmc = jnp.asarray(mc[0].numpy())
    jstate = jsim.make_state(_jax_cfg(cfg), m)
    peak = full = 0
    for _ in range(cycles):
        nxt = sim.plain_step(state, wire, mc, key, headers)
        fullest, into_full = _check_cycle(state, nxt, key)
        peak, full = max(peak, fullest), full + into_full
        state = nxt
        jstate = jstep(jstate, jwire, jmc)
    _assert_same_as_reference(state, jstate, cfg.num_routers)
    return peak, full, int(state.ejected[0])


@pytest.mark.parametrize("mesh,variant,headers,cycles", [
    ("4x4_mc2", 4, True, 160),
    ("8x8_mc8", 7, False, 120),
])
def test_push_properties_on_pinned_cells(ref_layers, mesh, variant, headers,
                                         cycles):
    cfg = mesh_by_name(mesh)
    peak, _, ejected = _drive(cfg, _pinned(ref_layers, mesh, variant),
                              cycles, headers)
    assert ejected > 0 and peak >= 1


def test_push_properties_under_congestion():
    """Sixteen MCs on an 8x8 mesh with 24-flit packets fill FIFOs to D, so
    credits refuse pushes and streams inject into full local FIFOs as they
    pop, while the properties still hold."""
    cfg = mesh_by_name("8x8_mc16")
    peak, full, ejected = _drive(cfg, _synthetic(cfg, 60, 24, seed=11), 90,
                                 True)
    assert peak == cfg.vc_depth
    assert full > 0
    assert ejected > 0


def test_push_properties_on_result_batch(ref_layers):
    """LeNet's full result traffic (6,518 values, windows of 64) injected at
    the 14 PEs of 4x4_mc2 under nearest affinity: the PEs' local FIFOs
    fill and inject as they pop, and the properties hold."""
    cfg = mesh_by_name("4x4_mc2")
    t = traffic.build_result_traffic(
        _layers_np(ref_layers), cfg, _variants(True)[10:11],
        mc_table=topology.affinity_mc_table(cfg), device="cpu")
    assert t.length.shape == (1, 14)
    pe_cfg = dataclasses.replace(cfg, mc_nodes=cfg.pe_nodes)
    peak, full, ejected = _drive(pe_cfg, t, 150, True)
    assert peak == cfg.vc_depth and full > 0 and ejected > 0


# --------------------------------------------------------------------------
# The wrapper's shared-memory layout rule.

@pytest.mark.parametrize("mesh,m,shared,glob", [
    ("4x4_mc2", 2, ("side", "link_last", "payload"), ()),
    ("8x8_mc4", 8, ("side", "link_last"), ("payload",)),
    ("8x8_mc8", 8, ("side", "link_last"), ("payload",)),
    ("16x16_mc16", 16, ("side",), ("link_last", "payload")),
    ("16x32_mc16", 16, (), ("side", "link_last", "payload")),
    # the result drains: PE streams (8x8: the mc4 / mc8 group's 60)
    ("4x4_mc2", 14, ("side", "link_last", "payload"), ()),
    ("8x8_mc4", 60, ("side", "link_last"), ("payload",)),
    ("16x16_mc16", 240, (), ("side", "link_last", "payload")),
])
def test_smem_layout_places_leaves_by_shape(mesh, m, shared, glob):
    cfg = mesh_by_name(mesh)
    lay = rs.smem_layout(_key(cfg), m)
    assert lay.in_shared == shared and lay.in_global == glob
    assert 0 < lay.bytes <= SMEM_BYTES - 64
    assert lay.threads % 32 == 0 and lay.threads <= rs.MAX_THREADS
    # Arrays are 16-byte aligned and disjoint, within the bytes claimed.
    placed = sorted((off, name) for name, off in lay.offsets.items()
                    if off >= 0)
    assert [name for _, name in placed][:16] == list(rs.LAYOUT_FIELDS[:16])
    assert all(off % 4 == 0 for off, _ in placed)
    assert placed[-1][0] * 4 < lay.bytes
    nf = cfg.num_routers * 5 * cfg.num_vcs
    assert lay.offsets["count"] - lay.offsets["head"] >= nf
    if "payload" in shared:
        assert (lay.bytes - 4 * lay.offsets["payload"]
                >= 4 * nf * cfg.vc_depth * (cfg.lanes + 1))


def test_smem_layout_threads_cover_route_in_few_rounds():
    """4x4's 320 FIFOs in one round; 8x8's 1,280 in two, with its 320
    out-port pairs and 8 streams of 16 threads in one round of 768; the
    result drains' 14 streams at 4x4 in one round of 384, 60 and 240 at
    8x8 and 16x16 in rounds of 1,024."""
    for mesh, m, threads in (("4x4_mc2", 2, 320), ("8x8_mc4", 8, 768),
                             ("16x16_mc16", 16, 1024), ("2x2_mc1", 1, 96),
                             ("4x4_mc2", 14, 384), ("8x8_mc4", 60, 1024),
                             ("16x16_mc16", 240, 1024)):
        assert rs.smem_layout(_key(mesh_by_name(mesh)), m).threads == threads


def test_smem_layout_of_the_240_stream_result_drain():
    """16x16_mc16's result drain: the routing state, the 240 streams' rings
    and NI words in 178,496 bytes; the sideband (81,920 more) no longer
    fits, so it, link_last and the payload stay in global memory."""
    lay = rs.smem_layout(_key(mesh_by_name("16x16_mc16")), 240)
    assert lay.offsets == {
        "head": 0, "count": 5120, "rr": 10240, "link_bt": 12800,
        "link_flits": 14080, "inj_ptr": 15360, "inj_bt": 15600,
        "inj_last": 15840, "length": 19920, "mc": 20160, "inj_top": 20400,
        "inj_next": 20640, "tail": 20880, "req": 26000, "inj_row": 27280,
        "local_stream": 43600, "side": -1, "link_last": -1, "payload": -1}
    assert (lay.bytes, lay.threads) == (178496, 1024)
    assert lay.bytes + 4 * 256 * 5 * 4 * 4 > SMEM_BYTES - 64


def test_smem_layout_refuses_state_that_fits_nowhere():
    # 512 routers with 32 VCs: head, count and tails alone are ~1 MB.
    with pytest.raises(ValueError, match=f"{SMEM_BYTES} bytes"):
        rs.smem_layout((16, 32, 32, 4, 16), 16)
