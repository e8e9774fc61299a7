"""Port parity: the simulator of ``repro_torch.noc.sim`` against live
``repro.noc.sim``.

* The plain step (the CPU path, the oracle of the Hopper router kernel)
  against the reference's fused step (``backend="fused"``, which
  tests/test_kernel_parity.py pins to the Pallas body) on the 12 pinned
  cells of each paper mesh (4x4_mc2, 8x8_mc4, 8x8_mc8): ``link_bt``,
  ``inj_bt``, ``total_bt``, ``drain_cycle`` and ``ejected`` exactly equal.
* One cycle on a 2x2 mesh against ``router_step_pallas(...,
  interpret=True)`` directly: all 13 leaves equal except the FIFO's
  phantom router row (whose masked-out writes the port may skip).
* ``DrainTimeout`` when ``max_cycles`` is too small.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.router_step import router_step_pallas  # noqa: E402
from repro.noc import sim as jsim, traffic as jtraffic  # noqa: E402
from repro.noc.topology import mesh_by_name as jmesh  # noqa: E402
from repro_torch.noc import sim  # noqa: E402
from repro_torch.noc.topology import mesh_by_name  # noqa: E402

from test_torch_traffic import (_layers_np, _variants,  # noqa: E402,F401
                                one_torch_thread, ref, ref_layers)
from repro_torch.noc import traffic  # noqa: E402

CHUNK = 128


@pytest.mark.parametrize("mesh", ["4x4_mc2", "8x8_mc4", "8x8_mc8"])
def test_plain_step_matches_reference_fused_on_pinned_cells(ref_layers, mesh):
    jbatch = jtraffic.build_traffic_batch(ref_layers, jmesh(mesh),
                                          _variants(False),
                                          max_packets_per_layer=8)
    want = jsim.simulate_batch(jmesh(mesh), jbatch, chunk=CHUNK,
                               backend="fused")
    batch = traffic.build_traffic_batch(_layers_np(ref_layers),
                                        mesh_by_name(mesh), _variants(True),
                                        max_packets_per_layer=8, device="cpu")
    got = sim.simulate_batch(mesh_by_name(mesh), batch, chunk=CHUNK,
                             backend="plain", device="cpu")
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g.total_bt == w.total_bt
        assert g.drain_cycle == w.drain_cycle
        assert g.ejected == w.ejected == g.injected == w.injected
        assert g.cycles == w.cycles
        np.testing.assert_array_equal(g.link_bt, np.asarray(w.link_bt))
        np.testing.assert_array_equal(g.inj_bt, np.asarray(w.inj_bt))
        np.testing.assert_array_equal(g.link_flits, np.asarray(w.link_flits))


def test_single_simulate_matches_reference(ref_layers):
    cfg, jcfg = mesh_by_name("4x4_mc2"), jmesh("4x4_mc2")
    jt = jtraffic.build_traffic_batch(ref_layers, jcfg, _variants(False)[4:5],
                                      max_packets_per_layer=8).variant(0)
    t = traffic.build_traffic_batch(_layers_np(ref_layers), cfg,
                                    _variants(True)[4:5],
                                    max_packets_per_layer=8,
                                    device="cpu").variant(0)
    for headers in (True, False):
        w = jsim.simulate(jcfg, jt, chunk=64, count_headers=headers,
                          backend="fused")
        g = sim.simulate(cfg, t, chunk=64, count_headers=headers,
                         device="cpu")
        assert (g.total_bt, g.drain_cycle, g.cycles, g.inter_router_bt) == (
            w.total_bt, w.drain_cycle, w.cycles, w.inter_router_bt)
        np.testing.assert_array_equal(g.link_bt, np.asarray(w.link_bt))


def _to_jax_leaves(state, lane=0):
    """Port state lane -> the Pallas kernel's 13 leaves (fifo as rows)."""
    u32 = lambda t: jnp.asarray(t[lane].numpy().view(np.uint32))  # noqa: E731
    i32 = lambda t: jnp.asarray(t[lane].numpy())  # noqa: E731
    lf = state.fifo.shape[-1]
    return (jnp.asarray(state.fifo[lane].reshape(-1, lf).numpy()
                        .view(np.uint32)),
            i32(state.head), i32(state.count), i32(state.rr),
            u32(state.link_last), i32(state.link_bt), i32(state.link_flits),
            i32(state.inj_ptr), u32(state.inj_last), i32(state.inj_bt),
            i32(state.ejected[:, None]), i32(state.cycle[:, None]),
            i32(state.drained_at[:, None]))


@pytest.mark.parametrize("cycles_before", [0, 5, 23])
def test_one_cycle_matches_pallas_router_kernel(ref_layers, cycles_before):
    """Mid-flight state on a 2x2 mesh: one plain step == one interpret-mode
    Pallas router step, leaf for leaf (FIFO compared on real routers)."""
    cfg = mesh_by_name("2x2_mc1")
    key = (2, 2, cfg.num_vcs, cfg.vc_depth, cfg.lanes)
    t = traffic.build_traffic_batch(_layers_np(ref_layers), cfg,
                                    _variants(True)[7:8],
                                    max_packets_per_layer=4, device="cpu")
    wire = sim.fuse_traffic(t)
    mc = torch.zeros((1, 1), dtype=torch.int32)
    state = sim.make_state(cfg, 1, device="cpu")
    for _ in range(cycles_before):
        state = sim.plain_step(state, wire, mc, key, True)
    nxt = sim.plain_step(state, wire, mc, key, True)

    m, t_cap = wire.length.shape[1], wire.wire.shape[2]
    ptr = state.inj_ptr[0].numpy()
    iw = wire.wire[0, np.arange(m), np.minimum(ptr, t_cap - 1)]
    active = (ptr < wire.length[0].numpy()).astype(np.int32)
    out = router_step_pallas(
        key, True, cfg.lanes + 1, _to_jax_leaves(state),
        jnp.asarray(iw.numpy().view(np.uint32)), jnp.asarray(active),
        jnp.asarray(np.zeros(1, np.int32)),
        jnp.asarray(np.array([int(wire.length.sum())], np.int32)),
        interpret=True)
    want = [np.asarray(x) for x in out]
    got = [np.asarray(x) for x in _to_jax_leaves(nxt)]
    nr_rows = cfg.num_routers * 5 * cfg.num_vcs * cfg.vc_depth
    np.testing.assert_array_equal(got[0][:nr_rows], want[0][:nr_rows])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def test_drain_timeout_raises_with_diagnostics(ref_layers):
    cfg = mesh_by_name("4x4_mc2")
    t = traffic.build_traffic_batch(_layers_np(ref_layers), cfg,
                                    _variants(True)[:1],
                                    max_packets_per_layer=8, device="cpu")
    with pytest.raises(sim.DrainTimeout) as exc:
        sim.simulate_batch(cfg, t, chunk=16, max_cycles=32, device="cpu")
    assert exc.value.ejected < exc.value.total
    assert exc.value.pending or exc.value.occupancy
    with pytest.raises(sim.DrainTimeout):
        sim.simulate(cfg, t.variant(0), chunk=16, max_cycles=32,
                     device="cpu")


def test_backend_validation():
    cfg = mesh_by_name("2x2_mc1")
    t = traffic.build_traffic([], cfg, _variants(True)[0][0], device="cpu")
    with pytest.raises(ValueError, match="backend"):
        sim.simulate(cfg, t, backend="mosaic2000", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        sim.simulate(cfg, t, backend="cuda", device="cpu")
    # The router kernel carries no packet ledger: an explicit backend="cuda"
    # with the conservation check or the timestamps is refused.
    with pytest.raises(ValueError, match="ledger"):
        sim.simulate(cfg, t, check_conservation=True, backend="cuda",
                     device="cpu")
