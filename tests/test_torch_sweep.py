"""Port parity: ``repro_torch.noc.run_sweep`` rows against live
``repro.noc.run_sweep(..., backend="fused")`` on 4x4_mc2 at the pinned
budget (8 packets per layer, chunk 128, both precisions and tiebreaks,
O0/O1/O2). Every key and value of every row must be equal, in order. The
placement, affinity and result-phase axes are in test_torch_result.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")

from repro.noc import SweepGrid as JGrid, run_sweep as jrun_sweep  # noqa: E402
from repro_torch.noc import SweepGrid, run_sweep  # noqa: E402

from test_torch_traffic import (_layers_np, one_torch_thread,  # noqa: E402,F401
                                ref, ref_layers)

AXES = dict(meshes=("4x4_mc2",), transforms=("O0", "O1", "O2"),
            tiebreaks=("stable", "pattern"), precisions=("float32", "fixed8"),
            models=("lenet",), max_packets_per_layer=8, chunk=128)


def test_sweep_rows_match_reference(ref_layers):
    want = jrun_sweep(JGrid(**AXES, backend="fused"),
                      lambda _name: ref_layers, devices=None)
    layers = _layers_np(ref_layers)
    got = run_sweep(SweepGrid(**AXES, device="cpu"), lambda _name: layers)
    assert len(got.rows) == len(want.rows) == 12
    for g, w in zip(got.rows, want.rows):
        assert list(g) == list(w)
        assert g == w
    assert got.stats["cells"] == want.stats["cells"]
    assert got.stats["stepped_cycles"] == want.stats["stepped_cycles"]


def test_sweep_rows_on_two_same_size_meshes(ref_layers):
    """8x8_mc4 and 8x8_mc8 share a size group (MC streams padded to 8)."""
    axes = dict(AXES, meshes=("8x8_mc4", "8x8_mc8"), tiebreaks=("pattern",),
                precisions=("fixed8",), max_packets_per_layer=4)
    want = jrun_sweep(JGrid(**axes, backend="fused"),
                      lambda _name: ref_layers, devices=None)
    layers = _layers_np(ref_layers)
    got = run_sweep(SweepGrid(**axes, device="cpu"), lambda _name: layers)
    assert got.rows == want.rows


@pytest.mark.parametrize("mesh", ["2x2_mc1", "4x4_mc2", "8x8_mc4",
                                  "8x8_mc8", "6x6_mc4", "16x16_mc16"])
def test_topology_and_drain_estimate_match_reference(mesh):
    from repro.noc import sweep as jsweep, topology as jtop
    from repro_torch.noc import sweep, topology
    cfg, jcfg = topology.mesh_by_name(mesh), jtop.mesh_by_name(mesh)
    assert cfg.mc_nodes == jcfg.mc_nodes and cfg.pe_nodes == jcfg.pe_nodes
    assert torch.equal(topology.xy_route(cfg),
                       torch.from_numpy(np.array(jtop.xy_route(jcfg))))
    assert torch.equal(topology.neighbor_table(cfg),
                       torch.from_numpy(np.array(jtop.neighbor_table(jcfg))))
    np.testing.assert_array_equal(topology.mean_hop_counts(cfg),
                                  jtop.mean_hop_counts(jcfg))
    lengths = np.arange(3, 3 + cfg.num_mcs) * 97
    np.testing.assert_array_equal(topology.xy_link_loads(cfg, lengths),
                                  jtop.xy_link_loads(jcfg, lengths))
    assert sweep.drain_estimate(cfg, lengths) == jsweep.drain_estimate(
        jcfg, lengths)
    for n in (1, 40, 6518):
        assert (topology.packet_mean_hops(cfg, n)
                == jtop.packet_mean_hops(jcfg, n))


def test_later_slice_placements_raise():
    """The placements that once raised (they arrived with the placement
    slice): every strategy equal to the reference's on the paper meshes
    and 16x16_mc16, and the sweep's placement / affinity validation."""
    from repro.noc import topology as jtop
    from repro_torch.noc import topology
    for rows, cols, n in ((4, 4, 2), (8, 8, 4), (8, 8, 8), (16, 16, 16)):
        for strategy in topology.PLACEMENTS:
            assert (topology.mc_placement(rows, cols, n, strategy)
                    == jtop.mc_placement(rows, cols, n, strategy))
    # interleaved puts every MC of these meshes in column 0 (the reference's
    # int(i * nr / n), row-major)
    assert topology.mc_placement(16, 16, 16, "interleaved") == tuple(
        range(0, 256, 16))
    with pytest.raises(ValueError, match="placements"):
        SweepGrid(placements=("middle",))
    with pytest.raises(ValueError, match="affinity"):
        SweepGrid(affinity=("farthest",))
