"""Port parity: MC placements, packet->MC affinity and the Tab. II power
model of ``repro_torch`` against live ``repro``.

* ``noc.power`` equal to ``repro.noc.power`` to the last float bit over a
  grid of arguments, and the paper's worked example (155.008 / 476.672 mW);
* ``mc_placement`` for every strategy, and ``affinity_mc_table`` /
  ``packet_mean_hops(mc_table=...)`` under every placement, on 2x2 to 16x16
  meshes (the same errors where the reference refuses);
* the request packetizer under ``nearest`` affinity leaf for leaf: one-shot
  (``build_traffic_batch``) at 8 packets a layer, and streamed
  (``build_traffic_streamed_multi`` with ``mc_tables``) on LeNet's full
  traffic at 4x4_mc2 x {edge, interleaved} x {roundrobin, nearest}.
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")

from repro.noc import power as jpower, topology as jtop  # noqa: E402
from repro.noc import traffic as jtraffic  # noqa: E402
from repro_torch.noc import power, topology, traffic  # noqa: E402

from test_torch_traffic import (_assert_traffic_equal, _layers_np,  # noqa: E402,F401
                                _variants, one_torch_thread, ref,
                                ref_layers)

MESHES = [(2, 2), (3, 5), (4, 4), (6, 6), (8, 8), (16, 16)]


def test_power_model_matches_reference():
    assert power.HW == power.HWConstants() and dataclasses.asdict(
        power.HW) == dataclasses.asdict(jpower.HW)
    for e in (power.HW.e_bit_ours_pj, power.HW.e_bit_banerjee_pj, 0.3):
        assert power.paper_example(e) == jpower.paper_example(e)
        for tog, links in itertools.product((0.0, 1.5, 64, 77.25), (1, 112)):
            assert (power.link_power_mw(tog, num_links=links, e_bit_pj=e)
                    == jpower.link_power_mw(tog, num_links=links, e_bit_pj=e))
    assert abs(power.paper_example() - 155.008) < 1e-9
    assert abs(power.paper_example(power.HW.e_bit_banerjee_pj)
               - 476.672) < 1e-9
    for mcs, sep in itertools.product((1, 2, 4, 8, 16), (False, True)):
        assert (power.ordering_overhead_mw(mcs, sep)
                == jpower.ordering_overhead_mw(mcs, sep))
        for red, tog in itertools.product((0.0, 0.1085, 0.4085, 1.0),
                                          (12.5, 64)):
            assert (power.net_power_saving_mw(tog, red, 112, mcs,
                                              separated=sep)
                    == jpower.net_power_saving_mw(tog, red, 112, mcs,
                                                  separated=sep))


def _outcome(fn, *args):
    """The value, or the exception type, of ``fn(*args)``."""
    try:
        return fn(*args)
    except (KeyError, ValueError) as e:
        return type(e)


@pytest.mark.parametrize("rows,cols", MESHES)
def test_mc_placement_matches_reference(rows, cols):
    placed = {}
    for strategy in topology.PLACEMENTS + ("middle",):
        for n in range(0, rows * cols + 1):
            got = _outcome(topology.mc_placement, rows, cols, n, strategy)
            assert got == _outcome(jtop.mc_placement, rows, cols, n,
                                   strategy), (strategy, n)
            placed[strategy] = placed.get(strategy, 0) + isinstance(got,
                                                                    tuple)
    assert topology.PLACEMENTS == jtop.PLACEMENTS
    boundary = rows * cols - max(rows - 2, 0) * max(cols - 2, 0)
    # interleaved places past the boundary; an unknown strategy nowhere
    assert placed == {"edge": min(boundary, rows * cols - 1),
                      "corner": min(boundary, rows * cols - 1),
                      "interleaved": rows * cols - 1, "middle": 0}


@pytest.mark.parametrize("rows,cols", MESHES)
def test_affinity_table_and_hops_match_reference(rows, cols):
    assert topology.AFFINITIES == jtop.AFFINITIES
    boundary = rows * cols - max(rows - 2, 0) * max(cols - 2, 0)
    for strategy in topology.PLACEMENTS:
        for n in sorted({1, 2, 4, min(8, boundary), min(16, boundary)}):
            if n >= rows * cols:
                continue
            cfg = topology.make_noc(rows, cols, n, strategy)
            jcfg = jtop.make_noc(rows, cols, n, strategy)
            assert cfg.mc_nodes == jcfg.mc_nodes
            tbl = topology.affinity_mc_table(cfg)
            np.testing.assert_array_equal(tbl, jtop.affinity_mc_table(jcfg))
            for g in (1, 40, 6518):
                for t in (None, tbl):
                    assert (topology.packet_mean_hops(cfg, g, t)
                            == jtop.packet_mean_hops(jcfg, g, t))


def _combos(mesh, placements):
    cfg, jcfg = topology.mesh_by_name(mesh), jtop.mesh_by_name(mesh)
    out = []
    for pl in placements:
        c = dataclasses.replace(cfg, mc_nodes=topology.mc_placement(
            cfg.rows, cfg.cols, cfg.num_mcs, pl))
        jc = dataclasses.replace(jcfg, mc_nodes=jtop.mc_placement(
            cfg.rows, cfg.cols, cfg.num_mcs, pl))
        for aff in topology.AFFINITIES:
            near = aff == "nearest"
            out.append((c, jc, topology.affinity_mc_table(c) if near else None,
                        jtop.affinity_mc_table(jc) if near else None))
    return out


@pytest.mark.parametrize("mesh", ["4x4_mc2", "8x8_mc4"])
def test_one_shot_request_traffic_with_affinity_matches_reference(
        ref_layers, mesh):
    layers = _layers_np(ref_layers)
    for c, jc, tbl, jtbl in _combos(mesh, topology.PLACEMENTS):
        got = traffic.build_traffic_batch(layers, c, _variants(True)[3:6],
                                          max_packets_per_layer=8,
                                          mc_table=tbl, device="cpu")
        want = jtraffic.build_traffic_batch(ref_layers, jc,
                                            _variants(False)[3:6],
                                            max_packets_per_layer=8,
                                            mc_table=jtbl)
        _assert_traffic_equal(got, want)
        shapes = jtraffic.payload_shapes(ref_layers, 16, _variants(False)[:1],
                                         max_packets_per_layer=8)
        for m in (1, 2, 3):
            t = None if tbl is None else tbl % m
            np.testing.assert_array_equal(
                traffic.stream_lengths(shapes, m, t),
                jtraffic.stream_lengths(shapes, m, t))


def test_streamed_multi_with_mc_tables_matches_reference(ref_layers):
    """LeNet's full traffic (every packet), one ordering pass for four
    (placement, affinity) combos; the nearest lanes' streams are unequal."""
    combos = _combos("4x4_mc2", ("edge", "interleaved"))
    variants = [_variants(True)[10]], [_variants(False)[10]]   # fixed8 O1
    got = traffic.build_traffic_streamed_multi(
        _layers_np(ref_layers), [c for c, *_ in combos], variants[0],
        chunk_packets=1024, num_streams=3,
        mc_tables=[t for _, _, t, _ in combos], device="cpu")
    want = jtraffic.build_traffic_streamed_multi(
        ref_layers, [jc for _, jc, *_ in combos], variants[1],
        chunk_packets=1024, num_streams=3,
        mc_tables=[t for *_, t in combos])
    for (_, _, tbl, _), g, w in zip(combos, got, want):
        _assert_traffic_equal(g, w)
        a, b, pad = g.length[0].tolist()
        assert pad == 0 and (a == b) == (tbl is None)
