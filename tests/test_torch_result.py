"""Port parity: the PE->MC result phase of ``repro_torch`` against live
``repro`` on the reference's LeNet ``LayerTraffic``.

* ``layer_results``: float32 sums taken in PyTorch's order, not XLA's
  (ROADMAP C11), so each value is held to the summation error bound
  ``2 k u sum_k |x y|`` (``u = 2^-24``: both sums are within ``k u sum |x y|``
  of the exact one) and the count that differ bitwise is reported;
* ``build_result_traffic`` leaf for leaf, fed the reference's values, at
  4x4_mc2 and 8x8_mc4 under every placement and both affinities, result
  windows 64 and 7, padded PE streams;
* ``run_sweep`` rows at 4x4_mc2 with every placement, both affinities and
  ``result_phase=True``: ``result_cycles`` / ``result_flits`` (and every
  request column) exact on the port's own values; every column of every
  row exact once both sweeps get the reference's values.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")

from repro.noc import SweepGrid as JGrid, run_sweep as jrun_sweep  # noqa: E402
from repro.noc import topology as jtop, traffic as jtraffic  # noqa: E402
from repro_torch.noc import SweepGrid, run_sweep, sweep  # noqa: E402
from repro_torch.noc import topology, traffic  # noqa: E402

from test_torch_traffic import (CELLS, _assert_traffic_equal,  # noqa: E402,F401
                                _layers_np, _variants, one_torch_thread, ref,
                                ref_layers)

SWEEP = dict(meshes=("4x4_mc2",), placements=("edge", "corner", "interleaved"),
             affinity=("roundrobin", "nearest"), transforms=("O0", "O1", "O2"),
             tiebreaks=("pattern",), precisions=("float32", "fixed8"),
             models=("lenet",), max_packets_per_layer=8, chunk=128,
             result_phase=True)
RESULT_COLUMNS = ("result_bt", "result_adjusted_bt",
                  "result_adjusted_reduction_pct")


def _reference_values(ref_layers, variants, max_packets):
    return [[torch.from_numpy(np.array(v)) for v in layer]
            for layer in jtraffic.result_values(ref_layers, variants,
                                                max_packets)]


@pytest.mark.parametrize("max_packets", [8, None])
def test_layer_results_within_summation_bound(ref_layers, max_packets):
    differ = total = 0
    for lt, jlt in zip(_layers_np(ref_layers), ref_layers):
        got = traffic.layer_results(lt, max_packets, device="cpu").numpy()
        want = np.asarray(jtraffic.layer_results(jlt, max_packets))
        inp, wgt = traffic._subsample(lt, max_packets, torch.device("cpu"))
        k = inp.shape[1]
        bound = 2 * k * 2.0**-24 * (inp * wgt).abs().sum(dim=1).numpy()
        assert got.dtype == want.dtype == np.float32
        assert np.all(np.abs(got.astype(np.float64) - want) <= bound)
        differ += int((got.view(np.int32) != want.view(np.int32)).sum())
        total += want.size
    print(f"layer_results: {differ} of {total} values differ bitwise from "
          "the reference's (C11)")
    assert total == (40 if max_packets else 6518)


@pytest.mark.parametrize("mesh", ["4x4_mc2", "8x8_mc4"])
@pytest.mark.parametrize("window", [64, 7])
def test_result_traffic_matches_reference(ref_layers, mesh, window):
    layers = _layers_np(ref_layers)
    jvariants = _variants(False)[6:]                  # fixed8, both tiebreaks
    values = _reference_values(ref_layers, jvariants, 8)
    cfg, jcfg = topology.mesh_by_name(mesh), jtop.mesh_by_name(mesh)
    pad = cfg.num_routers - cfg.num_mcs + 2
    for placement in topology.PLACEMENTS:
        nodes = topology.mc_placement(cfg.rows, cfg.cols, cfg.num_mcs,
                                      placement)
        c = dataclasses.replace(cfg, mc_nodes=nodes)
        jc = dataclasses.replace(jcfg, mc_nodes=nodes)
        for near in (False, True):
            tbl = topology.affinity_mc_table(c) if near else None
            got = traffic.build_result_traffic(
                layers, c, _variants(True)[6:], max_packets_per_layer=8,
                mc_table=tbl, result_window=window, num_streams=pad,
                values=values, device="cpu")
            want = jtraffic.build_result_traffic(
                ref_layers, jc, jvariants, max_packets_per_layer=8,
                mc_table=jtop.affinity_mc_table(jc) if near else None,
                result_window=window, num_streams=pad)
            _assert_traffic_equal(got, want)
            assert got.length.shape == (6, pad)
    # Without values the port takes its own sums: the same skeleton.
    own = traffic.build_result_traffic(layers, cfg, _variants(True)[:1],
                                       max_packets_per_layer=8,
                                       result_window=window, device="cpu")
    ref_own = jtraffic.build_result_traffic(ref_layers, jcfg,
                                            _variants(False)[:1],
                                            max_packets_per_layer=8,
                                            result_window=window)
    for f in ("dest", "meta", "vc", "pkt", "length"):
        np.testing.assert_array_equal(getattr(own, f).numpy(),
                                      np.asarray(getattr(ref_own, f)), f)


def test_result_traffic_refuses_msr_and_bad_arguments(ref_layers):
    layers = _layers_np(ref_layers)
    cfg = topology.mesh_by_name("4x4_mc2")
    v = _variants(True)[6:7]
    # MSR codes int8 payloads: float32 result values are refused.
    with pytest.raises(TypeError, match="int8"):
        traffic.build_result_traffic(layers, cfg, _variants(True)[:1],
                                     max_packets_per_layer=8,
                                     compression="msr", device="cpu")
    with pytest.raises(ValueError, match="compression"):
        traffic.build_result_traffic(layers, cfg, v, compression="zip",
                                     device="cpu")
    with pytest.raises(ValueError, match="result_window"):
        traffic.build_result_traffic(layers, cfg, v, result_window=0,
                                     device="cpu")
    with pytest.raises(ValueError, match="PE streams"):
        traffic.build_result_traffic(layers, cfg, v, num_streams=13,
                                     device="cpu")


def test_sweep_rows_with_placements_affinity_and_result_phase(ref_layers,
                                                              monkeypatch):
    want = jrun_sweep(JGrid(**SWEEP, backend="fused"),
                      lambda _name: ref_layers, devices=None)
    layers = _layers_np(ref_layers)
    got = run_sweep(SweepGrid(**SWEEP, device="cpu"), lambda _name: layers)
    assert len(got.rows) == len(want.rows) == 36
    assert got.stats["ejected_equals_injected"]
    for g, w in zip(got.rows, want.rows):
        assert list(g) == list(w)
        assert ({k: v for k, v in g.items() if k not in RESULT_COLUMNS}
                == {k: v for k, v in w.items() if k not in RESULT_COLUMNS})
    assert {r["placement"] for r in got.rows} == set(topology.PLACEMENTS)
    assert all(r["result_flits"] > 0 for r in got.rows)

    # Handed the reference's result values, every column of every row.
    values = _reference_values(ref_layers, _sweep_variants(False), 8)
    monkeypatch.setattr(sweep, "result_values", lambda *a, **k: values)
    got = run_sweep(SweepGrid(**SWEEP, device="cpu"), lambda _name: layers)
    assert got.rows == want.rows
    assert got.stats["result_cycles"] == want.stats["result_cycles"]


def _sweep_variants(torch_side):
    """``SWEEP``'s variants in its batch order (precision, transform)."""
    return [v for (_, tb, _), v in zip(CELLS, _variants(torch_side))
            if tb == "pattern"]



def test_run_sweep_stage_spans(ref_layers, monkeypatch):
    """Each stage of a (mesh, model) runs in one profiler span of its name,
    the spans one after another in the stages' order."""
    import contextlib
    entered = []

    @contextlib.contextmanager
    def span(name):
        entered.append(name)
        yield
        assert entered[-1] == name

    monkeypatch.setattr(sweep, "record_function", span)
    layers = _layers_np(ref_layers)
    grid = SweepGrid(**dict(SWEEP, placements=("edge",),
                            affinity=("nearest",), transforms=("O0",),
                            precisions=("fixed8",), max_packets_per_layer=2),
                     device="cpu")
    rows = run_sweep(grid, lambda _name: layers).rows
    assert entered == [f"run_sweep/{stage}" for stage in (
        "packetize", "drain", "result_packetize", "result_drain")]
    assert len(rows) == 1 and rows[0]["result_flits"] > 0
