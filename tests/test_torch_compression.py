"""Port parity: MSR compression through the packetizer and the sweep of
``repro_torch`` against live ``repro``, on the reference's LeNet traffic
at fixed8.

* ``run_sweep`` rows for ``compression=("none", "msr")`` with the result
  phase on 4x4_mc2 at 8 packets a layer (O0/O1/O2, both sides fed the
  reference's result values, ROADMAP C11): every column equal to the
  reference's, and the ``none`` rows equal to a grid without the axis;
* ``ordered_payloads``, ``payload_shapes`` and ``compression_overhead``
  under ``msr`` equal to the reference's for O0-O2; O3's words equal the
  reference's numpy codec oracle over the port's O3 order (which
  test_torch_o3.py holds to the reference's) and its geometry the
  reference's ``compressed_paired_payload_flits``, so the reference's O3
  chain is not compiled here (nor its streamed path: the port's streamed
  path is held to its one-shot path, O0-O3);
* ``build_result_traffic(compression="msr")`` leaf for leaf, both sides
  fed the reference's result values;
* ``msr`` with float32 refused.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")

from repro.core import msr as jmsr  # noqa: E402
from repro.core.wire import by_name as jby_name  # noqa: E402
from repro.noc import SweepGrid as JGrid, run_sweep as jrun_sweep  # noqa: E402
from repro.noc import traffic as jtraffic  # noqa: E402
from repro.noc.topology import mesh_by_name as jmesh  # noqa: E402
from repro.quant import quantize_fixed8 as jquant  # noqa: E402
from repro_torch.core.wire import by_name  # noqa: E402
from repro_torch.noc import SweepGrid, run_sweep, sweep, traffic  # noqa: E402
from repro_torch.noc.topology import mesh_by_name  # noqa: E402
from repro_torch.quant import quantize_fixed8  # noqa: E402

from test_torch_traffic import (_assert_traffic_equal,  # noqa: E402,F401
                                _layers_np, one_torch_thread, ref,
                                ref_layers)

TRANSFORMS = ("O0", "O1", "O2")
SWEEP = dict(meshes=("4x4_mc2",), transforms=TRANSFORMS,
             tiebreaks=("pattern",), precisions=("fixed8",),
             models=("lenet",), compression=("none", "msr"),
             max_packets_per_layer=8, chunk=128, result_phase=True)


def _fixed8_variants(torch_side, transforms=TRANSFORMS):
    if torch_side:
        return [(by_name(o, tiebreak="pattern"),
                 lambda t: quantize_fixed8(t).values) for o in transforms]
    return [(jby_name(o, tiebreak="pattern"), lambda t: jquant(t).values)
            for o in transforms]


def _reference_values(ref_layers):
    return [[torch.from_numpy(np.array(v)) for v in layer]
            for layer in jtraffic.result_values(
                ref_layers, _fixed8_variants(False), 8)]


def test_msr_sweep_rows_match_reference(ref_layers, monkeypatch):
    want = jrun_sweep(JGrid(**SWEEP, backend="fused"),
                      lambda _name: ref_layers, devices=None)
    layers = _layers_np(ref_layers)
    values = _reference_values(ref_layers)
    monkeypatch.setattr(sweep, "result_values", lambda *a, **k: values)
    got = run_sweep(SweepGrid(**SWEEP, device="cpu"), lambda _name: layers)
    assert len(got.rows) == len(want.rows) == 6
    for g, w in zip(got.rows, want.rows):
        assert list(g) == list(w)
        assert g == w
    assert [c["compression"] for c in got.stats["shape_classes"]] == [
        "none", "msr"]
    msr_rows = [r for r in got.rows if r["compression"] == "msr"]
    assert all(r["compression_overhead_bits"] > 0
               and r["result_compression_overhead_bits"] > 0
               and r["flits"] < got.rows[0]["flits"] for r in msr_rows)
    # The none rows equal a grid that never names the axis.
    plain = run_sweep(SweepGrid(**dict(SWEEP, compression=("none",)),
                                device="cpu"), lambda _name: layers)
    assert plain.rows == [r for r in got.rows if r["compression"] == "none"]


def test_msr_request_payloads_and_overhead_match_reference(ref_layers):
    layers = _layers_np(ref_layers)
    lanes = 16
    want = jtraffic.ordered_payloads(ref_layers, lanes,
                                     _fixed8_variants(False),
                                     max_packets_per_layer=8,
                                     compression="msr")
    got = traffic.ordered_payloads(layers, lanes, _fixed8_variants(True),
                                   max_packets_per_layer=8,
                                   compression="msr", device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), w)
    # O3: the reference's numpy oracle over the port's own O3 order.
    v4 = _fixed8_variants(True, TRANSFORMS + ("O3",))
    (o3, q), = v4[3:]
    stacks = []
    for g, lt in zip(got, layers):
        inp, wgt = traffic._subsample(lt, 8, torch.device("cpu"))
        oi, ow = o3.order_packets(q(inp), q(wgt), lanes)
        words = traffic.msr.msr_pack_paired_rows(oi, ow, lanes)
        assert words.shape[1] == jmsr.compressed_paired_payload_flits(
            inp.shape[1], lanes) == g.shape[2]
        for row in range(inp.shape[0]):
            np.testing.assert_array_equal(
                words[row].numpy(), jmsr.msr_pack_paired_reference(
                    oi[row].numpy(), ow[row].numpy(), lanes))
        stacks.append(torch.cat([g, words[None]]))
    shapes = traffic.payload_shapes(layers, lanes, v4,
                                    max_packets_per_layer=8,
                                    compression="msr", device="cpu")
    assert shapes == [tuple(w.shape[1:3]) for w in want]
    # The streamed path, in chunks of 5 packets, equals the one-shot words.
    cfg = mesh_by_name("4x4_mc2")
    _assert_traffic_equal(
        traffic.build_traffic_streamed(layers, cfg, v4, chunk_packets=5,
                                       max_packets_per_layer=8,
                                       compression="msr", device="cpu"),
        traffic.assemble_traffic(stacks, cfg, device="cpu"))
    for q, jq, comp in ((v4[0][1], _fixed8_variants(False)[0][1], "msr"),
                        (None, None, "none")):
        for ln in (16, 8):
            assert traffic.compression_overhead(
                layers, q, ln, comp, max_packets_per_layer=8,
                device="cpu") == jtraffic.compression_overhead(
                    ref_layers, jq, ln, comp, max_packets_per_layer=8)
    with pytest.raises(ValueError, match="compression"):
        traffic.payload_shapes(layers, 16, v4, compression="zip",
                               device="cpu")


@pytest.mark.parametrize("window", [64, 7])
def test_msr_result_traffic_matches_reference(ref_layers, window):
    cfg, jcfg = mesh_by_name("4x4_mc2"), jmesh("4x4_mc2")
    want = jtraffic.build_result_traffic(
        ref_layers, jcfg, _fixed8_variants(False), max_packets_per_layer=8,
        result_window=window, num_streams=15, compression="msr")
    got = traffic.build_result_traffic(
        _layers_np(ref_layers), cfg, _fixed8_variants(True),
        max_packets_per_layer=8, result_window=window, num_streams=15,
        values=_reference_values(ref_layers), compression="msr",
        device="cpu")
    _assert_traffic_equal(got, want)


def test_msr_refuses_float32():
    with pytest.raises(ValueError, match="int8"):
        SweepGrid(precisions=("float32", "fixed8"), compression=("msr",))
    with pytest.raises(ValueError, match="compression"):
        SweepGrid(compression=("zip",))
    with pytest.raises(ValueError, match="compression"):
        SweepGrid(compression=())
    cfg = mesh_by_name("4x4_mc2")
    x = torch.zeros((3, 9))
    with pytest.raises(TypeError, match="int8"):
        traffic.build_traffic([traffic.LayerTraffic(x, x)], cfg,
                              by_name("O1"), compression="msr", device="cpu")
