"""Port parity: ``repro_torch.noc.run_sweep`` rows on its streamed path
(``max_packets_per_layer=None``) against live ``repro.noc.run_sweep``."""
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")

from repro.noc import SweepGrid as JGrid, run_sweep as jrun_sweep  # noqa: E402
from repro_torch.noc import SweepGrid, run_sweep  # noqa: E402

from test_torch_sweep import AXES  # noqa: E402
from test_torch_traffic import (_layers_np, one_torch_thread,  # noqa: E402,F401
                                ref, ref_layers)


def test_streamed_sweep_rows_match_reference(ref_layers):
    """``max_packets_per_layer=None`` takes the streamed packetizer (full
    layers, here cut to their first 6 packets so the reference stays
    quick), in ragged chunks of 4 packets."""
    from repro.noc.traffic import LayerTraffic as JLayer
    short = [JLayer(lt.inputs[:6], lt.weights[:6]) for lt in ref_layers]
    axes = dict(AXES, max_packets_per_layer=None, stream_chunk_packets=4,
                tiebreaks=("stable",))
    want = jrun_sweep(JGrid(**axes, backend="fused"), lambda _name: short,
                      devices=None)
    layers = _layers_np(short)
    got = run_sweep(SweepGrid(**axes, device="cpu"), lambda _name: layers)
    assert got.stats["streamed"] and want.stats["streamed"]
    assert got.rows == want.rows
