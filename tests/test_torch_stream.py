"""Port parity: the streamed request packetizer of ``repro_torch`` against
live ``repro`` on the reference's ``LayerTraffic`` (4x4_mc2, the 12 pinned
variants, ragged packet chunks), and against the port's own one-shot path.
Every Traffic field must be exactly equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")

from repro.noc import traffic as jtraffic  # noqa: E402
from repro.noc.topology import mesh_by_name as jmesh  # noqa: E402
from repro_torch.noc import traffic  # noqa: E402
from repro_torch.noc.topology import mesh_by_name  # noqa: E402

from test_torch_traffic import (_assert_traffic_equal, _layers_np,  # noqa: E402,F401
                                _variants, one_torch_thread, ref,
                                ref_layers)


@pytest.mark.parametrize("chunk", [3, 16])
def test_streamed_path_matches_reference_and_one_shot(ref_layers, chunk):
    cfg, jcfg = mesh_by_name("4x4_mc2"), jmesh("4x4_mc2")
    layers = _layers_np(ref_layers)
    want = jtraffic.build_traffic_streamed(
        ref_layers, jcfg, _variants(False), chunk_packets=chunk,
        max_packets_per_layer=40, num_streams=3)
    got = traffic.build_traffic_streamed(
        layers, cfg, _variants(True), chunk_packets=chunk,
        max_packets_per_layer=40, num_streams=3, device="cpu")
    _assert_traffic_equal(got, want)
    one = traffic.build_traffic_batch(layers, cfg, _variants(True),
                                      max_packets_per_layer=40, device="cpu")
    np.testing.assert_array_equal(got.words[:, :2].numpy(), one.words.numpy())
