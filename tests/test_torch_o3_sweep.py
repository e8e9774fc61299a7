"""Port parity: ``repro_torch.noc.run_sweep`` rows for O0/O3/O3a against
live ``repro.noc.run_sweep(..., backend="fused")`` on 4x4_mc2, LeNet, 2
packets per layer, both precisions and tiebreaks. Every key and value of
every row must be equal, in order (integers and floats alike: the float
fields are computed from the same integers). Kept apart from
test_torch_o3.py because the reference compiles one chain per layer shape
(~30 s on the CPU)."""
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")

from repro.noc import SweepGrid as JGrid, run_sweep as jrun_sweep  # noqa: E402
from repro_torch.noc import SweepGrid, run_sweep  # noqa: E402

from test_torch_traffic import (_layers_np, one_torch_thread,  # noqa: E402,F401
                                ref, ref_layers)


def test_o3_sweep_rows_match_reference(ref_layers):
    axes = dict(meshes=("4x4_mc2",), transforms=("O0", "O3", "O3a"),
                tiebreaks=("stable", "pattern"),
                precisions=("float32", "fixed8"), models=("lenet",),
                max_packets_per_layer=2, chunk=128)
    want = jrun_sweep(JGrid(**axes, backend="fused"),
                      lambda _name: ref_layers, devices=None)
    layers = _layers_np(ref_layers)
    got = run_sweep(SweepGrid(**axes, device="cpu"), lambda _name: layers)
    assert len(got.rows) == len(want.rows) == 12
    for g, w in zip(got.rows, want.rows):
        assert list(g) == list(w)
        assert g == w
    assert got.stats["stepped_cycles"] == want.stats["stepped_cycles"]
    assert sorted(got.stats["packetize_by_transform"]) == ["O0", "O3", "O3a"]
