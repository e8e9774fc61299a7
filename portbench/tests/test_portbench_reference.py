"""The plain reference against the program's plain path on the CPU: the
rows of small grids equal, column for column; the forward's operand rows
within the limit and the control's (TF32 operands) beyond it."""
import json
import os

import pytest
import torch

from conftest import BENCH, ROOT
from reference.forward import forward_error, forward_traffic, load_weights
from reference.rows import mismatches, reference_rows
from harness.images import glyph_images

GRIDS = {
    "lenet_orders": ("lenet", dict(
        meshes=["4x4_mc2"], placements=["edge", "interleaved"],
        affinity=["roundrobin", "nearest"],
        transforms=["O0", "O1", "O2", "O3", "O3a"],
        tiebreaks=["stable", "pattern"], precisions=["float32", "fixed8"],
        compression=["none"], max_packets_per_layer=4, result_phase=True,
        chunk=64)),
    "lenet_msr": ("lenet", dict(
        meshes=["4x4_mc2", "6x6_mc4"], placements=["edge"],
        affinity=["roundrobin"], transforms=["O0", "O1", "O2", "O3"],
        tiebreaks=["pattern"], precisions=["fixed8"],
        compression=["none", "msr"], max_packets_per_layer=4,
        result_phase=True, chunk=64)),
    "darknet_16x16": ("darknet", dict(
        meshes=["16x16_mc16"], placements=["edge", "interleaved"],
        affinity=["roundrobin", "nearest"], transforms=["O0", "O2", "O3"],
        tiebreaks=["pattern"], precisions=["fixed8"],
        compression=["none", "msr"], max_packets_per_layer=2,
        result_phase=True, chunk=256)),
}


def _config(model):
    with open(os.path.join(BENCH, "configs", model + ".json")) as f:
        return json.load(f)


def _program_layers(model, seed):
    from repro_torch.models import trained_model
    cfg = _config(model)
    hw, _, ch = cfg["input_shape"]
    img = glyph_images(seed, 1, hw, ch, torch.device("cpu"))[0]
    tm = trained_model(model, "cpu")
    return cfg, img, tm.model.layer_traffic(img)


@pytest.mark.parametrize("case", sorted(GRIDS))
def test_reference_rows_equal_the_programs(case):
    from repro_torch.noc.sweep import SweepGrid, run_sweep
    model, grid = GRIDS[case]
    grid = dict(grid, models=[model])
    _, _, layers = _program_layers(model, 7)
    rep = run_sweep(SweepGrid(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in grid.items()}, device="cpu"),
                    lambda _m: layers, devices=None)
    want = reference_rows(grid, [(t.inputs, t.weights) for t in layers])
    assert len(want) == len(rep.rows)
    assert mismatches(rep.rows, want) == []
    # A row altered where it is produced is caught.
    rep.rows[len(rep.rows) // 2]["total_bt"] += 1
    assert len(mismatches(rep.rows, want)) == 1


@pytest.mark.parametrize("model", ["lenet", "darknet"])
def test_forward_within_limit_and_control_beyond(model):
    """The program's forward against the float64 reference reads far
    below the cell's limit; the control, the reference's forward on
    TF32-rounded operands put in the program's place, reads above it."""
    cfg, img, lts = _program_layers(model, 11)
    layers = [(t.inputs, t.weights) for t in lts]
    weights = load_weights(ROOT, cfg["weights"])
    ref = forward_traffic(cfg, weights, img)
    mix = {"lenet": "o3_grid", "darknet": "full_o012"}[model]
    with open(os.path.join(BENCH, "traffic", mix + ".json")) as f:
        limit = json.load(f)["check"]["limits"]["forward_rel_err"]
    assert forward_error(layers, ref) < limit / 3
    control = forward_traffic(cfg, weights, img, "tf32")
    assert forward_error(control, ref) > 3 * limit
