"""A run driven on the CPU at a small size, past the harness's look for
a card, with the timed path broken underneath: ``correct`` comes out
false for each fault a cell can have, and true with none. The cells run
on one card, so no exchange between chips exists to leave out."""
import time

import torch

from conftest import ROOT
from harness import bench, cells

SMALL = dict(meshes=["4x4_mc2"], placements=["edge", "interleaved"],
             affinity=["roundrobin"], transforms=["O0", "O1", "O2"],
             max_packets_per_layer=3, chunk=64, max_cycles=20_000)


def _cell(workload="darknet.full_o012"):
    cell = cells.find_cell(cells.load_spec(ROOT), ROOT, workload)
    mix = dict(cell.traffic, grid=dict(cell.traffic["grid"], **SMALL))
    mix["check"] = dict(mix["check"], sweeps=1)
    return cell._replace(traffic=mix)


def _run(cell=None):
    return bench.run_cell(cell or _cell(), ROOT, 2**31 + 99, 0.01, False,
                          "cpu", time.perf_counter())["result"]


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"] is True and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert r["checks"]["row_mismatches"]["value"] == 0


def test_traced_run_reads_its_per_layer_metrics():
    """The traced path end to end: the profiler's window reduced, the
    breakdown written, each reader that finds something read (no card
    here, so the kernels' rooflines and the peak find nothing)."""
    cell = _cell()
    r = bench.run_cell(cell, ROOT, 2**31 + 7, 0.01, True, "cpu",
                       time.perf_counter())["result"]
    assert r["correct"] is True
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(r["metrics"]) == {m["name"] for m in cell.per_layer} - {
        "k1_roofline", "k6_roofline", "peak_mem_gib"}
    assert r["device"]["window_s"] > 0


def test_router_step_returning_its_state_unchanged(monkeypatch):
    from repro_torch.kernels import ref
    monkeypatch.setattr(ref, "router_step_ref",
                        lambda state, *a, **k: state)
    assert _run()["correct"] is False


def test_ordering_returning_the_packet_unchanged(monkeypatch):
    from repro_torch.core import wire
    monkeypatch.setattr(wire.WireTransform, "order_packets",
                        lambda self, i, w, lanes: (i, w))
    r = _run()
    assert r["correct"] is False
    assert r["checks"]["row_mismatches"]["value"] > 0


def test_half_the_lanes_drained_and_the_rest_copied(monkeypatch):
    """Half of the batch left out: the first half of each drain's lanes
    simulated, their mean result standing in for the rest."""
    from repro_torch.noc import sweep
    real = sweep.simulate_batch

    def half(cfg, traffic, **kw):
        b = int(traffic.length.shape[0])
        k = max(1, b // 2)
        sub = traffic._replace(**{f: getattr(traffic, f)[:k]
                                  for f in traffic._fields[:6]})
        kw["mc_nodes"] = kw["mc_nodes"][:k]
        res = real(cfg, sub, **kw)
        mean = res[0]
        mean.total_bt = sum(r.total_bt for r in res) // len(res)
        return res + [mean] * (b - k)

    monkeypatch.setattr(sweep, "simulate_batch", half)
    assert _run()["correct"] is False


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from repro_torch.noc import sim
    real = sim._result
    seen = []

    def altered(*a, **k):
        r = real(*a, **k)
        seen.append(1)
        if len(seen) % 7 == 0:
            r.total_bt += 1
        return r

    monkeypatch.setattr(sim, "_result", altered)
    r = _run()
    assert r["correct"] is False
    assert r["checks"]["row_mismatches"]["value"] >= 1


def test_control_in_the_programs_place(monkeypatch):
    """The control: the reference's forward on TF32-rounded operands in
    place of the program's forward."""
    from repro_torch.models import convnets
    from repro_torch.noc.traffic import LayerTraffic
    from reference.forward import forward_traffic, load_weights
    cell = _cell()
    weights = load_weights(ROOT, cell.config["weights"])

    def control(self, x):
        return [LayerTraffic(i.to(torch.float32), w) for i, w in
                forward_traffic(cell.config, weights, x, "tf32")]

    monkeypatch.setattr(convnets.DarkNetLike, "layer_traffic", control)
    r = _run(cell)
    assert r["correct"] is False
    assert (r["checks"]["forward_rel_err"]["value"]
            > r["checks"]["forward_rel_err"]["limit"])
