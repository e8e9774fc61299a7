"""The port's drain autotune (``repro_torch.noc.tune``) and
``simulate_batch(compact_ratio=)``.

* every candidate schedule (chunk x ``compact_ratio``) gives identical
  rows on a small plain drain, and ``autotune_drain`` pins that itself
  (a candidate that changed a result would raise);
* the ``save_tuned`` / ``load_tuned`` / ``schedule_for`` round trip on
  ``tmp_path``, the candidates and keys equal to the reference's;
* ``SweepGrid(tune_path=...)`` drains with the table's schedule and the
  rows do not change.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")

from repro.noc import tune as jtune  # noqa: E402
from repro_torch.core.wire import by_name  # noqa: E402
from repro_torch.noc import SweepGrid, run_sweep, sim, traffic, tune  # noqa: E402
from repro_torch.noc.topology import mesh_by_name  # noqa: E402

from test_torch_traffic import one_torch_thread  # noqa: E402,F401

SMALL = {"tiny": tune.DrainSchedule("tiny", chunk=8, compact_ratio=0.5),
         "never": tune.DrainSchedule("never", chunk=16, compact_ratio=0.0),
         "eager": tune.DrainSchedule("eager", chunk=24, compact_ratio=1.0)}


@pytest.fixture(scope="module")
def layers():
    rng = np.random.default_rng(6)
    return [traffic.LayerTraffic(
        torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)),
        torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)))
        for n, k in ((7, 25), (3, 40))]


def test_every_candidate_gives_identical_rows(layers):
    cfg = mesh_by_name("4x4_mc2")
    t = traffic.build_traffic_batch(
        layers, cfg, [(by_name(o), None) for o in ("O0", "O1", "O2")],
        device="cpu")
    rows = {}
    for name, s in SMALL.items():
        res = sim.simulate_batch(cfg, t, chunk=s.chunk,
                                 compact_ratio=s.compact_ratio, device="cpu")
        rows[name] = [(r.total_bt, r.drain_cycle, r.ejected,
                       r.link_bt.tolist()) for r in res]
    assert rows["tiny"] == rows["never"] == rows["eager"]
    rec = tune.autotune_drain(cfg, t, candidates=SMALL, repeats=1,
                              device="cpu")
    assert rec["shape_class"] == "4x4_mc2" and rec["winner"] in SMALL
    assert set(rec["timings"]) == set(SMALL)
    assert (rec["chunk"], rec["compact_ratio"]) == (
        SMALL[rec["winner"]].chunk, SMALL[rec["winner"]].compact_ratio)
    with pytest.raises(ValueError, match="compact_ratio"):
        sim.simulate_batch(cfg, t, compact_ratio=1.5, device="cpu")
    with pytest.raises(ValueError, match="candidate"):
        tune.autotune_drain(cfg, t, candidates={}, device="cpu")


def test_save_load_schedule_round_trip(tmp_path):
    path = str(tmp_path / "sub" / "drain.json")
    assert tune.load_tuned(path) == {}
    rec = {"shape_class": "8x8_mc4", "timings": {"fine": 0.1, "pinned": 0.2},
           "winner": "fine", "chunk": 512, "compact_ratio": 0.5}
    table = tune.save_tuned(rec, path, note="card, 700 W")
    assert tune.load_tuned(path) == table == {"8x8_mc4": {
        "winner": "fine", "chunk": 512, "compact_ratio": 0.5,
        "timings": {"fine": 0.1, "pinned": 0.2}}}
    with open(path) as f:
        assert json.load(f)["_measured_on"] == "card, 700 W"
    tune.save_tuned(dict(rec, shape_class="4x4_mc2", winner="pinned",
                         chunk=2048), path)
    table = tune.load_tuned(path)
    assert sorted(table) == ["4x4_mc2", "8x8_mc4"]
    assert tune.schedule_for(mesh_by_name("8x8_mc4"), table) == \
        tune.DrainSchedule("fine", 512, 0.5)
    assert tune.schedule_for(mesh_by_name("8x8_mc8"), table) is None
    assert tune.shape_class(mesh_by_name("16x16_mc16")) == "16x16_mc16"
    assert {k: (c.chunk, c.compact_ratio)
            for k, c in tune.CANDIDATES.items()} == {
        k: (c.chunk, c.compact_ratio) for k, c in jtune.CANDIDATES.items()}
    assert tune.DEFAULT_PATH.endswith("experiments/tune/drain_h100.json")


def test_sweep_takes_the_tuned_schedule(layers, tmp_path, monkeypatch):
    grid = dict(meshes=("4x4_mc2",), transforms=("O0", "O1"),
                tiebreaks=("pattern",), precisions=("fixed8",),
                models=("toy",), max_packets_per_layer=5, chunk=64,
                result_phase=True, device="cpu")
    path = str(tmp_path / "drain.json")
    tune.save_tuned({"shape_class": "4x4_mc2", "timings": {"never": 0.0},
                     "winner": "never", "chunk": 16, "compact_ratio": 0.0},
                    path)
    seen = []
    drain = sim.simulate_batch

    def spy(*a, **k):
        seen.append((k["chunk"], k["compact_ratio"]))
        return drain(*a, **k)

    from repro_torch.noc import sweep
    monkeypatch.setattr(sweep, "simulate_batch", spy)
    plain = run_sweep(SweepGrid(**grid), lambda _name: layers)
    assert seen == [(64, 0.5), (64, 0.5)]
    seen.clear()
    tuned = run_sweep(SweepGrid(**grid, tune_path=path), lambda _name: layers)
    assert seen == [(16, 0.0), (16, 0.0)]
    assert tuned.rows == plain.rows


def test_main_tunes_the_pinned_drain_on_the_cpu(tmp_path, capsys,
                                                monkeypatch):
    # The card's candidates step up to 8,192 cycles a chunk: too many for
    # the plain step here, so the CLI runs the small ones.
    monkeypatch.setattr(tune, "CANDIDATES", SMALL)
    path = str(tmp_path / "drain.json")
    tune.main(["2x2_mc1", "--device", "cpu", "--max-packets", "2",
               "--out", path, "--note", "cpu run"])
    table = tune.load_tuned(path)
    assert list(table) == ["2x2_mc1"]
    assert table["2x2_mc1"]["winner"] in SMALL
    assert "[ok] 2x2_mc1: winner=" in capsys.readouterr().out
    t = tune.pinned_drain(mesh_by_name("2x2_mc1"), 2, device="cpu")
    assert t.words.shape[0] == 3 and t.num_packets == 10   # 5 layers
