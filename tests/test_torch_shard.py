"""Port parity: sharded drains (``simulate_batch(devices=)``) and the
sweep's device dealing against live ``repro``.

On the CPU the shards are a device list that repeats ``"cpu"``: lanes
never talk to each other, so two shards on one device are still two
shards, each with its own state, wire and ``mc`` rows. The reference's
sharded drain needs forced host devices (tests/test_noc_shard.py), so the
port's shards are held to its single-device drain, which the sharded one
equals bit for bit.

* ``tests/test_noc_shard.py``'s workload (one 14x6 layer, 4x4 with MCs
  (0, 15), lanes 8, O0/O1/O2, chunk 128): two and three shards (three
  lanes padded to a multiple of the shard count), with and without the
  conservation ledger, and a 1-D ``LocalMesh``, every ``SimResult`` field
  equal to the reference's;
* ``retire=False`` (every lane steps until the slowest drains), and the
  drain timeout's message;
* a batch whose lanes drain in different chunks, compacted with three
  shards (so ``min_rows = 3``), the timestamps ledger on;
* a 2-D mesh raises; ``_deal_order`` on ties and uniform estimates;
* ``run_sweep(devices=["cpu", "cpu"])`` rows equal to the reference's on
  the toy grid, ``stats["devices"] == 2``; with placements, affinities and
  the result phase equal to the port's own unsharded rows; ``"auto"`` is
  one device on the CPU, and a bad name raises the reference's message.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")

from repro.core.wire import by_name as jby_name  # noqa: E402
from repro.noc import NocConfig as JNocConfig  # noqa: E402
from repro.noc import SweepGrid as JGrid, run_sweep as jrun_sweep  # noqa: E402
from repro.noc import build_traffic_batch as jbuild  # noqa: E402
from repro.noc import simulate_batch as jsimulate_batch  # noqa: E402
from repro.noc import sweep as jsweep  # noqa: E402
from repro.noc.traffic import LayerTraffic as JLayerTraffic  # noqa: E402
from repro.noc.traffic import pad_traffic_length as jpad  # noqa: E402
from repro_torch.dist import LocalMesh  # noqa: E402
from repro_torch.noc import NocConfig, SweepGrid, run_sweep, sim  # noqa: E402
from repro_torch.noc import sweep  # noqa: E402
from repro_torch.noc.traffic import LayerTraffic  # noqa: E402

from test_torch_traffic import one_torch_thread  # noqa: E402,F401

CHUNK = 128
FIELDS = ("cycles", "ejected", "injected", "total_bt", "inter_router_bt",
          "drain_cycle")
ARRAYS = ("link_bt", "link_flits", "inj_bt")
TOY_GRID = dict(meshes=("4x4_mc2",), transforms=("O0", "O2"),
                precisions=("fixed8",), models=("toy",),
                max_packets_per_layer=None, chunk=CHUNK)


def _torch_traffic(jt) -> sim.Traffic:
    """The reference's batched Traffic as the port's (words as int32)."""
    return sim.Traffic(torch.from_numpy(np.array(jt.words).view(np.int32)),
                       *(torch.from_numpy(np.array(x)) for x in jt[1:6]),
                       num_packets=jt.num_packets)


def _assert_results_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in FIELDS:
            assert getattr(g, f) == getattr(w, f), f
        for f in ARRAYS:
            np.testing.assert_array_equal(getattr(g, f),
                                          np.asarray(getattr(w, f)), f)


@pytest.fixture(scope="module")
def workload():
    """tests/test_noc_shard.py's workload, generated by ``repro`` once."""
    key = jax.random.PRNGKey(0)
    jlayers = [JLayerTraffic(
        jax.random.normal(key, (14, 6)),
        jax.random.normal(jax.random.fold_in(key, 1), (14, 6)) * 0.4)]
    jcfg = JNocConfig(4, 4, (0, 15), lanes=8)
    jbatch = jbuild(jlayers, jcfg,
                    [(jby_name(o), None) for o in ("O0", "O1", "O2")])
    layers = [LayerTraffic(torch.from_numpy(np.array(lt.inputs)),
                           torch.from_numpy(np.array(lt.weights)))
              for lt in jlayers]
    return dict(jlayers=jlayers, jcfg=jcfg, jbatch=jbatch, layers=layers,
                cfg=NocConfig(4, 4, (0, 15), lanes=8),
                batch=_torch_traffic(jbatch), memo={})


def _reference(w, **kw):
    """The reference's single-device drain of the workload, memoized."""
    key = tuple(sorted(kw.items()))
    if key not in w["memo"]:
        w["memo"][key] = jsimulate_batch(w["jcfg"], w["jbatch"], chunk=CHUNK,
                                         **kw)
    return w["memo"][key]


@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("devices", [["cpu", "cpu"], ["cpu"] * 3,
                                     ["cpu"], None])
def test_sharded_drain_equals_reference(workload, devices, checked):
    want = _reference(workload, check_conservation=checked)
    kw = dict(device="cpu") if devices is None else dict(devices=devices)
    got = sim.simulate_batch(workload["cfg"], workload["batch"], chunk=CHUNK,
                             check_conservation=checked, **kw)
    _assert_results_equal(got, want)


def test_local_mesh_and_two_d_mesh(workload):
    want = _reference(workload, check_conservation=False)
    mesh = LocalMesh(["cpu", "cpu"], ("lanes",))
    got = sim.simulate_batch(workload["cfg"], workload["batch"], chunk=CHUNK,
                             devices=mesh)
    _assert_results_equal(got, want)
    bad = LocalMesh([["cpu", "cpu"], ["cpu", "cpu"]], ("a", "b"))
    with pytest.raises(ValueError, match="1-D device mesh"):
        sim.simulate_batch(workload["cfg"], workload["batch"], chunk=CHUNK,
                           devices=bad)
    with pytest.raises(ValueError, match="not both"):
        sim.simulate_batch(workload["cfg"], workload["batch"], chunk=CHUNK,
                           devices=["cpu"], device="cpu")


def test_timeout_message_equals_reference(workload):
    with pytest.raises(RuntimeError) as theirs:
        jsimulate_batch(workload["jcfg"], workload["jbatch"], chunk=8,
                        max_cycles=8)
    with pytest.raises(sim.DrainTimeout) as mine:
        sim.simulate_batch(workload["cfg"], workload["batch"], chunk=8,
                           max_cycles=8, devices=["cpu", "cpu"])
    assert str(mine.value) == str(theirs.value)


def test_retire_false_equals_reference(workload):
    want = _reference(workload, retire=False)
    got = sim.simulate_batch(workload["cfg"], workload["batch"], chunk=CHUNK,
                             devices=["cpu", "cpu"], retire=False)
    _assert_results_equal(got, want)


@pytest.fixture(scope="module")
def ragged(workload):
    """Six lanes that drain in different chunks: the 14-packet layer's
    O0/O1 and four lanes of a 3-packet layer, dealt so that the two long
    lanes sit on different shards."""
    short = [JLayerTraffic(lt.inputs[:3], lt.weights[:3])
             for lt in workload["jlayers"]]
    vs = [(jby_name(o), None) for o in ("O0", "O1", "O2", "O0")]
    long_ = jbuild(workload["jlayers"], workload["jcfg"], vs[:2])
    short_ = jbuild(short, workload["jcfg"], vs)
    t = int(long_.words.shape[-2])
    jt = jsweep._concat_lanes([jpad(long_, t), jpad(short_, t)])
    jt = jsweep._take_lanes(jt, np.array([0, 2, 3, 1, 4, 5]))
    return jt, _torch_traffic(jt)


def test_compaction_with_three_shards(workload, ragged, monkeypatch):
    """Four of six lanes drain early: the two survivors compact to three
    rows (a multiple of the shard count), one on each shard; the ledgers
    are compacted with them (the timestamps equal the port's one-device
    drain's: the reference's ``simulate_batch`` carries none)."""
    jt, t = ragged
    want = jsimulate_batch(workload["jcfg"], jt, chunk=8,
                           check_conservation=True)
    one = sim.simulate_batch(workload["cfg"], t, chunk=8, timestamps=True,
                             device="cpu")
    widths = []
    regroup = sim._regroup

    def spy(shards, rows, devs):
        widths.append(len(list(rows)))
        return regroup(shards, rows, devs)

    monkeypatch.setattr(sim, "_regroup", spy)
    got = sim.simulate_batch(workload["cfg"], t, chunk=8, timestamps=True,
                             check_conservation=True, devices=["cpu"] * 3)
    assert widths == [6, 3]          # placement, then one compaction
    assert len({r.drain_cycle for r in got}) > 1
    _assert_results_equal(got, want)
    for g, o in zip(got, one):
        np.testing.assert_array_equal(g.inj_time, o.inj_time)
        np.testing.assert_array_equal(g.eject_time, o.eject_time)


def test_deal_order_matches_reference():
    for ests, ndev in [([3.0, 1.0, 3.0, 2.0, 1.0, 3.0], 2),
                       ([3.0, 1.0, 3.0, 2.0, 1.0, 3.0], 3),
                       ([5.0, 5.0, 5.0, 5.0], 2), ([4.0, 1.0, 2.0], 1),
                       ([7.0, 7.0, 1.0, 1.0, 2.0], 4)]:
        ests = np.asarray(ests)
        np.testing.assert_array_equal(sweep._deal_order(ests, ndev),
                                      jsweep._deal_order(ests, ndev))
    assert sweep._deal_order(np.full(4, 5.0), 2).tolist() == [0, 1, 2, 3]


def test_sharded_sweep_rows_equal_reference(workload):
    fn = lambda _name: workload["layers"]                       # noqa: E731
    want = jrun_sweep(JGrid(**TOY_GRID), lambda _n: workload["jlayers"],
                      devices=None)
    got = run_sweep(SweepGrid(**TOY_GRID, device="cpu"), fn,
                    devices=["cpu", "cpu"])
    assert got.rows == want.rows
    assert got.stats["devices"] == 2
    auto = run_sweep(SweepGrid(**TOY_GRID, device="cpu"), fn)
    assert auto.rows == want.rows and auto.stats["devices"] == 1


def test_sharded_sweep_result_phase_equals_unsharded(workload):
    """Placements and affinities give the lanes different drain estimates,
    so both drains deal a non-identity order over the shards."""
    grid = SweepGrid(**dict(TOY_GRID, placements=("edge", "interleaved"),
                            affinity=("roundrobin", "nearest"),
                            result_phase=True), device="cpu")
    fn = lambda _name: workload["layers"]                       # noqa: E731
    one = run_sweep(grid, fn, devices=None)
    two = run_sweep(grid, fn, devices=["cpu", "cpu"])
    assert two.rows == one.rows
    assert (one.stats["devices"], two.stats["devices"]) == (1, 2)
    ests = np.asarray([e for e in one.stats["shape_classes"][0]
                       ["drain_estimate"] for _ in range(2)])
    assert not np.array_equal(sweep._deal_order(ests, 2),
                              np.arange(ests.size))


def test_resolve_devices():
    cpu = torch.device("cpu")
    assert sweep._resolve_devices("auto", cpu) is None
    assert sweep._resolve_devices(None, cpu) is None
    assert sweep._resolve_devices(["cpu", "cpu"], cpu) == [cpu, cpu]
    with pytest.raises(ValueError) as mine:
        sweep._resolve_devices("all", cpu)
    with pytest.raises(ValueError) as theirs:
        jsweep._resolve_devices("all")
    assert str(mine.value) == str(theirs.value)
