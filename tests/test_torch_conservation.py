"""Port parity: the packet ledger of ``repro_torch.noc.sim`` (the
conservation check and the timestamps) against ``repro.noc.sim``.

* the positive arm: a clean drain passes, one tail ejection per packet
  id, and the BT totals and drain cycles equal the drain without it;
* the negative arm: a Traffic with a duplicated packet id raises the
  reference's message, and the port's ``_conservation_error`` gives the
  reference's string on doctored ledgers in each of its three branches;
* ``inj_time`` / ``eject_time`` equal to the reference's
  ``_make_step(track=True, timestamps=True)`` on the same Traffic;
* ``run_sweep(check_conservation=True)`` rows (request and result phase)
  equal to the unchecked rows;
* the backend rule: the ledger runs the plain step; ``backend="cuda"``
  with it raises.

The traffic is the port's own, from seeded numpy layers (no model).
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")

from repro.noc import sim as jsim  # noqa: E402
from repro.noc.topology import mesh_by_name as jmesh  # noqa: E402
from repro_torch.core.wire import by_name  # noqa: E402
from repro_torch.noc import SweepGrid, run_sweep, sim, traffic  # noqa: E402
from repro_torch.noc.topology import mesh_by_name  # noqa: E402

from test_torch_traffic import one_torch_thread  # noqa: E402,F401

SWEEP = dict(meshes=("4x4_mc2",), transforms=("O0", "O1"),
             tiebreaks=("pattern",), precisions=("fixed8",),
             compression=("none", "msr"), models=("toy",),
             max_packets_per_layer=6, chunk=64, result_phase=True)


def _jax_traffic(t):
    """The reference's Traffic of the same streams (words as uint32)."""
    return jsim.Traffic(jax.numpy.asarray(t.words.numpy().view(np.uint32)),
                        *(jax.numpy.asarray(x.numpy()) for x in t[1:6]),
                        num_packets=t.num_packets)


@pytest.fixture(scope="module")
def layers():
    rng = np.random.default_rng(4)
    return [traffic.LayerTraffic(
        torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)),
        torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)))
        for n, k in ((9, 25), (5, 60), (4, 7))]


@pytest.fixture(scope="module")
def batch(layers):
    cfg = mesh_by_name("4x4_mc2")
    variants = [(by_name(o), None) for o in ("O0", "O1", "O2")]
    return cfg, traffic.build_traffic_batch(layers, cfg, variants,
                                            device="cpu")


def test_positive_arm_one_ejection_per_packet(batch):
    cfg, t = batch
    plain = sim.simulate_batch(cfg, t, chunk=32, device="cpu")
    checked = sim.simulate_batch(cfg, t, chunk=32, check_conservation=True,
                                 device="cpu")
    for p, c in zip(plain, checked):
        assert (p.total_bt, p.drain_cycle, p.ejected) == (
            c.total_bt, c.drain_cycle, c.ejected)
        np.testing.assert_array_equal(p.link_bt, c.link_bt)
    # the ledger itself: every id's tail ejected once, the dump slot aside
    one = t.variant(1)
    w = sim.fuse_traffic(one, track_pkt=True)
    state = sim.make_state(cfg, int(one.length.shape[0]), device="cpu",
                           track=True)
    ledger = sim.make_ledger(one.num_packets, device="cpu")
    mc = torch.as_tensor(np.asarray(cfg.mc_nodes, np.int32)[None])
    key = (cfg.rows, cfg.cols, cfg.num_vcs, cfg.vc_depth, cfg.lanes)
    for _ in range(checked[1].drain_cycle):
        state, ledger = sim.tracked_step(state, ledger, w, mc, key, True)
    assert ledger.inj_time is None and ledger.eject_time is None
    np.testing.assert_array_equal(ledger.eject_pkt[0, :-1].numpy(),
                                  np.ones(one.num_packets, np.int32))
    assert int(state.ejected[0]) == int(one.length.sum())


def test_negative_arm_and_error_strings(batch):
    cfg, t = batch
    one = t.variant(0)
    bad = one._replace(pkt=torch.where(one.pkt == 3, 2, one.pkt))
    jbad = _jax_traffic(bad)
    with pytest.raises(RuntimeError) as mine:
        sim.simulate(cfg, bad, chunk=32, check_conservation=True,
                     device="cpu")
    with pytest.raises(RuntimeError) as theirs:
        jsim.simulate(jmesh("4x4_mc2"), jbad, chunk=32,
                      check_conservation=True)
    assert str(mine.value) == str(theirs.value)
    assert "packet conservation violated" in str(mine.value)
    with pytest.raises(RuntimeError, match=r"\(variant 1\)"):
        sim.simulate_batch(cfg, t._replace(pkt=torch.stack(
            [t.pkt[0], bad.pkt, t.pkt[2]])), chunk=32,
            check_conservation=True, device="cpu")
    # each branch of the check on doctored ledgers
    length = one.length.numpy()
    meta, pkt = one.meta.numpy(), one.pkt.numpy()
    n = one.num_packets
    clean = np.concatenate([np.ones(n, np.int32), [0]])
    twice = pkt.copy()
    twice[twice == 5] = 4
    missed = clean.copy()
    missed[[2, 7]] = [0, 2]
    stray = clean.copy()
    stray[5] = 0
    cases = [(pkt, clean), (twice, clean), (pkt, missed), (twice, stray)]
    seen = set()
    for p, ledger in cases:
        got = sim._conservation_error(length, meta, p, ledger, n)
        want = jsim._conservation_error(length, meta, p, ledger, n)
        assert got == want
        seen.add(None if got is None else got.split(":")[0])
    assert sim._conservation_error(length, meta, pkt, clean, n) is None
    # a never-injected id that ejects (an id past the stream's)
    ghost = np.concatenate([np.ones(n, np.int32), [1, 0]])
    got = sim._conservation_error(length, meta, pkt, ghost, n + 1)
    assert got == jsim._conservation_error(length, meta, pkt, ghost, n + 1)
    seen.add(got.split(":")[0])
    assert seen == {None, "packet ids injected more than once",
                    "packet ids not ejected exactly once",
                    "ejections for never-injected packet ids"}


def test_timestamps_match_reference_step(batch):
    cfg, t = batch
    one = t.variant(2)
    res = sim.simulate(cfg, one, chunk=16, timestamps=True, device="cpu")
    assert res.inj_time.shape == res.eject_time.shape == (one.num_packets,)
    jcfg = jmesh("4x4_mc2")
    jt = _jax_traffic(one)
    m = int(one.length.shape[0])
    st = jsim.make_state(jcfg, m, npkt=one.num_packets, timestamps=True)
    wire = jsim.fuse_traffic(jt, True)
    step = jax.jit(jsim._make_step(jsim._mesh_key(jcfg), True, track=True,
                                   timestamps=True))
    mc = jsim._mc_array(jcfg, jt, m, batched=False)
    for _ in range(res.drain_cycle):
        st = step(st, wire, mc)
    np.testing.assert_array_equal(res.inj_time,
                                  np.asarray(st.inj_time)[:-1])
    np.testing.assert_array_equal(res.eject_time,
                                  np.asarray(st.eject_time)[:-1])
    assert int(st.ejected) == res.ejected
    assert res.eject_time.max() == res.drain_cycle - 1
    assert np.all(res.inj_time < res.eject_time)
    # the batched drain, compacting as lanes retire, keeps each lane's
    batched = sim.simulate_batch(cfg, t, chunk=16, timestamps=True,
                                 device="cpu")
    np.testing.assert_array_equal(batched[2].inj_time, res.inj_time)
    np.testing.assert_array_equal(batched[2].eject_time, res.eject_time)
    assert sim.simulate(cfg, one, chunk=16, device="cpu").inj_time is None


def test_checked_sweep_rows_equal_unchecked(layers):
    grid = SweepGrid(**SWEEP, device="cpu")
    plain = run_sweep(grid, lambda _name: layers)
    checked = run_sweep(grid, lambda _name: layers, check_conservation=True)
    assert checked.rows == plain.rows and len(plain.rows) == 4
    assert checked.stats["conservation_checked"]
    assert not plain.stats["conservation_checked"]
    assert checked.stats["step"] == plain.stats["step"] == "plain"
    with pytest.raises(ValueError, match="ledger"):
        run_sweep(SweepGrid(**SWEEP, device="cpu", backend="cuda"),
                  lambda _name: layers, check_conservation=True)
    with pytest.raises(ValueError, match="ledger"):
        sim.simulate(mesh_by_name("4x4_mc2"), layers_traffic(layers),
                     timestamps=True, backend="cuda", device="cpu")


def layers_traffic(layers):
    return traffic.build_traffic(layers, mesh_by_name("4x4_mc2"),
                                 by_name("O0"), device="cpu")
