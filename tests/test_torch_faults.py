"""Port parity: fault injection (``repro_torch.noc.faults`` and its hooks)
against live ``repro`` on the same numpy inputs.

* ``protection_syndrome_masks`` (int32 bit patterns of the reference's
  uint32 masks) and ``crc8_reference``, parity and crc8 at lanes 1-16;
* ``alive_link_mask`` / ``fault_route_table`` on 4x4 and 6x6 with dead
  links and routers, and their error messages;
* ``filter_packets`` by id list and by boolean mask;
* ``_mix32`` on int64 carriers: 0, 2^31, 2^32 - 1 and random words;
* ``protect_wire``'s stamped words;
* the faulty tracked step's leaves, chunk for chunk, against the
  reference's ``_make_step(track=True, timestamps=True, faults=spec)``;
* ``simulate_faulty`` field for field against ``repro.noc.faults`` on
  ``tests/test_noc_faults.py``'s cell (6x6_mc4, 8 lanes, 8 packets a layer)
  under the null model, soft errors with crc8 / parity / none, an
  exhausted retry budget, a dead link, a dead router, and a chunk size that
  moves a retry round; lockstep variants in one batch;
* the gated drain's ``DrainTimeout`` and ``allow_truncation``, the backend
  rule, ``controller=`` accepted and the dump slot for negative ids
  (ROADMAP C12).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
import jax  # noqa: E402

from repro.core import wire as jwire  # noqa: E402
from repro.noc import faults as jfaults  # noqa: E402
from repro.noc import online as jonline  # noqa: E402
from repro.noc import sim as jsim  # noqa: E402
from repro.noc import topology as jtopo  # noqa: E402
from repro.noc import traffic as jtraffic  # noqa: E402
from repro_torch.core import wire  # noqa: E402
from repro_torch.core.wire import by_name  # noqa: E402
from repro_torch.noc import (DrainTimeout, faults, online, sim,  # noqa: E402
                             topology, traffic)

from test_torch_traffic import one_torch_thread  # noqa: E402,F401

CHUNK = 256
MODEL_FIELDS = ("rate", "seed", "protect", "dead_links", "dead_routers",
                "max_retries", "ack_latency", "backoff")
cuda = pytest.mark.skipif(torch.cuda.device_count() < 1,
                          reason="needs a CUDA device")


def _jax_traffic(t):
    """The reference's Traffic of the same streams (words as uint32, C13)."""
    return jsim.Traffic(jax.numpy.asarray(t.words.numpy().view(np.uint32)),
                        *(jax.numpy.asarray(x.numpy()) for x in t[1:6]),
                        num_packets=t.num_packets)


def _ref_model(model):
    return jfaults.FaultModel(**{f: getattr(model, f) for f in MODEL_FIELDS})


@pytest.fixture(scope="module")
def cells():
    """tests/test_noc_faults.py's cell from seeded numpy layers: 6x6 with
    4 MCs and 8 lanes, 8 packets a layer, O0 / O1 / O2."""
    rng = np.random.default_rng(3)

    def arr(n, k, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal((n, k)) * scale).astype(np.float32))

    layers = [traffic.LayerTraffic(arr(24, 12), arr(24, 12, 0.4)),
              traffic.LayerTraffic(arr(10, 8), arr(10, 8))]
    cfg = topology.make_noc(6, 6, num_mcs=4, lanes=8)
    batch = traffic.build_traffic_batch(
        layers, cfg, [(by_name(o), None) for o in ("O0", "O1", "O2")],
        max_packets_per_layer=8, device="cpu")
    return cfg, topology_ref(cfg), batch


def topology_ref(cfg):
    return jtopo.make_noc(cfg.rows, cfg.cols, num_mcs=cfg.num_mcs,
                          lanes=cfg.lanes)


_REF_DRAINS = {}


def _ref_drain(jcfg, batch, variant, model, chunk=CHUNK):
    """The reference's drain of one variant, memoized across the module's
    tests (each costs the reference's retry loop and its compiles)."""
    key = (variant, model, chunk)
    if key not in _REF_DRAINS:
        _REF_DRAINS[key] = jfaults.simulate_faulty(
            jcfg, _jax_traffic(batch.variant(variant)), _ref_model(model),
            chunk=chunk)
    return _REF_DRAINS[key]


def assert_drains_equal(got, want):
    """Every field of two FaultDrains (sim totals and recorders, ledgers,
    statuses, rounds) equal."""
    for name in ("cycles", "ejected", "injected", "total_bt",
                 "inter_router_bt", "drain_cycle"):
        assert getattr(got.sim, name) == getattr(want.sim, name), name
    for name in ("link_bt", "link_flits", "inj_bt"):
        np.testing.assert_array_equal(getattr(got.sim, name),
                                      np.asarray(getattr(want.sim, name)))
    for name in ("inj_time", "eject_time", "eject_counts", "status",
                 "corrupted", "retries"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.rounds == want.rounds
    assert got.ledger == want.ledger
    assert got.drained == want.drained


@pytest.mark.parametrize("protect", ["none", "parity", "crc8"])
def test_protection_masks_and_crc8(protect):
    assert wire.PROTECTION_BITS == jwire.PROTECTION_BITS
    for lanes in range(1, 17):
        got = wire.protection_syndrome_masks(protect, lanes)
        want = jwire.protection_syndrome_masks(protect, lanes)
        assert got.dtype == np.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint32), want)
        assert got is wire.protection_syndrome_masks(protect, lanes)
    assert (wire.protection_overhead_bits(protect, 1234)
            == jwire.protection_overhead_bits(protect, 1234))
    if protect == "parity":
        assert (wire.protection_syndrome_masks("parity", 3) == -1).all()
    rng = np.random.default_rng(1)
    for n in (0, 1, 4, 33, 64):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert wire.crc8_reference(data) == jwire.crc8_reference(data)
    with pytest.raises(KeyError, match="hamming"):
        wire.protection_syndrome_masks("hamming", 4)


ROUTE_CASES = [
    ("4x4", (), ()), ("4x4", ((5, 1),), ()), ("4x4", (), (5,)),
    ("4x4", ((1, 2), (6, 1)), (10,)), ("6x6", ((7, 0),), ()),
    ("6x6", ((7, 1), (14, 2), (20, 3)), ()), ("6x6", (), (7,)),
    ("6x6", ((8, 2),), (14, 21)), ("6x6", (), (0, 35)),
]


@pytest.mark.parametrize("mesh,dead_links,dead_routers", ROUTE_CASES)
def test_fault_route_table(mesh, dead_links, dead_routers):
    n = int(mesh[0])
    cfg = topology.make_noc(n, n, 2)
    jcfg = jtopo.make_noc(n, n, 2)
    np.testing.assert_array_equal(
        topology.alive_link_mask(cfg, dead_links, dead_routers),
        jtopo.alive_link_mask(jcfg, dead_links, dead_routers))
    table, reach = topology.fault_route_table(cfg, dead_links, dead_routers)
    jtable, jreach = jtopo.fault_route_table(jcfg, dead_links, dead_routers)
    assert table.dtype == np.int32
    np.testing.assert_array_equal(table, jtable)
    np.testing.assert_array_equal(reach, jreach)
    if not dead_links and not dead_routers:
        np.testing.assert_array_equal(table, topology.xy_route(cfg).numpy())


@pytest.mark.parametrize("args", [
    (((16, 0),), ()), (((0, 4),), ()), (((0, 0),), ()), (((3, 1),), ()),
    ((), (16,)), ((), (-1,))])
def test_fault_route_errors(args):
    cfg, jcfg = topology.make_noc(4, 4, 2), jtopo.make_noc(4, 4, 2)
    with pytest.raises(ValueError) as mine:
        topology.fault_route_table(cfg, *args)
    with pytest.raises(ValueError) as theirs:
        jtopo.fault_route_table(jcfg, *args)
    assert str(mine.value) == str(theirs.value)


def test_filter_packets(cells):
    _, _, batch = cells
    one = batch.variant(1)
    jt = _jax_traffic(one)
    rng = np.random.default_rng(5)
    mask = rng.random(one.num_packets) < 0.4
    for keep in (np.flatnonzero(mask), mask, [], np.arange(one.num_packets)):
        got = traffic.filter_packets(one, keep)
        want = jtraffic.filter_packets(jt, keep)
        assert got.num_packets == want.num_packets == one.num_packets
        for i, name in enumerate(("words", "dest", "meta", "vc", "pkt",
                                  "length")):
            x = got[i].numpy()
            y = np.asarray(want[i])
            np.testing.assert_array_equal(
                x.view(np.uint32) if name == "words" else x, y, name)
            assert got[i].dtype == torch.int32
    with pytest.raises(ValueError, match="unbatched"):
        traffic.filter_packets(batch, [0])
    with pytest.raises(ValueError, match="boolean keep mask"):
        traffic.filter_packets(one, np.ones(3, bool))


def test_mix32_on_int64_carriers():
    rng = np.random.default_rng(7)
    words = np.concatenate([[0, 1, 2**31, 2**31 - 1, 2**32 - 1],
                            rng.integers(0, 2**32, 4096, dtype=np.uint64)])
    got = sim._mix32(torch.from_numpy(words.astype(np.int64)))
    want = np.asarray(jsim._mix32(jax.numpy.asarray(words.astype(np.uint32))))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # an independent numpy oracle of the finalizer, in uint64 masked to 32
    x = words.astype(np.uint64)
    for shift, mul in ((16, 0x7FEB352D), (15, 0x846CA68B)):
        x = ((x ^ (x >> np.uint64(shift))) * np.uint64(mul)) & np.uint64(
            0xFFFFFFFF)
    x = x ^ (x >> np.uint64(16))
    np.testing.assert_array_equal(got.numpy(), x.astype(np.int64))
    # the cycle multiply wraps; the int32 view of the 1 << 31 word is -2^31
    cyc = torch.from_numpy(words.astype(np.int64))
    np.testing.assert_array_equal(
        sim._mul32(cyc, 0x9E3779B9).numpy(),
        ((words.astype(np.uint64) * np.uint64(0x9E3779B9))
         & np.uint64(0xFFFFFFFF)).astype(np.int64))
    assert int(sim._as_int32(torch.tensor([1 << 31]))[0]) == -2**31


@pytest.mark.parametrize("protect", ["parity", "crc8"])
def test_protect_wire_words(cells, protect):
    cfg, _, batch = cells
    one = batch.variant(2)
    got = faults.protect_wire(sim.fuse_traffic(one, True), protect,
                              cfg.lanes)
    want = jfaults.protect_wire(jsim.fuse_traffic(_jax_traffic(one), True),
                                protect, cfg.lanes)
    np.testing.assert_array_equal(got.wire[0].numpy().view(np.uint32),
                                  np.asarray(want.wire))
    assert faults.protect_wire(sim.fuse_traffic(one), "none", 8).wire.shape \
        == (1,) + tuple(one.words.shape[:2]) + (cfg.lanes + 1,)


STEP_CASES = [
    dict(rate=5e-2, seed=11, protect="none"),
    dict(rate=5e-2, seed=11, protect="parity"),
    dict(rate=5e-2, seed=3, protect="crc8"),
    dict(rate=5e-2, seed=11, protect="crc8", dead_links=((7, 1),)),
    dict(rate=0.0, protect="crc8", dead_routers=(14,)),
]


@pytest.mark.parametrize("case", STEP_CASES)
def test_faulty_step_leaves_chunk_for_chunk(cells, case):
    cfg, jcfg, batch = cells
    one = batch.variant(1)
    model = faults.FaultModel(**case)
    spec = model.static()
    m = int(one.length.shape[0])
    w = sim.fuse_traffic(one, True)
    jt = _jax_traffic(one)
    jw = jsim.fuse_traffic(jt, True)
    if model.protect != "none":
        w = faults.protect_wire(w, model.protect, cfg.lanes)
        jw = jfaults.protect_wire(jw, model.protect, cfg.lanes)
    st = sim.make_state(cfg, m, device="cpu", track=True)
    lg = sim.make_ledger(one.num_packets, timestamps=True, device="cpu",
                         fault_ledgers=True)
    jst = jsim.make_state(jcfg, m, npkt=one.num_packets, timestamps=True,
                          fault_ledgers=True)
    step = jax.jit(jsim._make_step(jsim._mesh_key(jcfg), True, track=True,
                                   timestamps=True, faults=spec))
    mc = torch.as_tensor(np.asarray(cfg.mc_nodes, np.int32)[None])
    jmc = jsim._mc_array(jcfg, jt, m, batched=False)
    key = sim._mesh_key(cfg)
    flips = 0
    for _ in range(4):
        for _ in range(8):
            st, lg = sim.tracked_step(st, lg, w, mc, key, True, spec)
            jst = step(jst, jw, jmc)
        for name in sim.SimState._fields:
            got = getattr(st, name)[0].numpy()
            want = np.asarray(getattr(jst, name))
            np.testing.assert_array_equal(
                got.view(np.uint32) if want.dtype == np.uint32 else got,
                want, err_msg=name)
        for name in sim.Ledger._fields:
            np.testing.assert_array_equal(getattr(lg, name)[0].numpy(),
                                          np.asarray(getattr(jst, name)),
                                          err_msg=name)
        flips = int(lg.flip_pkt.sum())
    assert (flips > 0) == (model.rate > 0)


def test_simulate_faulty_null_model(cells):
    cfg, jcfg, batch = cells
    one = batch.variant(1)
    fd = faults.simulate_faulty(cfg, one, faults.FaultModel(), chunk=CHUNK,
                                device="cpu")
    assert_drains_equal(fd, _ref_drain(jcfg, batch, 1, faults.FaultModel()))
    clean = sim.simulate(cfg, one, chunk=CHUNK, device="cpu")
    assert (fd.sim.total_bt, fd.sim.drain_cycle) == (clean.total_bt,
                                                     clean.drain_cycle)
    np.testing.assert_array_equal(fd.sim.link_bt, clean.link_bt)
    np.testing.assert_array_equal(fd.sim.inj_bt, clean.inj_bt)
    assert fd.ledger["delivered"] == one.num_packets
    assert np.all(fd.status == faults.STATUS_DELIVERED)


DRAIN_CASES = {
    "crc8_seed11": dict(rate=5e-2, seed=11, protect="crc8"),
    "crc8_seed7": dict(rate=5e-2, seed=7, protect="crc8"),
    "none_seed7": dict(rate=5e-2, seed=7),
    "parity_no_retries": dict(rate=2e-1, seed=7, protect="parity",
                              max_retries=0),
    "dead_link": dict(dead_links=((7, 1),)),
    "dead_router": dict(dead_routers=(7,)),
}


@pytest.mark.parametrize("name", sorted(DRAIN_CASES))
def test_simulate_faulty_matches_reference(cells, name):
    cfg, jcfg, batch = cells
    one = batch.variant(1)
    model = faults.FaultModel(**DRAIN_CASES[name])
    fd = faults.simulate_faulty(cfg, one, model, chunk=CHUNK, device="cpu")
    assert_drains_equal(fd, _ref_drain(jcfg, batch, 1, model))
    led = fd.ledger
    assert led["conservation_ok"]
    if name == "crc8_seed11":         # a replay is the same drain
        again = faults.simulate_faulty(cfg, one, model, chunk=CHUNK,
                                       device="cpu")
        assert_drains_equal(again, fd)
        assert led["transmission_rounds"] > 1
        assert led["protection_overhead_bits"] == 8 * led["transmitted_flits"]
    if name == "none_seed7":
        assert led["flip_events"] > 0 and led["silent_corrupt"] > 0
        assert led["detected_bad_flits"] == 0
    if name == "parity_no_retries":
        assert led["retry_exhausted"] > 0 and led["transmission_rounds"] == 1
    if name == "dead_router":
        assert led["dropped"] > 0
        assert np.all(fd.status[fd.status != faults.STATUS_DELIVERED]
                      == faults.STATUS_DROPPED)


def test_chunk_moves_a_retry_round(cells):
    """A retry round starts at the chunk boundary where the last one
    stopped: the same faults drain later under a longer chunk, and each
    chunk size matches the reference's."""
    cfg, jcfg, batch = cells
    one = batch.variant(1)
    model = faults.FaultModel(**DRAIN_CASES["crc8_seed11"])
    a = faults.simulate_faulty(cfg, one, model, chunk=64, device="cpu")
    assert_drains_equal(a, _ref_drain(jcfg, batch, 1, model, 64))
    b = _ref_drain(jcfg, batch, 1, model)       # chunk 256
    assert a.ledger["transmission_rounds"] > 1
    assert a.sim.drain_cycle != b.sim.drain_cycle
    assert a.rounds[1]["drain_cycle"] != b.rounds[1]["drain_cycle"]


def test_lockstep_batch_equals_single_drains(cells):
    """O0/O1/O2 of one traffic drained as one batch: each lane is the
    reference's drain of that variant (the schedule reads no payload)."""
    cfg, jcfg, batch = cells
    model = faults.FaultModel(**DRAIN_CASES["crc8_seed7"])
    lanes = faults.simulate_faulty_batch(cfg, batch, model, chunk=CHUNK,
                                         device="cpu")
    assert len(lanes) == 3
    for i, fd in enumerate(lanes):
        assert_drains_equal(fd, _ref_drain(jcfg, batch, i, model))
    assert len({fd.sim.total_bt for fd in lanes}) == 3
    odd = batch._replace(length=torch.stack([batch.length[0],
                                             batch.length[1] - 1,
                                             batch.length[2]]))
    with pytest.raises(ValueError, match="length differs"):
        faults.simulate_faulty_batch(cfg, odd, model, device="cpu")


def test_gated_drain_timeout_and_truncation(cells):
    cfg, jcfg, batch = cells
    one = batch.variant(1)
    jt = _jax_traffic(one)
    m = int(one.length.shape[0])
    mc = np.asarray(cfg.mc_nodes, np.int32)
    length = one.length.numpy().astype(np.int64)
    # two gates a stream: half the flits at once, the rest at cycle 40
    inc = np.stack([length // 2, length - length // 2], axis=1)
    rel = np.tile(np.array([[0, 40]]), (m, 1))
    spec = faults.FaultModel(rate=5e-2, seed=3, protect="parity").static()
    kw = dict(count_headers=True, chunk=16, max_cycles=32, faults=spec)
    with pytest.raises(DrainTimeout) as mine:
        online._drain_gated(cfg, one, mc, rel, inc, allow_truncation=False,
                            **kw)
    with pytest.raises(jsim.DrainTimeout) as theirs:
        jonline._drain_gated(jcfg, jt, mc, rel, inc, allow_truncation=False,
                             **kw)
    assert str(mine.value) == str(theirs.value)
    assert mine.value.undelivered == theirs.value.undelivered
    assert (mine.value.cycle, mine.value.ejected, mine.value.total) == (
        theirs.value.cycle, theirs.value.ejected, theirs.value.total)
    got = online._drain_gated(cfg, one, mc, rel, inc, allow_truncation=True,
                              **kw)
    want = jonline._drain_gated(jcfg, jt, mc, rel, inc,
                                allow_truncation=True, **kw)
    assert got[4] is want[4] is False
    assert dataclasses.asdict(got[0]).keys() >= {"total_bt", "drain_cycle"}
    assert (got[0].total_bt, got[0].drain_cycle, got[0].cycles) == (
        want[0].total_bt, want[0].drain_cycle, want[0].cycles)
    for a, b in zip(got[1:4], want[1:4]):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(got[5][1].flip_pkt[0].numpy(),
                                  np.asarray(want[5].flip_pkt))


def test_backend_controller_and_ledger_rules(cells):
    cfg, _, batch = cells
    one = batch.variant(0)
    model = faults.FaultModel(rate=1e-2, protect="crc8")
    with pytest.raises(ValueError, match="fault"):
        faults.simulate_faulty(cfg, one, model, backend="cuda", device="cpu")
    # controller= is accepted: an admission controller whose only
    # arrival is admitted at cycle 0 gives the drain without one.
    npkt = one.num_packets
    inc = one.length.numpy().astype(np.int64)[:, None]
    ctrl = online._AdmissionController(np.zeros(1, np.int64), 1, inc, 64,
                                       npkt)
    gated = faults.drain_with_retries(cfg, one, model, mc_nodes=cfg.mc_nodes,
                                      release=ctrl.release, inc=inc,
                                      controller=ctrl, chunk=64,
                                      device="cpu")
    plain = faults.drain_with_retries(cfg, one, model, mc_nodes=cfg.mc_nodes,
                                      chunk=64, device="cpu")
    assert ctrl.done and not ctrl.restart_needed and ctrl.admitted.all()
    assert_drains_equal(gated, plain)
    with pytest.raises(ValueError, match="unbatched"):
        faults.drain_with_retries(cfg, batch, model, mc_nodes=cfg.mc_nodes,
                                  device="cpu")
    with pytest.raises(ValueError, match="timestamps=True"):
        sim.make_ledger(4, fault_ledgers=True, device="cpu")
    st = sim.make_state(cfg, 4, device="cpu", track=True)
    lg = sim.make_ledger(one.num_packets, timestamps=True, device="cpu")
    with pytest.raises(ValueError, match="fault ledgers"):
        sim.tracked_step(st, lg, sim.fuse_traffic(one, True),
                         torch.zeros((1, 4), dtype=torch.int32),
                         sim._mesh_key(cfg), True, model.static())
    # the plain step under auto, and the reference's model checks
    assert sim._resolve_backend("auto", torch.device("cpu"),
                                faults=True) == "plain"
    for bad in (dict(rate=1.5), dict(protect="hamming"),
                dict(max_retries=-1), dict(ack_latency=-1),
                dict(backoff=0)):
        with pytest.raises(ValueError) as mine:
            faults.FaultModel(**bad)
        with pytest.raises(ValueError) as theirs:
            jfaults.FaultModel(**bad)
        assert str(mine.value) == str(theirs.value)
    m = faults.FaultModel(rate=1e-3, seed=2, dead_links=[(1, 2)])
    assert m.static() == tuple(_ref_model(m).static())
    assert not m.is_null and m.has_hard_faults and faults.FaultModel().is_null


def test_negative_ids_go_to_the_dump_slot(cells):
    """ROADMAP C12 in the fault ledgers: the reference sends id -1 to the
    dump slot and id -2 to the last real packet (JAX's negative-index
    rule); the port sends every id outside [0, npcap] to the dump slot."""
    cfg, jcfg, batch = cells
    one = batch.variant(1)
    one = one._replace(pkt=torch.full_like(one.pkt, -2))
    npkt = one.num_packets
    spec = faults.FaultModel(rate=2e-1, seed=3, protect="crc8").static()
    w = faults.protect_wire(sim.fuse_traffic(one, True), "crc8", cfg.lanes)
    st = sim.make_state(cfg, 4, device="cpu", track=True)
    lg = sim.make_ledger(npkt, timestamps=True, device="cpu",
                         fault_ledgers=True)
    mc = torch.as_tensor(np.asarray(cfg.mc_nodes, np.int32)[None])
    for _ in range(24):
        st, lg = sim.tracked_step(st, lg, w, mc, sim._mesh_key(cfg), True,
                                  spec)
    for led in (lg.flip_pkt, lg.bad_pkt):
        assert int(led[0, :npkt].sum()) == 0 and int(led[0, npkt]) > 0
    jt = _jax_traffic(one)
    jw = jfaults.protect_wire(jsim.fuse_traffic(jt, True), "crc8", cfg.lanes)
    jst = jsim.make_state(jcfg, 4, npkt=npkt, timestamps=True,
                          fault_ledgers=True)
    step = jax.jit(jsim._make_step(jsim._mesh_key(jcfg), True, track=True,
                                   timestamps=True, faults=spec))
    jmc = jsim._mc_array(jcfg, jt, 4, batched=False)
    for _ in range(24):
        jst = step(jst, jw, jmc)
    jflip = np.asarray(jst.flip_pkt)
    # the same flip events, counted on the reference's last real id
    assert int(jflip[npkt - 1]) == int(lg.flip_pkt[0, npkt])
    assert int(jflip.sum()) == int(lg.flip_pkt.sum())


@pytest.mark.cuda
@cuda
def test_card_drain_equals_cpu_drain(cells):
    cfg, _, batch = cells
    model = faults.FaultModel(rate=5e-2, seed=11, protect="crc8")
    on_card = faults.simulate_faulty_batch(cfg, batch, model, chunk=CHUNK)
    on_cpu = faults.simulate_faulty_batch(cfg, batch, model, chunk=CHUNK,
                                          device="cpu")
    for a, b in zip(on_card, on_cpu):
        assert_drains_equal(a, b)
