"""Port parity: closed-loop serving (``repro_torch.noc.online`` and
``sweep.run_serving``) against live ``repro`` on the same numpy inputs.

* ``ArrivalProcess.times`` (uniform, poisson on PCG64, backtoback) and its
  errors;
* ``percentile`` / ``latency_percentiles`` against the reference and
  ``np.percentile``: ties, single samples, endpoints, truncation;
* ``concat_inferences`` leaf for leaf, and its errors;
* ``simulate_online`` field for field (every ``OnlineResult`` field and
  property) on the trained LeNet's traffic at 4x4_mc2, 2 packets a layer:
  zero latency (one inference == the offline ``simulate``), a compute
  latency that moves timing and not BT, back-to-back saturation, poisson
  arrivals with per-PE latencies, admission control that restarts at
  least twice, a chunk that moves a shed decision (ROADMAP C15), crc8
  faults that fail inferences under a deadline, faults with admission,
  and a truncated run; the validation errors;
* ``drain_with_retries(controller=)`` through a restart;
* ``run_serving`` points, combos and rows on the smoke grid's axes
  (4x4_mc2, 2 loads x 2 rates, 4 inferences), ``run_sweep(out_path=)``'s
  JSON, and ``SweepGrid``'s serving and fault validation; the pool the
  card's drains run in (its tasks through the pool's pickler, in this
  process) gives the reference's drains;
* one card-gated case: ``simulate_online`` on the card == on the CPU.

The reference's drains are memoized across the module; every reference
run uses one mesh, and all but one chunk size.
"""
import dataclasses
import json
import os
from multiprocessing.reduction import ForkingPickler

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.wire import by_name as jby_name  # noqa: E402
from repro.noc import SweepGrid as JGrid  # noqa: E402
from repro.noc import faults as jfaults  # noqa: E402
from repro.noc import online as jonline  # noqa: E402
from repro.noc import run_serving as jrun_serving  # noqa: E402
from repro.noc import run_sweep as jrun_sweep  # noqa: E402
from repro.noc import sim as jsim  # noqa: E402
from repro.noc import traffic as jtraffic  # noqa: E402
from repro.noc.topology import mesh_by_name as jmesh  # noqa: E402
from repro.quant import quantize_fixed8 as jquant  # noqa: E402
from repro_torch import noc  # noqa: E402
from repro_torch.core.wire import by_name  # noqa: E402
from repro_torch.data import glyph_batch  # noqa: E402
from repro_torch.models import trained_model  # noqa: E402
from repro_torch.noc import (faults, online, sim, sweep,  # noqa: E402
                             traffic)
from repro_torch.noc.topology import mesh_by_name  # noqa: E402
from repro_torch.quant import quantize_fixed8  # noqa: E402

from test_torch_traffic import one_torch_thread  # noqa: E402,F401

CHUNK = 64
MAXP = 2
cuda = pytest.mark.skipif(torch.cuda.device_count() < 1,
                          reason="needs a CUDA device")


def _jax_traffic(t):
    """The reference's Traffic of the same streams (words as uint32, C13)."""
    return jsim.Traffic(jnp.asarray(t.words.numpy().view(np.uint32)),
                        *(jnp.asarray(x.numpy()) for x in t[1:6]),
                        num_packets=t.num_packets)


@pytest.fixture(scope="module")
def work():
    """The trained LeNet's layer traffic on one glyph image (seed 11), and
    one inference's O0 fixed8 request and result traffic at 4x4_mc2, 2
    packets a layer. Both are made once, by the port, and handed to both
    sides as the same numpy arrays (the packetizers are held to each other
    in test_torch_traffic.py and test_torch_result.py): the reference gets
    the port's Traffic, so the result values agree (ROADMAP C11)."""
    net, _, _ = trained_model("lenet", device="cpu")
    img, _ = glyph_batch(torch.Generator().manual_seed(11), 1, device="cpu")
    layers = [traffic.LayerTraffic(lt.inputs.detach().clone(),
                                   lt.weights.detach().clone())
              for lt in net.layer_traffic(img[0])]
    jlayers = [jtraffic.LayerTraffic(jnp.asarray(lt.inputs.numpy()),
                                     jnp.asarray(lt.weights.numpy()))
               for lt in layers]
    cfg = mesh_by_name("4x4_mc2")
    variants = [(by_name("O0"), lambda t: quantize_fixed8(t).values)]
    req = traffic.build_traffic_batch(layers, cfg, variants,
                                      max_packets_per_layer=MAXP,
                                      device="cpu").variant(0)
    res = traffic.build_result_traffic(layers, cfg, variants,
                                       max_packets_per_layer=MAXP,
                                       device="cpu").variant(0)
    return dict(jlayers=jlayers, layers=layers, jcfg=jmesh("4x4_mc2"),
                cfg=cfg, jreq=_jax_traffic(req), jres=_jax_traffic(res),
                req=req, res=res)


def _fault_model(pkg, **kw):
    return (jfaults if pkg == "ref" else faults).FaultModel(**kw)


def _arrivals(pkg, spec):
    if isinstance(spec, tuple):
        return (jonline if pkg == "ref" else online).ArrivalProcess(*spec)
    return spec


# Each case: simulate_online's arguments; ``arrivals`` as an explicit list
# or an ArrivalProcess's (kind, load, seed), ``faults`` as FaultModel
# keywords. Inference k of the admission cases arrives at 64 k: a new
# arrival every 64-cycle chunk while one inference (about 110 cycles of
# request drain) is in flight.
CASES = {
    "zero_latency": dict(arrivals=[0], compute_latency=0,
                         check_conservation=True),
    "latency": dict(arrivals=[0], compute_latency=40,
                    check_conservation=True),
    "backtoback": dict(arrivals=("backtoback",), num_inferences=4,
                       compute_latency=32, check_conservation=True,
                       record_bt=False),
    "poisson": dict(arrivals=("poisson", 8.0, 3), num_inferences=4,
                    compute_latency=list(range(14)), check_conservation=True,
                    record_bt=False),
    "admission": dict(arrivals=[0, 64, 128, 192], compute_latency=32,
                      admit_queue_depth=1, deadline=400,
                      check_conservation=True, record_bt=False),
    "admission_chunk256": dict(arrivals=[0, 64, 128, 192],
                               compute_latency=32, admit_queue_depth=1,
                               deadline=400, chunk=256,
                               check_conservation=True, record_bt=False),
    "faults": dict(arrivals=("uniform", 8.0), num_inferences=4,
                   compute_latency=32, deadline=600,
                   faults=dict(rate=2e-2, seed=3, protect="crc8",
                               max_retries=1),
                   check_conservation=True, record_bt=False),
    "faults_admission": dict(arrivals=[0, 64, 128, 192],
                             compute_latency=32, admit_queue_depth=1,
                             deadline=400,
                             faults=dict(rate=2e-2, seed=3, protect="crc8"),
                             check_conservation=True, record_bt=False),
    "truncated": dict(arrivals=("backtoback",), num_inferences=4,
                      max_cycles=128, allow_truncation=True,
                      record_bt=False),
}

_REF = {}


def _kwargs(pkg, name):
    kw = dict(CASES[name])
    kw["arrivals"] = _arrivals(pkg, kw["arrivals"])
    kw.setdefault("chunk", CHUNK)
    if "faults" in kw:
        kw["faults"] = _fault_model(pkg, **kw["faults"])
    return kw


def _ref_online(work, name):
    """The reference's run of a case, memoized across the module."""
    if name not in _REF:
        _REF[name] = jonline.simulate_online(
            work["jcfg"], work["jreq"], work["jres"], **_kwargs("ref", name))
    return _REF[name]


def _port_online(work, name, device="cpu"):
    return online.simulate_online(work["cfg"], work["req"], work["res"],
                                  device=device, **_kwargs("port", name))


def _same_sim(got, want, what):
    if want is None:
        assert got is None, what
        return
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, (np.ndarray, jax.Array)):
            np.testing.assert_array_equal(a, np.asarray(b),
                                          err_msg=f"{what}.{f.name}")
        else:
            assert a == b, f"{what}.{f.name}: {a} != {b}"


def assert_online_equal(got, want):
    """Every field of the reference's OnlineResult, and its properties,
    equal (floats with ==: the same integers through the same formulas)."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name.startswith("sched_") or f.name in ("request", "result"):
            _same_sim(a, b, f.name)
        elif isinstance(b, np.ndarray):
            assert a is not None and a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f"{f.name}: {a} != {b}"
    for name in ("completed", "throughput", "num_shed", "num_failed",
                 "slo_attainment", "goodput"):
        assert getattr(got, name) == getattr(want, name), name


def _stepped(res) -> int:
    return res.sched_request.cycles + (res.sched_result.cycles
                                       if res.sched_result else 0)


@pytest.mark.parametrize("kind,load,seed", [
    ("uniform", 1.0, 0), ("uniform", 3.0, 0), ("uniform", 16.0, 0),
    ("poisson", 2.0, 0), ("poisson", 8.0, 3), ("poisson", 0.5, 11),
    ("backtoback", 1.0, 0)])
def test_arrival_times_match_reference(kind, load, seed):
    for n in (1, 2, 7, 16):
        got = online.ArrivalProcess(kind, load, seed).times(n)
        want = jonline.ArrivalProcess(kind, load, seed).times(n)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        assert got[0] == 0 and (np.diff(got) >= 0).all()


def test_arrival_errors_match_reference():
    for args in (("burst", 1.0), ("uniform", 0.0), ("poisson", -1.0)):
        with pytest.raises(ValueError) as mine:
            online.ArrivalProcess(*args)
        with pytest.raises(ValueError) as theirs:
            jonline.ArrivalProcess(*args)
        assert str(mine.value) == str(theirs.value)
    online.ArrivalProcess("backtoback", 0.0)
    for n in (0, -2):
        with pytest.raises(ValueError) as mine:
            online.ArrivalProcess().times(n)
        with pytest.raises(ValueError) as theirs:
            jonline.ArrivalProcess().times(n)
        assert str(mine.value) == str(theirs.value)
    assert online.ARRIVAL_KINDS == jonline.ARRIVAL_KINDS
    assert online.FAR_RELEASE == jonline.FAR_RELEASE


PERCENTILE_SAMPLES = [[7], [3, 3, 3, 3], [1, 2], [5, 1, 4, 1, 5, 9, 2, 6],
                      [0, 0, 10], list(range(101)), [259.0, 954.5, 1317.13]]


@pytest.mark.parametrize("values", PERCENTILE_SAMPLES)
def test_percentile_matches_reference_and_numpy(values):
    for q in (0.0, 1.0, 25.0, 50.0, 62.5, 99.0, 100.0):
        got = online.percentile(values, q)
        assert got == jonline.percentile(values, q)
        assert got == pytest.approx(float(np.percentile(values, q)),
                                    rel=1e-12)


def test_latency_percentiles_and_errors():
    cases = [[10, 20, 30, -1, -1], [-1, -1], [5], [4, 4, 9, 1, -1],
             list(range(16))]
    for lat in cases:
        for qs in ((50.0, 99.0), (0.0, 90.0, 99.9, 100.0)):
            got = online.latency_percentiles(lat, qs)
            want = jonline.latency_percentiles(lat, qs)
            assert got == want and list(got) == list(want)
    assert online.latency_percentiles([10, -1])["truncated"] == 1
    for bad in (([], 50.0), ([1, 2], 101.0), ([1], -0.5)):
        with pytest.raises(ValueError) as mine:
            online.percentile(*bad)
        with pytest.raises(ValueError) as theirs:
            jonline.percentile(*bad)
        assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="1-D"):
        online.latency_percentiles([[1, 2]])


def test_concat_inferences_matches_reference(work):
    for name in ("req", "res"):
        one, jone = work[name], work["j" + name]
        for n in (1, 3):
            got = traffic.concat_inferences(one, n)
            want = jtraffic.concat_inferences(jone, n)
            assert got.num_packets == want.num_packets == one.num_packets * n
            np.testing.assert_array_equal(got.words.numpy().view(np.uint32),
                                          np.asarray(want.words))
            for i, f in enumerate(("dest", "meta", "vc", "pkt", "length"),
                                  1):
                assert got[i].dtype == torch.int32
                np.testing.assert_array_equal(got[i].numpy(),
                                              np.asarray(want[i]), f)
    req = work["req"]
    batched = sim.Traffic(*(t[None] for t in req[:6]),
                          num_packets=req.num_packets)
    for bad, jbad, n in ((batched, None, 2),
                         (req._replace(num_packets=-1),
                          work["jreq"]._replace(num_packets=-1), 2),
                         (req, work["jreq"], 0)):
        with pytest.raises(ValueError) as mine:
            traffic.concat_inferences(bad, n)
        if jbad is not None:
            with pytest.raises(ValueError) as theirs:
                jtraffic.concat_inferences(jbad, n)
            assert str(mine.value) == str(theirs.value)
        else:
            assert "unbatched" in str(mine.value)


@pytest.mark.parametrize("name", sorted(CASES))
def test_simulate_online_matches_reference(work, name):
    got = _port_online(work, name)
    want = _ref_online(work, name)
    assert_online_equal(got, want)
    if name not in ("admission", "admission_chunk256", "faults_admission"):
        assert got.stepped_cycles == _stepped(got)
    if name == "truncated":
        assert got.truncated > 0 and (got.completions < 0).any()
    if name == "backtoback":
        assert (got.latencies[1:] > got.latencies[0]).all()
    if name == "faults":
        assert got.num_failed > 0 and got.slo_attainment < 1.0
        assert got.fault_ledger["request"]["transmission_rounds"] > 1


def test_zero_latency_single_inference_is_the_offline_drain(work):
    """One inference, zero compute latency: the reported phases are the
    offline ``simulate`` drains, and the gated request drain (every gate
    open at cycle 0) is the offline drain; a compute latency moves the
    result drain and no BT."""
    cfg, req, res = work["cfg"], work["req"], work["res"]
    got = _port_online(work, "zero_latency")
    off_req = sim.simulate(cfg, req, chunk=CHUNK, device="cpu")
    off_res = sim.simulate(cfg, res, chunk=CHUNK, device="cpu",
                           mc_nodes=np.asarray(cfg.pe_nodes, np.int32))
    for a, b in ((got.request, off_req), (got.result, off_res)):
        _same_sim(a, b, "phase")
    assert got.sched_request.total_bt == off_req.total_bt
    assert got.sched_request.drain_cycle == off_req.drain_cycle
    np.testing.assert_array_equal(got.sched_request.link_bt, off_req.link_bt)
    late = _port_online(work, "latency")
    assert late.result.total_bt == got.result.total_bt
    assert late.request.total_bt == got.request.total_bt
    assert late.result_drain_cycle > got.result_drain_cycle
    assert (late.latencies - got.latencies == 40).all()


def test_admission_restarts_and_the_chunk_moves_a_shed(work, monkeypatch):
    """Admission control replays the drain once per shedding boundary (at
    least twice here), and a longer chunk decides arrivals earlier, with
    staler completions: at chunk 256 every arrival is decided at cycle 0,
    before inference 0 delivered, and inference 2 is shed too
    (ROADMAP C15)."""
    made = []
    real = online._AdmissionController

    class Counting(real):
        def __init__(self, *a, **k):
            made.append(1)
            super().__init__(*a, **k)

    monkeypatch.setattr(online, "_AdmissionController", Counting)
    a64 = _port_online(work, "admission")
    replays = len(made) - 1
    assert replays >= 2
    assert a64.num_shed >= 2 and a64.stepped_cycles > _stepped(a64)
    a256 = _port_online(work, "admission_chunk256")
    assert not np.array_equal(a64.shed, a256.shed)
    assert_online_equal(a64, _ref_online(work, "admission"))
    assert_online_equal(a256, _ref_online(work, "admission_chunk256"))
    # Shed inferences never complete; the admitted ones all do.
    assert (a64.completions[a64.shed] < 0).all()
    assert (a64.completions[~a64.shed] >= 0).all()


def test_drain_with_retries_under_a_controller(work):
    """Round 0 consults the controller; the first shed stops the fault
    drain (``drained`` false) for the caller's replay, as the
    reference's does."""
    cfg, jcfg = work["cfg"], work["jcfg"]
    k, arr = 4, np.array([0, 64, 128, 192], np.int64)
    npkt = work["req"].num_packets
    inc = np.broadcast_to(work["req"].length.numpy().astype(np.int64)[:, None],
                          (cfg.num_mcs, k))
    cat = traffic.concat_inferences(work["req"], k)
    jcat = jtraffic.concat_inferences(work["jreq"], k)
    model = dict(rate=2e-2, seed=3, protect="crc8")
    for preshed in (None, np.array([False, True, False, False])):
        c = online._AdmissionController(arr, 1, inc, CHUNK, npkt, preshed)
        jc = jonline._AdmissionController(arr, 1, inc, CHUNK, npkt, preshed)
        src, jsrc, inc_f = cat, jcat, inc
        if preshed is not None:
            keep = np.repeat(~preshed, npkt)
            src = traffic.filter_packets(cat, keep)
            jsrc = jtraffic.filter_packets(jcat, keep)
            inc_f = np.where(preshed[None, :], 0, inc)
        got = faults.drain_with_retries(
            cfg, src, _fault_model("port", **model), mc_nodes=cfg.mc_nodes,
            release=c.release, inc=inc_f, chunk=CHUNK, controller=c,
            device="cpu")
        want = jfaults.drain_with_retries(
            jcfg, jsrc, _fault_model("ref", **model),
            mc_nodes=np.asarray(jcfg.mc_nodes), release=jc.release,
            inc=inc_f, chunk=CHUNK, controller=jc)
        assert c.restart_needed and jc.restart_needed and not got.drained
        for name in ("decided", "admitted", "release"):
            np.testing.assert_array_equal(getattr(c, name),
                                          getattr(jc, name))
        _same_sim(got.sim, want.sim, "sim")
        for name in ("inj_time", "eject_time", "eject_counts", "status",
                     "corrupted", "retries"):
            np.testing.assert_array_equal(getattr(got, name),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)
        assert got.rounds == want.rounds and got.ledger == want.ledger
        assert got.drained == want.drained


@pytest.mark.parametrize("bad", [
    dict(arrivals=online.ArrivalProcess("uniform", 2.0)),
    dict(arrivals=[]), dict(arrivals=[[0, 1]]),
    dict(arrivals=[0, 10], num_inferences=3), dict(arrivals=[10, 0]),
    dict(arrivals=[-1]), dict(arrivals=[0], deadline=0),
    dict(arrivals=[0], admit_queue_depth=0),
    dict(arrivals=[0], compute_latency=-1)])
def test_simulate_online_validation(work, bad):
    kw = dict(bad)
    if isinstance(kw["arrivals"], online.ArrivalProcess):
        jkw = dict(kw, arrivals=jonline.ArrivalProcess("uniform", 2.0))
    else:
        jkw = kw
    with pytest.raises(ValueError) as mine:
        online.simulate_online(work["cfg"], work["req"], work["res"],
                               device="cpu", **kw)
    with pytest.raises(ValueError) as theirs:
        jonline.simulate_online(work["jcfg"], work["jreq"], work["jres"],
                                **jkw)
    assert str(mine.value) == str(theirs.value)


def test_simulate_online_result_stream_checks(work):
    cfg, req, res = work["cfg"], work["req"], work["res"]
    short = sim.Traffic(*(t[:5] for t in res[:6]),
                        num_packets=res.num_packets)
    with pytest.raises(ValueError, match="result traffic has 5 streams"):
        online.simulate_online(cfg, req, short, arrivals=[0], device="cpu")
    pad = traffic.pad_traffic_length(res, res.words.shape[1])
    extra = sim.Traffic(*(torch.cat([t, t[:1]]) for t in pad[:6]),
                        num_packets=res.num_packets)
    with pytest.raises(ValueError, match="empty padding"):
        online.simulate_online(cfg, req, extra, arrivals=[0], device="cpu")


SERVING = dict(meshes=("4x4_mc2",), transforms=("O0", "O1", "O2"),
               tiebreaks=("pattern",), precisions=("fixed8",),
               models=("lenet",), max_packets_per_layer=MAXP,
               result_phase=True, offered_loads=(8.0, 32.0),
               serving_inferences=4, compute_latency=32, arrival="uniform",
               chunk=CHUNK, fault_rates=(0.0, 1e-3), fault_protect="crc8",
               deadline=6000, admit_queue_depth=6)


@pytest.fixture(scope="module")
def serving_runs(work, tmp_path_factory):
    """``run_serving`` on the smoke grid's axes, both sides, each writing
    its JSON; the port fed the reference's result values (ROADMAP C11)."""
    out = tmp_path_factory.mktemp("serving")
    jlayers, layers = work["jlayers"], work["layers"]
    want = jrun_serving(JGrid(**SERVING, backend="fused"),
                        lambda _name: jlayers,
                        out_path=str(out / "ref.json"),
                        check_conservation=True)
    values = [[torch.from_numpy(np.array(v)) for v in layer]
              for layer in jtraffic.result_values(
                  jlayers, [(jby_name(o, tiebreak="pattern"),
                             lambda t: jquant(t).values)
                            for o in SERVING["transforms"]], MAXP)]
    mp = pytest.MonkeyPatch()
    mp.setattr(sweep, "result_values", lambda *a, **k: values)
    try:
        got = sweep.run_serving(sweep.SweepGrid(**SERVING, device="cpu"),
                                lambda _name: layers,
                                out_path=str(out / "port.json"),
                                check_conservation=True)
    finally:
        mp.undo()
    return got, want, out


def test_run_serving_matches_reference(serving_runs):
    got, want, _ = serving_runs
    assert got.rows == want.rows
    srv, jsrv = got.stats["serving"], want.stats["serving"]
    assert set(srv) - set(jsrv) == {"stepped_cycles", "workers"}
    for key in jsrv:
        if key != "serving_s":
            assert srv[key] == jsrv[key], key
    assert len(srv["points"]) == 4 and len(srv["combos"]) == 1
    assert srv["stepped_cycles"] > 0 and srv["workers"] == 1
    assert all(list(p) == list(q)
               for p, q in zip(srv["points"], jsrv["points"]))


class _InlinePool:
    """``ProcessPoolExecutor`` in this process: every task and result goes
    through the pool's pickler (``ForkingPickler``, which moves CPU tensor
    storage to shared memory), then runs here."""

    def __init__(self, processes, mp_context=None, initializer=None):
        assert processes > 1 and mp_context.get_start_method() == "spawn"
        self.initializer = initializer

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, tasks):
        def trip(x):
            return ForkingPickler.loads(ForkingPickler.dumps(x))
        self.initializer()
        return [trip(fn(*trip((t,)))) for t in tasks]


def test_run_serving_worker_processes_give_the_serial_points(work,
                                                            monkeypatch):
    """``run_serving`` drains in this process on the CPU, and on the card
    in one spawned process a host core, up to one a drain; the pool's
    drains equal the reference's, field for field, and leave the caller's
    traffic where it was (the reference's arrays alias it)."""
    cores = len(os.sched_getaffinity(0))
    assert sweep._serving_processes(torch.device("cpu"), 10) == 1
    assert sweep._serving_processes(torch.device("cuda"), 1) == 1
    assert sweep._serving_processes(torch.device("cuda"), 10**6) == cores
    monkeypatch.setattr(sweep, "ProcessPoolExecutor", _InlinePool)
    names = ("truncated", "faults_admission")
    tasks = [(work["cfg"], work["req"], work["res"],
              dict(_kwargs("port", name), device="cpu")) for name in names]
    before = [t.words.data_ptr() for t in (work["req"], work["res"])]
    threads = torch.get_num_threads()
    try:
        drains = sweep._drain_all(tasks, 2)
    finally:
        torch.set_num_threads(threads)
    assert [t.words.data_ptr() for t in (work["req"], work["res"])] == before
    for name, got in zip(names, drains):
        want = _ref_online(work, name)
        assert_online_equal(got, want)
        # The admission case replays its drain: more cycles stepped than
        # the schedule's phases hold.
        assert (got.stepped_cycles == _stepped(want) if name == "truncated"
                else got.stepped_cycles > _stepped(want))


def test_serving_and_sweep_json_match_reference(serving_runs, work,
                                                tmp_path):
    _, _, out = serving_runs

    def load(name):
        with open(out / name) as f:
            return json.load(f)

    mine, theirs = load("port.json"), load("ref.json")
    assert mine["grid"].pop("device") == "cpu"
    assert mine["grid"] == dict(theirs["grid"], backend="auto")
    assert mine["rows"] == theirs["rows"]
    for key in ("cells", "stepped_cycles", "streamed", "devices",
                "result_phase", "result_cycles"):
        assert mine["stats"][key] == theirs["stats"][key], key
    assert mine["stats"]["serving"]["points"] == theirs["stats"]["serving"][
        "points"]
    # run_sweep's own out_path, on the serving grid's sweep axes alone.
    grid = {k: v for k, v in SERVING.items()
            if k in ("meshes", "transforms", "tiebreaks", "precisions",
                     "models", "max_packets_per_layer", "chunk")}
    jrun_sweep(JGrid(**grid, backend="fused"),
               lambda _name: work["jlayers"],
               out_path=str(tmp_path / "ref.json"), devices=None)
    sweep.run_sweep(sweep.SweepGrid(**grid, device="cpu"),
                    lambda _name: work["layers"],
                    out_path=str(tmp_path / "sub" / "port.json"))
    with open(tmp_path / "ref.json") as f:
        theirs = json.load(f)
    with open(tmp_path / "sub" / "port.json") as f:
        mine = json.load(f)
    assert mine["grid"].pop("device") == "cpu"
    assert mine["grid"] == dict(theirs["grid"], backend="auto")
    assert list(mine["grid"]) == list(theirs["grid"])
    assert mine["rows"] == theirs["rows"]
    assert set(theirs["stats"]) <= set(mine["stats"])


@pytest.mark.parametrize("bad", [
    dict(arrival="burst"), dict(offered_loads=(1.0, 0.0)),
    dict(serving_inferences=0), dict(compute_latency=-1),
    dict(fault_protect="hamming"), dict(fault_rates=(0.0, 1.5)),
    dict(fault_max_retries=-1), dict(fault_ack_latency=0),
    dict(deadline=0), dict(admit_queue_depth=0)])
def test_grid_validation_matches_reference(bad):
    with pytest.raises(ValueError) as mine:
        sweep.SweepGrid(**bad)
    with pytest.raises(ValueError) as theirs:
        JGrid(**bad)
    assert str(mine.value) == str(theirs.value)


def test_run_serving_errors_and_exports(work):
    layers = work["layers"]
    fn = lambda _name: layers          # noqa: E731
    with pytest.raises(ValueError) as mine:
        sweep.run_serving(sweep.SweepGrid(**SERVING, device="cpu"), fn,
                          devices="everywhere")
    with pytest.raises(ValueError) as theirs:
        jrun_serving(JGrid(**SERVING), lambda _name: work["jlayers"],
                     devices="everywhere")
    assert str(mine.value) == str(theirs.value)
    for bad in (dict(offered_loads=()), dict(max_packets_per_layer=None),
                dict(compression=("none", "msr"))):
        kw = dict(SERVING, **bad)
        with pytest.raises(ValueError) as mine:
            sweep.run_serving(sweep.SweepGrid(**kw, device="cpu"), fn)
        with pytest.raises(ValueError) as theirs:
            jrun_serving(JGrid(**kw), lambda _name: work["jlayers"])
        assert str(mine.value) == str(theirs.value)
    for name in ("ArrivalProcess", "OnlineResult", "simulate_online",
                 "percentile", "latency_percentiles", "ARRIVAL_KINDS",
                 "run_serving", "concat_inferences"):
        assert name in noc.__all__ and hasattr(noc, name)
    assert ([f.name for f in dataclasses.fields(online.OnlineResult)][:-1]
            == [f.name for f in dataclasses.fields(jonline.OnlineResult)])


@pytest.mark.cuda
@cuda
def test_card_online_equals_cpu_online(work):
    for name in ("faults_admission", "zero_latency"):
        on_card = _port_online(work, name, device=None)
        on_cpu = _port_online(work, name)
        assert_online_equal(on_card, on_cpu)
        assert on_card.stepped_cycles == on_cpu.stepped_cycles
