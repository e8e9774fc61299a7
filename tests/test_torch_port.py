"""The port's own contract, without the reference:

* ``import repro_torch`` (every module) leaves ``jax`` and ``repro`` out of
  ``sys.modules``, and no port source names them in an import;
* an entry point given no device raises on a machine without CUDA;
* on a CUDA machine, each of the six Hopper kernels equals its plain
  PyTorch version exactly, and a train step captured into a CUDA graph
  equals the eager step (marked ``cuda``; run them on the card with
  ``python -m pytest -q -m cuda tests/test_torch_port.py``).
"""
import dataclasses
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PORT = os.path.join(SRC, "repro_torch")


def _port_modules():
    import repro_torch
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


def test_import_leaves_jax_and_repro_out():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {SRC!r})\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_no_port_source_imports_jax_or_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    hits = []
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    if pat.search(fh.read()):
                        hits.append(os.path.join(root, f))
    assert not hits, hits


@pytest.mark.skipif(torch.cuda.device_count() > 0,
                    reason="a CUDA device is present, so cuda is the default")
def test_entry_points_without_device_raise_on_cpu_machine():
    from repro_torch.data import glyph_batch
    from repro_torch.noc import SweepGrid, mesh_by_name, run_sweep, simulate
    from repro_torch.noc.sim import make_state
    from repro_torch.noc.traffic import build_traffic_batch
    cfg = mesh_by_name("2x2_mc1")
    calls = [
        lambda: glyph_batch(torch.Generator(), 1),
        lambda: make_state(cfg, 1),
        lambda: build_traffic_batch([], cfg, []),
        lambda: run_sweep(SweepGrid(), lambda _n: []),
        lambda: simulate(cfg, None),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_kernel_wrappers_refuse_cpu_tensors_and_oversized_rows():
    """A wrapper launches its kernel or raises: CPU tensors go to the plain
    versions through ``ops``, never to a kernel, and a row too wide for a
    block's shared memory is refused naming its width."""
    from repro_torch.kernels import _build, bitonic_sort, chain_select
    from repro_torch.kernels import order_unit
    x = torch.zeros((2, 128), dtype=torch.int32)
    calls = [lambda: bitonic_sort.sort_windows(x, x),
             lambda: order_unit.order_unit_words(x),
             lambda: chain_select.chain_select([x], x, 128)]
    for call in calls:
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            call()
    _build.check_fits("chain_select", 16384, 2)
    with pytest.raises(ValueError, match="width 32768"):
        _build.check_fits("chain_select", 32768, 2)


# --------------------------------------------------------------------------
# On the card: each kernel against its plain version, exact equality.

cuda = pytest.mark.skipif(torch.cuda.device_count() < 1,
                          reason="needs a CUDA device")


@pytest.mark.cuda
@cuda
@pytest.mark.parametrize("n", [1, 3, 1000, 1 << 16])
def test_popcount_kernel_equals_plain(n):
    from repro_torch.kernels import popcount as k, ref
    rng = np.random.default_rng(n)
    w = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    w[:2] = [0xFFFFFFFF, 0x80000000][:min(n, 2)]
    x = torch.from_numpy(w.view(np.int32)).cuda()
    got = k.popcount_words(x)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref.popcount_ref(x.cpu()))
    # unaligned start: the scalar tail path
    if n > 4:
        assert torch.equal(k.popcount_words(x[1:]).cpu(),
                           ref.popcount_ref(x[1:].cpu()))


@pytest.mark.cuda
@cuda
@pytest.mark.parametrize("f,lanes,offset", [
    (1, 16, 0), (2, 1, 0), (17, 16, 0), (4097, 16, 0), (9, 130, 0),
    (1, 1, 0), (2, 3, 0), (3, 8, 0), (3, 33, 0), (200, 1, 0), (77, 3, 0),
    (301, 8, 0), (129, 12, 0), (65, 17, 0), (40, 32, 0), (7778, 8, 0),
    (33, 8, 2), (33, 8, 1), (5, 0, 0)])
def test_bt_count_kernel_equals_plain(f, lanes, offset):
    """Counts and total in one launch, and each alone, at every chunk width
    (16-, 8- and 4-byte loads; ``offset`` words shift the base off 16-byte
    alignment) and on both sides of the 32-word segmented-scan limit."""
    from repro_torch.kernels import bt_count as k, ref
    rng = np.random.default_rng(f * lanes + offset)
    buf = rng.integers(0, 2**32, offset + f * lanes,
                       dtype=np.uint64).astype(np.uint32)
    x = torch.from_numpy(buf.view(np.int32)).cuda()[offset:].view(f, lanes)
    counts, total = k.bt_count(x)
    alone, tot_alone = k.bt_boundaries(x), k.bt_total(x)
    torch.cuda.synchronize()
    assert counts.shape == (max(f - 1, 0),) and total.shape == ()
    want = ref.bt_boundaries_ref(x.cpu())
    assert torch.equal(counts.cpu(), want)
    assert torch.equal(alone.cpu(), want)
    assert int(total) == int(tot_alone) == int(ref.bt_total_ref(x.cpu()))


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided when the test runs)."""
    if torch.cuda.device_count() < 1:
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (mesh, count_headers, packets, flits a packet, (VCs, depth, lanes) or
# None for the paper's 4, 4, 16): one mesh for each shared-memory layout the
# wrapper chooses (2x2 and 4x4: the whole FIFO; 8x8: all but the payload;
# 16x16: the sideband but not link_last), a congested 8x8 whose FIFOs fill
# so that credits refuse pushes, and two other router geometries, which run
# the kernel's general instantiation (8 VCs: 40 slots a router, more than
# one request word).
ROUTER_CASES = [
    ("2x2_mc1", True, 40, 5, None), ("4x4_mc2", True, 40, 5, None),
    ("4x4_mc2", False, 40, 5, None), ("8x8_mc4", True, 40, 5, None),
    ("8x8_mc4", False, 40, 5, None), ("16x16_mc16", True, 60, 5, None),
    ("16x16_mc16", False, 60, 5, None), ("8x8_mc16", True, 120, 24, None),
    ("4x4_mc2", True, 40, 5, (2, 3, 8)), ("4x4_mc2", False, 60, 5, (8, 2, 16)),
]
ROUTER_LAYOUTS = {
    "2x2_mc1": ("side", "link_last", "payload"),
    "4x4_mc2": ("side", "link_last", "payload"),
    "8x8_mc4": ("side", "link_last"), "8x8_mc16": ("side", "link_last"),
    "16x16_mc16": ("side",),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mesh,headers,packets,flits,geometry", ROUTER_CASES)
def test_router_kernel_equals_plain_step(card, mesh, headers, packets, flits,
                                         geometry):
    """Chunks of 1, 7, 64 and 2,048 cycles with the state carried across
    launches and a lane compaction (``state.take``) between two of them:
    every leaf equal to the plain step's, the FIFO on real router rows."""
    from repro_torch.kernels import ref, router_step as k
    from repro_torch.noc import sim
    from repro_torch.noc.topology import mesh_by_name
    cfg = mesh_by_name(mesh)
    if geometry:
        v, d, lanes = geometry
        cfg = dataclasses.replace(cfg, num_vcs=v, vc_depth=d, lanes=lanes)
    key = (cfg.rows, cfg.cols, cfg.num_vcs, cfg.vc_depth, cfg.lanes)
    t = _synthetic_traffic(cfg, batch=3, packets=packets, seed=5,
                           flits=flits)
    wire = sim.fuse_traffic(t)
    m = wire.length.shape[1]
    assert k.smem_layout(key, m).in_shared == ROUTER_LAYOUTS[mesh]
    mc = torch.as_tensor(np.broadcast_to(
        np.asarray(tuple(cfg.mc_nodes) + (0,) * (m - cfg.num_mcs), np.int32),
        (3, m)).copy(), device=card)
    a = sim.make_state(cfg, m, batch=3, device=card)
    b = sim.SimState(*(leaf.clone() for leaf in a))
    nr = cfg.num_routers
    peak = 0
    for i, chunk in enumerate((1, 7, 64, 2048)):
        if i == 2:      # compaction: lanes 2 and 0, in that order
            idx = torch.tensor([2, 0], device=card)
            a, b = a.take(idx), b.take(idx)
            wire = sim.Wire(wire.wire.index_select(0, idx),
                            wire.length.index_select(0, idx))
            mc = mc.index_select(0, idx)
        a = k.router_step(a, wire, mc, chunk, key, headers)
        b = ref.router_step_ref(b, wire, mc, chunk, key, headers)
        torch.cuda.synchronize()
        for name, x, y in zip(a._fields, a, b):
            if name == "fifo":
                x, y = x[:, :nr], y[:, :nr]     # phantom row may differ
            assert torch.equal(x, y), (name, chunk)
        peak = max(peak, int(a.count[:, :nr].max()))
    assert bool((a.ejected > 0).all())
    if flits > 5:
        assert peak == cfg.vc_depth     # congested: some FIFO filled


@pytest.mark.cuda
@cuda
@pytest.mark.parametrize("r,w,npay", [(1, 128, 0), (37, 128, 2), (16, 256, 1),
                                      (512, 512, 1), (3, 4096, 2),
                                      (2, 16384, 2)])
def test_bitonic_sort_kernel_equals_plain(r, w, npay):
    """Tie-heavy keys (popcounts in [0, 33)): the network's exact output,
    payloads included, not just a sorted multiset."""
    from repro_torch.kernels import bitonic_sort as k, ref
    rng = np.random.default_rng(r * w + npay)
    keys = torch.from_numpy(rng.integers(0, 33, (r, w)).astype(np.int32))
    pays = [torch.from_numpy(rng.integers(0, 2**32, (r, w), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32))
            for _ in range(npay)]
    got = k.sort_windows(keys.cuda(), *(p.cuda() for p in pays))
    torch.cuda.synchronize()
    want = ref.sort_windows_ref(keys, *pays)
    assert len(got) == len(want) == 1 + npay
    for g, v in zip(got, want):
        assert torch.equal(g.cpu(), v)


@pytest.mark.cuda
@cuda
@pytest.mark.parametrize("r,w", [(1, 128), (9, 256), (512, 512), (4, 8192)])
def test_order_unit_kernel_equals_plain(r, w):
    from repro_torch.kernels import order_unit as k, ref
    rng = np.random.default_rng(r + w)
    words = torch.from_numpy(rng.integers(0, 2**32, (r, w), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32))
    out, perm = k.order_unit_words(words.cuda())
    torch.cuda.synchronize()
    want_out, want_perm = ref.order_unit_ref(words)
    assert torch.equal(out.cpu(), want_out)
    assert torch.equal(perm.cpu(), want_perm)


def _select_penalty(kind, rng, r, w, xors):
    """(R, W) int32 penalties: the chain's four classes; tie-heavy (keys
    dvec * W + small); keys that wrap past INT32_MAX; or the chain's
    classes with one key of each row set to INT32_MIN."""
    chain = np.array([0, 1 << 28, 1 << 30, (1 << 30) + (1 << 28)], np.int64)
    idx = np.arange(w, dtype=np.int64)
    if kind == "chain":
        pen = rng.choice(chain, (r, w))
    elif kind == "ties":
        pen = -idx[None, :] + rng.integers(0, 3, (r, w))
    elif kind == "wrap":
        pen = (2**31 - 1) - rng.integers(0, 40 * w + 1, (r, w))
    else:
        pen = rng.choice(chain, (r, w))
        d = sum(np.vectorize(lambda v: bin(int(v)).count("1"))(x)
                for x in xors) if r and w else 0
        for i in range(r):
            j = int(rng.integers(0, w))
            pen[i, j] = -(2**31) - int(d[i, j]) * w - j
    return ((pen + 2**31) % 2**32 - 2**31).astype(np.int32)


@pytest.mark.cuda
@cuda
@pytest.mark.parametrize("kind", ["chain", "ties", "wrap", "int32_min"])
@pytest.mark.parametrize("r,w,planes", [(1, 1, 1), (3, 17, 1), (5, 130, 2),
                                        (64, 152, 2), (2, 400, 1),
                                        (1, 4096, 2), (1, 16000, 1),
                                        (9, 28, 2), (4, 256, 1),
                                        (3, 1024, 2), (2, 1025, 1),
                                        (0, 152, 2)])
def test_chain_select_kernel_equals_plain(r, w, planes, kind):
    """Both kernels (a warp a row up to W = 1,024, the shared-memory network
    above) against the plain stable order, on penalties whose keys tie,
    wrap, or hit INT32_MIN."""
    from repro_torch.kernels import chain_select as k, ref
    rng = np.random.default_rng(r * 7 + w + planes)
    xors = [rng.integers(0, 2**32, (r, w), dtype=np.uint64).astype(np.uint32)
            for _ in range(planes)]
    pen = torch.from_numpy(_select_penalty(kind, rng, r, w, xors))
    xors = [torch.from_numpy(x.view(np.int32)) for x in xors]
    dvec, order = k.chain_select([x.cuda() for x in xors], pen.cuda(), w)
    torch.cuda.synchronize()
    want_d, want_o = ref.chain_select_ref(xors, pen, w)
    assert torch.equal(dvec.cpu(), want_d)
    assert torch.equal(order.cpu(), want_o)


def _synthetic_traffic(cfg, batch, packets, seed, flits=5):
    """Random payload words on the packetizer's real skeleton."""
    from repro_torch.noc.traffic import TrafficAssembler
    rng = np.random.default_rng(seed)
    asm = TrafficAssembler([(packets, flits)], cfg, num_variants=batch,
                           device="cuda")
    w = rng.integers(0, 2**32, (batch, packets, flits, cfg.lanes),
                     dtype=np.uint64).astype(np.uint32)
    asm.add_chunk(0, 0, torch.from_numpy(w.view(np.int32)).cuda())
    return asm.finish()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-125m", "mixtral-8x7b"])
def test_cuda_graph_train_step_equals_the_eager_step(arch):
    """Three train steps of a reduced arch on the card, captured into a CUDA
    graph and replayed, against the eager steps: every leaf of the state
    and every metric bit for bit, the wire report included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step is captured into a CUDA "
                    "graph")
    from repro_torch import configs, tree
    from repro_torch.data import TokenStream
    from repro_torch.dist import gradient_wire_report
    from repro_torch.launch.train import loss_fn_for
    from repro_torch.models import init_params
    from repro_torch.optim import AdamW, wsd
    from repro_torch.train import init_state, make_train_step
    a = configs.get(arch)
    model = a.build_reduced()
    params = init_params(model.specs(), torch.Generator("cuda").manual_seed(0),
                         "cuda")
    stream = TokenStream(vocab=model.cfg.vocab, seq_len=32, global_batch=4)
    opt = AdamW(wsd(3e-3, 10, warmup=2))
    loss_fn = loss_fn_for(a, model)
    graphed = make_train_step(loss_fn, opt, wire_telemetry=True)
    x = y = init_state(params, opt)
    for i in range(3):
        batch = stream.batch(i, device="cuda")
        x0 = x
        x, mx, grads = graphed.core(x, batch)
        mx["wire"] = gradient_wire_report(grads, x0.params)
        y, my = graphed(y, batch)
        assert graphed.graph is not None
        assert all(torch.equal(u, v) for u, v in zip(tree.leaves(x),
                                                     tree.leaves(y)))
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(mx[k], my[k])
        assert {k: float(v) for k, v in mx["wire"].items()} == {
            k: float(v) for k, v in my["wire"].items()}
