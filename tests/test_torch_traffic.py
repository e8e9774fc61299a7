"""Port parity: LeNet, layer traffic and the request packetizer of
``repro_torch`` against live ``repro`` on the same inputs.

* LeNet ``activations``/``forward`` from ``params_from_jax`` within
  rtol 1e-5 / atol 1e-6 (float32; the convolution and matmul sums run in
  another order);
* ``layer_traffic`` exactly equal when fed the reference's own activations,
  conv2's (Cin, kh, kw) / (kh, kw, Cin) pairing quirk included;
* ``build_traffic_batch`` field-equal to the reference's on its
  ``LayerTraffic`` (4x4_mc2, the 12 pinned variants; the streamed path is
  in test_torch_stream.py);
* ``load_checkpoint`` equal to the reference's restore of the same npz.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.wire import by_name as jby_name  # noqa: E402
from repro.data import glyph_batch as jglyph  # noqa: E402
from repro.models import LeNet as JLeNet, init_params  # noqa: E402
from repro.noc import traffic as jtraffic  # noqa: E402
from repro.noc.topology import mesh_by_name as jmesh  # noqa: E402
from repro.quant import quantize_fixed8 as jquant  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.core.wire import by_name  # noqa: E402
from repro_torch.data import glyph_batch  # noqa: E402
from repro_torch.models import LeNet, load_checkpoint, params_from_jax  # noqa: E402
from repro_torch.noc import traffic  # noqa: E402
from repro_torch.noc.topology import mesh_by_name  # noqa: E402
from repro_torch.quant import quantize_fixed8  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "experiments", "weights", "lenet", "step_000000400")
CELLS = [(prec, tb, o) for prec in ("float32", "fixed8")
         for tb in ("stable", "pattern") for o in ("O0", "O1", "O2")]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the module's tests on one torch thread (the port's test modules
    import this fixture). The plain paths are many small ops: beside the
    other test workers, intra-op threads only contend for the cores (one
    plain 8x8 drain of test_torch_sim took 175 s on all threads and 49 s
    on one, every core busy)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    """Reference LeNet params (numpy), image and per-layer traffic."""
    model = JLeNet()
    params = init_params(model.specs(), jax.random.PRNGKey(1))
    x, _ = jglyph(jax.random.PRNGKey(7), 2)
    np_params = {k: np.array(v) for k, v in params.items()}
    return model, params, np_params, np.array(x)


def _variants(torch_side):
    out = []
    for prec, tb, o in CELLS:
        if torch_side:
            q = None if prec == "float32" else (
                lambda t: quantize_fixed8(t).values)
            out.append((by_name(o, tiebreak=tb), q))
        else:
            q = None if prec == "float32" else (lambda t: jquant(t).values)
            out.append((jby_name(o, tiebreak=tb), q))
    return out


def _layers_np(jlayers):
    return [traffic.LayerTraffic(torch.from_numpy(np.array(lt.inputs)),
                                 torch.from_numpy(np.array(lt.weights)))
            for lt in jlayers]


def _assert_traffic_equal(got, want):
    np.testing.assert_array_equal(got.words.numpy().view(np.uint32),
                                  np.asarray(want.words))
    for f in ("dest", "meta", "vc", "pkt", "length"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert got.num_packets == want.num_packets


def test_lenet_forward_and_activations_match_reference(ref):
    model, params, np_params, x = ref
    net = LeNet(params_from_jax(np_params, device="cpu"), device="cpu")
    logits = net(torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(model.forward(params, x)),
                               rtol=1e-5, atol=1e-6)
    for got, want in zip(net.activations(torch.from_numpy(x[0])),
                         model.activations(params, x[0])):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(net.weight_stream().numpy(),
                                  np.asarray(model.weight_stream(params)))


def test_layer_traffic_exact_on_reference_activations(ref):
    """Fed the reference's activations, conv/linear traffic extraction is
    exact - including conv2, whose patch columns are (Cin, kh, kw) against
    weight columns (kh, kw, Cin)."""
    model, params, np_params, x = ref
    acts = [np.array(a) for a in model.activations(params, x[0])]
    jl = model.layer_traffic(params, x[0])
    t = {k: torch.from_numpy(v) for k, v in np_params.items()}
    got = [traffic.conv_layer_traffic(torch.from_numpy(acts[0]), t["c1w"]),
           traffic.conv_layer_traffic(torch.from_numpy(acts[1]), t["c2w"]),
           traffic.linear_layer_traffic(torch.from_numpy(acts[2]), t["f1w"].T),
           traffic.linear_layer_traffic(torch.from_numpy(acts[3]), t["f2w"].T),
           traffic.linear_layer_traffic(torch.from_numpy(acts[4]), t["f3w"].T)]
    for g, w in zip(got, jl):
        np.testing.assert_array_equal(g.inputs.numpy(), np.asarray(w.inputs))
        np.testing.assert_array_equal(g.weights.numpy(), np.asarray(w.weights))
    # The quirk itself: conv2's first weight column is w[0, 0, 0, :], but its
    # first patch column is channel 0 at (0, 0) and its second patch column
    # is channel 0 at (0, 1) - while the second weight column is channel 1.
    assert np.array_equal(got[1].weights[0, 1].numpy(), np_params["c2w"][0, 0, 1, 0])
    assert np.array_equal(got[1].inputs[0, 1].numpy(), acts[1][0, 1, 0])


@pytest.fixture(scope="module")
def ref_layers(ref):
    model, params, _, x = ref
    return model.layer_traffic(params, x[0])


def test_build_traffic_batch_matches_reference(ref_layers):
    want = jtraffic.build_traffic_batch(ref_layers, jmesh("4x4_mc2"),
                                        _variants(False),
                                        max_packets_per_layer=8)
    got = traffic.build_traffic_batch(_layers_np(ref_layers),
                                      mesh_by_name("4x4_mc2"), _variants(True),
                                      max_packets_per_layer=8, device="cpu")
    _assert_traffic_equal(got, want)


def test_stream_helpers_match_reference(ref_layers):
    shapes = jtraffic.payload_shapes(ref_layers, 16, _variants(False),
                                     max_packets_per_layer=8)
    assert traffic.payload_shapes(_layers_np(ref_layers), 16,
                                  _variants(True), max_packets_per_layer=8,
                                  device="cpu") == shapes
    for m in (1, 2, 3, 8):
        np.testing.assert_array_equal(traffic.stream_lengths(shapes, m),
                                      jtraffic.stream_lengths(shapes, m))
    one = traffic.build_traffic(_layers_np(ref_layers), mesh_by_name("4x4_mc2"),
                                by_name("O1"), max_packets_per_layer=8,
                                device="cpu")
    jone = jtraffic.build_traffic(ref_layers, jmesh("4x4_mc2"),
                                  jby_name("O1"), max_packets_per_layer=8)
    _assert_traffic_equal(traffic.pad_traffic_length(one, 500),
                          jtraffic.pad_traffic_length(jone, 500))
    _assert_traffic_equal(traffic.stack_traffics([one, one]),
                          jtraffic.stack_traffics([jone, jone]))


def test_load_checkpoint_matches_reference_restore():
    model = JLeNet()
    like = {"params": init_params(model.specs(), jax.random.PRNGKey(0)),
            "acc": jnp.zeros(())}
    step, tree = jckpt.restore(os.path.dirname(CKPT), like)
    for path in (CKPT, os.path.dirname(CKPT)):
        ck = load_checkpoint(path, device="cpu")
        assert ck.step == step
        assert ck.acc == float(tree["acc"])
        assert sorted(ck.params) == sorted(tree["params"])
        for k, v in tree["params"].items():
            np.testing.assert_array_equal(ck.params[k].numpy(), np.asarray(v))


def test_glyph_batch_shapes_and_range():
    g = torch.Generator().manual_seed(3)
    img, labels = glyph_batch(g, 4, device="cpu")
    assert img.shape == (4, 32, 32, 1) and img.dtype == torch.float32
    assert labels.shape == (4,) and int(labels.min()) >= 0 and int(labels.max()) < 10
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0
    img2, labels2 = glyph_batch(torch.Generator().manual_seed(3), 4,
                                device="cpu")
    assert torch.equal(img, img2) and torch.equal(labels, labels2)
