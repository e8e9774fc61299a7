"""Port parity: ``models/spec.py``, the DarkNet-like CNN and a DarkNet sweep
of ``repro_torch`` against live ``repro`` on the same inputs.

* ``specs()`` of both models: shapes, logical axes, init and scale equal
  the reference's, and so do ``param_count`` / ``param_bytes`` /
  ``axes_tree``;
* ``trained_model("darknet")`` reads the in-repo checkpoint as
  ``numpy.load`` of its npz does, and as the reference restores it;
* ``forward`` and ``activations`` on one reference glyph image (64x64x3)
  with the trained weights within atol 1e-4 (float32 convolutions summed in
  another order; the logits reach ~40);
* ``layer_traffic`` exactly equal fed the reference's own activations,
  with ROADMAP C6 (conv patches (Cin, kh, kw) against weights (kh, kw,
  Cin)) pinned on conv1;
* the sweep rows on 4x4_mc2 at 3 packets a layer, float32 + fixed8,
  ``pattern``, O0/O1/O2 (packet windows 27 to 576 words) equal live
  ``repro``'s on the reference's ``LayerTraffic``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import glyph_batch as jglyph  # noqa: E402
from repro.models import DarkNetLike as JDarkNet, LeNet as JLeNet  # noqa: E402
from repro.models import spec as jspec  # noqa: E402
from repro.noc import SweepGrid as JGrid, run_sweep as jrun_sweep  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.models import (DarkNetLike, LeNet, axes_tree,  # noqa: E402
                                param_bytes, param_count, spec,
                                trained_model)
from repro_torch.noc import SweepGrid, run_sweep, traffic  # noqa: E402

from test_torch_traffic import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "experiments", "weights", "darknet",
                    "step_000000400")


@pytest.fixture(scope="module")
def ref():
    """The reference DarkNet, its trained params (numpy), one glyph image
    (64x64x3) and that image's per-layer traffic."""
    model = JDarkNet()
    with np.load(os.path.join(CKPT, "host0000.npz")) as z:
        np_params = {k[len("params/"):]: z[k] for k in z.files
                     if k.startswith("params/")}
    params = {k: jnp.asarray(v) for k, v in np_params.items()}
    x, _ = jglyph(jax.random.PRNGKey(11), 1, hw=64, channels=3)
    x = np.array(x)
    return model, params, np_params, x, model.layer_traffic(params, x[0])


@pytest.mark.parametrize("name", ["lenet", "darknet"])
def test_specs_match_reference(name):
    jmodel = JLeNet() if name == "lenet" else JDarkNet()
    cls = LeNet if name == "lenet" else DarkNetLike
    got, want = cls.specs(), jmodel.specs()
    net = cls(spec.init_params(got, torch.Generator().manual_seed(0), "cpu"),
              device="cpu")
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert (g.shape, g.axes, g.init, g.scale) == (w.shape, w.axes,
                                                      w.init, w.scale)
        assert str(g.dtype).split(".")[-1] == jnp.dtype(w.dtype).name
        assert tuple(getattr(net, k).shape) == w.shape
    assert param_count(got) == jspec.param_count(want)
    assert param_bytes(got) == jspec.param_bytes(want)
    assert axes_tree(got) == jspec.axes_tree(want)


def test_spec_init_and_abstract_params():
    specs = {"a": spec.ParamSpec((4, 8), (None, "embed")),
             "nest": {"z": spec.ParamSpec((3,), ("embed",), init="zeros"),
                      "o": spec.ParamSpec((2,), (None,), init="ones",
                                          dtype=torch.float32)}}
    p = spec.init_params(specs, torch.Generator().manual_seed(0),
                         device="cpu")
    assert p["a"].dtype == torch.bfloat16 and p["a"].shape == (4, 8)
    assert torch.equal(p["nest"]["z"], torch.zeros(3, dtype=torch.bfloat16))
    assert torch.equal(p["nest"]["o"], torch.ones(2))
    assert param_count(specs) == 37
    assert param_bytes(specs) == 32 * 2 + 3 * 2 + 2 * 4
    with pytest.raises(ValueError, match="rank"):
        spec.ParamSpec((2, 2), ("embed",))
    ab = spec.abstract_params(specs)
    assert (ab["a"].shape, ab["a"].dtype, ab["a"].device.type) == (
        (4, 8), torch.bfloat16, "meta")
    assert (ab["nest"]["o"].shape, ab["nest"]["o"].dtype) == ((2,),
                                                             torch.float32)
    assert (ab["nest"]["z"].shape, ab["nest"]["z"].dtype) == (
        (3,), torch.bfloat16)


def test_trained_checkpoint_matches_npz_and_reference_restore(ref):
    _, _, np_params, _, _ = ref
    net, params, shape = trained_model("darknet", device="cpu")
    assert shape == (64, 64, 3) and isinstance(net, DarkNetLike)
    assert sorted(params) == sorted(np_params)
    for k, v in np_params.items():
        np.testing.assert_array_equal(params[k].numpy(), v)
        np.testing.assert_array_equal(getattr(net, k).detach().numpy(), v)
    like = {"params": {k: jnp.zeros(v.shape, jnp.float32)
                       for k, v in np_params.items()},
            "acc": jnp.zeros(())}
    _, tree = jckpt.restore(os.path.dirname(CKPT), like)
    for k, v in tree["params"].items():
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(v))
    with pytest.raises(ValueError, match="unknown model"):
        trained_model("resnet", device="cpu")


def test_darknet_forward_and_activations_match_reference(ref):
    model, params, np_params, x, _ = ref
    net = DarkNetLike({k: torch.from_numpy(v) for k, v in np_params.items()},
                      device="cpu")
    np.testing.assert_allclose(net(torch.from_numpy(x)).numpy(),
                               np.asarray(model.forward(params, x)),
                               rtol=0, atol=1e-4)
    got = net.activations(torch.from_numpy(x[0]))
    want = model.activations(params, x[0])
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == [
        (64, 64, 3), (31, 31, 16), (14, 14, 32), (6, 6, 64), (512,)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4)


def test_darknet_layer_traffic_exact_on_reference_activations(ref,
                                                              monkeypatch):
    """Fed the reference's activations, the five layers' operand streams
    are exact: packets of 27, 144, 288, 576 and 512 values, the head's
    inputs the flattened NHWC block output."""
    model, params, np_params, x, jl = ref
    net = DarkNetLike({k: torch.from_numpy(v) for k, v in np_params.items()},
                      device="cpu")
    acts = [torch.from_numpy(np.array(a))
            for a in model.activations(params, x[0])]
    monkeypatch.setattr(net, "activations", lambda _x: acts)
    got = net.layer_traffic(torch.from_numpy(x[0]))
    assert [tuple(g.inputs.shape) for g in got] == [
        (61504, 27), (26912, 144), (9216, 288), (2048, 576), (10, 512)]
    for g, w in zip(got, jl):
        np.testing.assert_array_equal(g.inputs.numpy(), np.asarray(w.inputs))
        np.testing.assert_array_equal(g.weights.numpy(),
                                      np.asarray(w.weights))
    # C6 on conv1 (Cin = 16): the second weight column is channel 1 at
    # (0, 0), the second patch column channel 0 at (0, 1).
    a1 = acts[1].numpy()
    assert got[1].weights[0, 1].item() == np_params["c1w"][0, 0, 1, 0]
    assert got[1].inputs[0, 1].item() == a1[0, 1, 0]
    assert got[1].inputs[0, 9].item() == a1[0, 0, 1]


def test_darknet_sweep_rows_match_reference(ref):
    """4x4_mc2, 3 packets a layer, both precisions, pattern, O0/O1/O2:
    every key and value of every row, in order."""
    *_, jl = ref
    axes = dict(meshes=("4x4_mc2",), transforms=("O0", "O1", "O2"),
                tiebreaks=("pattern",), precisions=("float32", "fixed8"),
                models=("darknet",), max_packets_per_layer=3, chunk=256)
    want = jrun_sweep(JGrid(**axes, backend="fused"), lambda _name: jl,
                      devices=None)
    layers = [traffic.LayerTraffic(torch.from_numpy(np.array(lt.inputs)),
                                   torch.from_numpy(np.array(lt.weights)))
              for lt in jl]
    got = run_sweep(SweepGrid(**axes, device="cpu"), lambda _name: layers)
    assert len(got.rows) == len(want.rows) == 6
    for g, w in zip(got.rows, want.rows):
        assert list(g) == list(w)
        assert g == w
    assert got.stats["stepped_cycles"] == want.stats["stepped_cycles"]
