"""Port parity: ``repro_torch.dist`` (ordered gradient buckets, the
gradient wire report, bucketing, static popcount layouts) and the models'
loss against live ``repro`` on the same numpy trees.

* ``order_gradient_bucket`` / ``restore_gradient_bucket`` on a ragged tree
  (no length divides the window, a bf16 leaf) and with ``window=None``:
  values and perm equal to the reference's, round trips bit-identical;
* ``gradient_wire_report`` equal in every key at windows 256, 4,096 and
  None (BT totals int32, ``bt_per_flit_baseline`` and the reductions
  float32, both divided in float32 as the reference does): on the trained
  LeNet's parameters with the reference's ``jax.grad`` of LeNet's loss on
  four glyph images, and on a two-layer LM tree (d_model 64, d_ff 128, bf16
  leaves) with seeded bf16 stand-in gradients;
* the flatten order: dict keys sorted (a dict built with unsorted keys),
  lists and tuples in order, None dropped - ``jax.tree.leaves``' order;
  ``tree.from_numpy`` keeps dtypes, bf16 included; the float32 -> bf16
  cast rounds to nearest even at ties, as XLA's does;
* ``bucketed`` / ``unbucket``: the same buckets, the same errors;
* ``mlp_unit_permutation``, ``reorder_mlp`` (gated, ungated, scan-stacked,
  MoE with a router) and ``reorder_lm_params`` equal to the reference's
  arrays exactly; ``stream_bt_report`` on the trained LeNet's fc1 block
  (``benchmarks/static_layout.py``) equal to the reference's, and to
  BENCH_noc.json's ``suites.static_layout.trained``;
* LeNet's logits with fc1 reordered within rtol 1e-5 / atol 1e-6 of the
  reference's unordered logits (the permuted contraction sums in another
  order, ROADMAP C3);
* ``loss`` and ``grads`` of the trained LeNet and DarkNet against the
  reference's ``loss`` and ``jax.grad``: the loss within 1e-6 relative,
  each gradient within 1e-4 of its leaf's largest magnitude.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")

from repro.data import glyph_batch as jglyph  # noqa: E402
from repro.dist import ordered_collectives as joc  # noqa: E402
from repro.dist import overlap as jov  # noqa: E402
from repro.dist import static_reorder as jsr  # noqa: E402
from repro.models import DarkNetLike as JDarkNet, LeNet as JLeNet  # noqa: E402
from repro.models import LM, LMConfig, init_params  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.dist import ordered_collectives as oc  # noqa: E402
from repro_torch.dist import overlap as ov  # noqa: E402
from repro_torch.dist import static_reorder as sr  # noqa: E402
from repro_torch.models import trained_model  # noqa: E402

from test_torch_traffic import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOWS = (256, 4096, None)


def _same_bits(got: torch.Tensor, want) -> bool:
    """Equal bit patterns, bf16 included."""
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        want, got = want.view(np.int16), got.view(torch.int16)
    return np.array_equal(got.cpu().numpy(), want)


def _t(tree_np):
    return tree.from_numpy(tree_np, device="cpu")


def _as_np(jtree):
    return jax.tree.map(np.asarray, jtree)


@pytest.fixture(scope="module")
def lenet():
    """The trained LeNet (port and reference share the checkpoint), four
    glyph images, and the reference's gradients of its loss."""
    tm = trained_model("lenet", device="cpu")
    jparams = {k: jnp.asarray(v.numpy()) for k, v in tm.params.items()}
    x, y = jglyph(jax.random.PRNGKey(7), 4)
    jgrads = jax.grad(JLeNet().loss)(jparams, x, y)
    return dict(model=tm.model, params=tm.params, jparams=jparams,
                x=np.array(x), y=np.array(y), jgrads=_as_np(jgrads))


@pytest.fixture(scope="module")
def lm():
    """A two-layer LM's parameters (bf16, scan-stacked blocks) and seeded
    bf16 stand-in gradients of the same structure."""
    cfg = LMConfig("t", n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                   vocab=256)
    params = init_params(LM(cfg).specs(), jax.random.PRNGKey(0))
    flat, treedef = jax.tree.flatten(params)
    grads = treedef.unflatten([
        (1e-3 * jax.random.normal(jax.random.PRNGKey(100 + i), x.shape))
        .astype(x.dtype) for i, x in enumerate(flat)])
    return _as_np(params), _as_np(grads)


def _ragged():
    key = jax.random.PRNGKey(0)
    g = {"a": jax.random.normal(key, (37, 5)),
         "b": {"c": jax.random.normal(jax.random.fold_in(key, 1), (13,))
               .astype(jnp.bfloat16),
               "d": jax.random.normal(jax.random.fold_in(key, 2), (3, 7, 2))}}
    w = jax.tree.map(lambda v: jax.random.normal(
        jax.random.fold_in(key, v.size), v.shape).astype(v.dtype), g)
    return _as_np(g), _as_np(w)


@pytest.mark.parametrize("window", [64, None])
def test_ordered_bucket_equals_reference_and_round_trips(window):
    g, w = _ragged()
    for gl, wl in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
        want = joc.order_gradient_bucket(jnp.asarray(gl).reshape(-1),
                                         jnp.asarray(wl).reshape(-1),
                                         window=window)
        tg, tw = _t(gl), _t(wl)
        got = oc.order_gradient_bucket(tg.reshape(-1), tw.reshape(-1),
                                       window=window)
        assert _same_bits(got.values, want.values)
        np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
        back = oc.restore_gradient_bucket(got, gl.size)
        assert back.dtype == tg.dtype and _same_bits(back, gl.reshape(-1))


def _assert_report_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in ("bt_baseline", "bt_o1", "bt_o2"):
        assert got[k].dtype == torch.int32
        assert int(got[k]) == int(want[k]), k
    for k in ("bt_per_flit_baseline", "reduction_o1", "reduction_o2"):
        assert got[k].dtype == torch.float32
        assert np.float32(got[k].item()) == np.float32(want[k]), k
    assert got["o2_index_bits"] == want["o2_index_bits"]


@pytest.mark.parametrize("window", WINDOWS)
def test_gradient_wire_report_lenet_equals_reference(lenet, window):
    want = joc.gradient_wire_report(lenet["jgrads"], lenet["jparams"],
                                    window=window)
    got = oc.gradient_wire_report(_t(lenet["jgrads"]), lenet["params"],
                                  window=window)
    _assert_report_equal(got, want)


@pytest.mark.parametrize("window", WINDOWS)
def test_gradient_wire_report_lm_equals_reference(lm, window):
    params, grads = lm
    want = joc.gradient_wire_report(grads, params, window=window)
    got = oc.gradient_wire_report(_t(grads), _t(params), window=window)
    _assert_report_equal(got, want)


def test_flatten_order_and_from_numpy():
    rng = np.random.default_rng(0)
    a, b, c, d = (rng.standard_normal(n).astype(np.float32)
                  for n in (2, 3, 4, 5))
    nested = {"z": [a, None, (b, c)], "b": {"y": d, "x": a}, "a": c}
    assert list(nested) == ["z", "b", "a"]        # built unsorted
    want = [x.tolist() for x in jax.tree.leaves(nested)]
    got = tree.from_numpy(nested, device="cpu")
    assert [x.tolist() for x in tree.leaves(got)] == want
    assert list(got) == ["z", "b", "a"] and got["z"][1] is None
    assert isinstance(got["z"][2], tuple)
    back = tree.unflatten(nested, tree.leaves(got))
    assert [x.tolist() for x in tree.leaves(back)] == want
    with pytest.raises(ValueError):
        tree.unflatten(nested, tree.leaves(got)[:-1])
    bf = np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
    t = tree.from_numpy({"w": bf}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16 and _same_bits(t, bf)


def test_bf16_cast_rounds_like_xla_at_ties():
    """float32 -> bf16 on values at and beside the rounding ties (low 16
    bits 0x8000 with even and odd kept mantissas, 0x7FFF, 0x8001), signs
    and a carry into the exponent."""
    hi = np.array([0x3F80, 0x3F81, 0xBF80, 0xBF81, 0x3FFF, 0x7F7F, 0x0001],
                  np.uint32)
    lo = np.array([0x8000, 0x7FFF, 0x8001, 0x0000], np.uint32)
    bits = (hi[:, None] << 16 | lo[None, :]).reshape(-1)
    x = bits.view(np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.int16)
    got = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(got, want)


def test_bucketed_and_unbucket_equal_reference():
    rng = np.random.default_rng(1)
    t = {"d": rng.standard_normal(1000).astype(np.float32),
         "a": rng.standard_normal((100, 100)).astype(np.float32),
         "c": [rng.standard_normal(1000).astype(np.float32),
               rng.standard_normal(10).astype(np.float16)],
         "b": rng.standard_normal(1000).astype(np.float32)}
    tt = _t(t)
    for cap in (10_000, 4_000, 1 << 20, 1):
        want = jov.bucketed(t, max_bytes=cap)
        got = ov.bucketed(tt, max_bytes=cap)
        assert [[x.shape for x in b] for b in want] == \
            [[tuple(x.shape) for x in b] for b in got]
        back = ov.unbucket(got, tt)
        assert all(torch.equal(x, y) for x, y in
                   zip(tree.leaves(back), tree.leaves(tt)))
        assert list(back) == list(tt)
    for bad in (0, -5):
        with pytest.raises(ValueError) as mine:
            ov.bucketed(tt, bad)
        with pytest.raises(ValueError) as theirs:
            jov.bucketed(t, bad)
        assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError) as mine:
        ov.unbucket(ov.bucketed(tt, 1 << 20)[:0], tt)
    with pytest.raises(ValueError) as theirs:
        jov.unbucket(jov.bucketed(t, 1 << 20)[:0], t)
    assert str(mine.value) == str(theirs.value)


def _mlps():
    k = jax.random.PRNGKey(3)
    def n(i, shape):
        return jax.random.normal(jax.random.fold_in(k, i), shape)

    return {
        "gated": {"wu": n(0, (16, 32)), "wg": n(1, (16, 32)),
                  "wd": n(2, (32, 16))},
        "ungated": {"wu": n(3, (16, 32)), "wd": n(4, (32, 16))},
        "scan": {"wu": n(5, (3, 16, 32)).astype(jnp.bfloat16),
                 "wg": n(6, (3, 16, 32)).astype(jnp.bfloat16),
                 "wd": n(7, (3, 32, 16)).astype(jnp.bfloat16)},
        "moe": {"wu": n(8, (2, 3, 16, 24)), "wd": n(9, (2, 3, 24, 16)),
                "router": n(10, (2, 16, 3))},
    }


@pytest.mark.parametrize("kind", ["gated", "ungated", "scan", "moe"])
def test_reorder_mlp_equals_reference(kind):
    p = _as_np(_mlps()[kind])
    want_new, want_perm = jsr.reorder_mlp(p)
    got_new, got_perm = sr.reorder_mlp(_t(p))
    np.testing.assert_array_equal(got_perm.numpy(), np.asarray(want_perm))
    assert set(got_new) == set(want_new)
    for key in want_new:
        assert _same_bits(got_new[key], want_new[key]), key
    np.testing.assert_array_equal(
        sr.mlp_unit_permutation(_t(p)["wu"]).numpy(),
        np.asarray(jsr.mlp_unit_permutation(p["wu"])))


def test_reorder_lm_params_and_stream_report_equal_reference(lm):
    params, _ = lm
    want = jsr.reorder_lm_params(params)
    got = sr.reorder_lm_params(_t(params))
    wl, gl = jax.tree.leaves(want), tree.leaves(got)
    assert len(wl) == len(gl)
    assert all(_same_bits(g, w) for g, w in zip(gl, wl))
    rep = sr.stream_bt_report(_t(params), got)
    jrep = jsr.stream_bt_report(params, want)
    assert set(rep) == set(jrep)
    for k in jrep:
        assert np.float32(rep[k].item()) == np.float32(jrep[k]), k
    with pytest.raises(ValueError, match="no MLP blocks"):
        sr.stream_bt_report({"embed": _t(params)["embed"]},
                            {"embed": _t(params)["embed"]})


def test_static_layout_on_trained_lenet_meets_record(lenet):
    """benchmarks/static_layout.py's fc1 block: f1w (400, 120) columns with
    f2w (120, 84) rows; the trained figures are BENCH_noc.json's."""
    blocks = {"fc1": {"wu": lenet["params"]["f1w"],
                      "wd": lenet["params"]["f2w"]}}
    got = sr.stream_bt_report(blocks, sr.reorder_lm_params(blocks))
    jblocks = {"fc1": {"wu": lenet["jparams"]["f1w"],
                       "wd": lenet["jparams"]["f2w"]}}
    want = jsr.stream_bt_report(jblocks, jsr.reorder_lm_params(jblocks))
    with open(os.path.join(REPO, "BENCH_noc.json")) as f:
        record = json.load(f)["suites"]["static_layout"]["trained"]
    for k in want:
        assert np.float32(got[k].item()) == np.float32(want[k]), k
        assert float(got[k]) == record[k], k


def test_lenet_logits_with_fc1_reordered(lenet):
    """Permuting f1w's columns, f1b and f2w's rows together keeps the
    function; the contraction sums in another order (ROADMAP C3)."""
    p = dict(lenet["params"])
    new, perm = sr.reorder_mlp({"wu": p["f1w"], "wd": p["f2w"]})
    p.update(f1w=new["wu"], f2w=new["wd"], f1b=p["f1b"][perm])
    net = type(lenet["model"])(p, device="cpu")
    got = net(torch.from_numpy(lenet["x"])).numpy()
    want = np.asarray(JLeNet().forward(lenet["jparams"], lenet["x"]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["lenet", "darknet"])
def test_loss_and_grads_match_reference(name):
    tm = trained_model(name, device="cpu")
    jmodel = JLeNet() if name == "lenet" else JDarkNet()
    hw, _, ch = tm.input_shape
    x, y = jglyph(jax.random.PRNGKey(7), 4, hw=hw, channels=ch)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in tm.params.items()}
    xt, yt = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(y))
    want = float(jmodel.loss(jparams, x, y))
    got = float(tm.model.loss(xt, yt))
    assert abs(got - want) <= 1e-6 * max(abs(want), 1e-30)
    jg = jax.grad(jmodel.loss)(jparams, x, y)
    g = tm.model.grads(xt, yt)
    assert set(g) == set(jg)
    for k in jg:
        w = np.asarray(jg[k])
        assert g[k].shape == w.shape
        assert np.abs(g[k].numpy() - w).max() <= 1e-4 * np.abs(w).max(), k
