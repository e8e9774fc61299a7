"""Port parity: the training half of the LM stack (``repro_torch.train``:
the train step, checkpoints; ``repro_torch.data.TokenStream``;
``repro_torch.launch.train``; ``tree.leaves_with_path``) against live
``repro`` on the same numpy inputs.

A train step is held on the reference's own parameters (``init_params``,
bf16, carried across with ``lm_params_from_jax``) and tokens from a numpy
seed. Every bf16 matmul rounds a float32 sum in its own order on each side
(ROADMAP C19), so the loss, the grad norm, each gradient leaf and the
updated tree are held to relative errors of about three times the CPU's
reading a model (``TOLS``); elements are not held one by one: Adam's first
step moves every element by about +-lr whatever its gradient's size, so a
near-zero gradient that rounds to the other sign moves its element by
2 lr. Planted faults (a block's gradients zeroed, the MoE aux term
dropped) read 100 % on the gradient leaves they touch.

Checkpoints are held exactly: either package restores the other's files,
bf16 leaves included.
"""
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import TokenStream as JTokenStream  # noqa: E402
from repro.models import LM as JLM, LMConfig as JLMConfig  # noqa: E402
from repro.models.spec import init_params as jinit  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import constant as jconstant  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.data import TokenStream, zipf_tokens  # noqa: E402
from repro_torch.dist import gradient_wire_report  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import LM, LMConfig, lm_params_from_jax  # noqa: E402
from repro_torch.optim import AdamW, constant, wsd  # noqa: E402
from repro_torch.train import (checkpoint, init_state,  # noqa: E402
                               make_train_step, value_and_grad)

from test_torch_traffic import one_torch_thread  # noqa: E402,F401

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256)
# model -> (loss, grad norm, gradient leaf, updated tree): relative errors,
# about 3x the CPU's readings (loss 1.0e-5, grad norm 2.9e-4, gradient
# leaves 1.24 / 1.20 / 2.09 %, updated tree 0.11 / 0.16 / 0.39 %).
TOLS = {"tiny": (3e-5, 1e-3, 0.035, 0.003),
        "xlstm-125m": (3e-5, 1e-3, 0.035, 0.0045),
        "mixtral-8x7b": (3e-5, 1e-3, 0.05, 0.01)}


@functools.lru_cache(maxsize=None)
def _models(name):
    """(reference model, reference params, port model, port params)."""
    if name == "tiny":
        jm, m = JLM(JLMConfig("t", **TINY)), LM(LMConfig("t", **TINY))
    else:
        jm = jconfigs.get(name).build_reduced()
        m = configs.get(name).build_reduced()
    jp = jax.jit(lambda k: jinit(jm.specs(), k))(jax.random.PRNGKey(0))
    return jm, jp, m, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                         device="cpu")


@functools.lru_cache(maxsize=None)
def _jgrads(name):
    """The reference's gradients of model ``name`` on ``_batch``."""
    jm, jp, m, _ = _models(name)
    jb, _ = _batch(m.cfg.vocab)
    return jax.jit(jax.value_and_grad(_jloss(jm)))(jp, jb)[1]


def _batch(vocab, b=8, s=32, seed=3):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(
        np.int32)
    jb = (jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]),
          jnp.ones((b, s), jnp.float32))
    tb = (torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:]),
          torch.ones((b, s)))
    return jb, tb


def _jloss(model):
    def f(p, batch):
        toks, tgt, mask = batch
        return model.loss(p, toks, tgt, mask)
    return f


def _loss(model):
    return lambda p, batch: model.loss(p, *batch)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _grad_errs(grads, jgrads) -> list:
    return [_rel(_np(a), _np(b)) for a, b in zip(tree.leaves(grads),
                                                 jax.tree.leaves(jgrads))]


def _tree_err(params, jparams) -> float:
    cat = lambda xs: np.concatenate([_np(x).ravel() for x in xs])  # noqa
    return _rel(cat(tree.leaves(params)), cat(jax.tree.leaves(jparams)))


def _jstate_keys(state) -> list:
    return sorted(jckpt._flatten(state))


# ---------------------------------------------------------------------------
# Trees, tokens
# ---------------------------------------------------------------------------

def test_leaves_with_path_gives_the_reference_checkpoint_keys():
    """Dict keys sorted, list / tuple indices (a dropped None keeps its
    index), NamedTuple fields as ``.name``: the keys of an fp32 and an int8
    TrainState equal the reference checkpoint's."""
    arrays = {"b": {"w": np.ones((2, 300), np.float32)},
              "a": [np.ones(3, np.float32), None,
                    (np.zeros(2, np.float32),)]}
    jp = jax.tree.map(jnp.asarray, arrays)
    p = tree.map_leaves(torch.from_numpy, arrays)
    for sd in ("fp32", "int8"):
        jst = jinit_state(jp, JAdamW(jconstant(1e-3), state_dtype=sd))
        st = init_state(p, AdamW(constant(1e-3), state_dtype=sd))
        keys = [k for k, _ in tree.leaves_with_path(st)]
        assert sorted(keys) == _jstate_keys(jst)
        assert keys == [
            "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                     for q in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(jst)[0]]
        assert ".opt/.step" in keys and ".params/a/2/0" in keys
        if sd == "int8":
            assert ".opt/.m/b/w/.q" in keys and ".opt/.v/b/w/.scale" in keys


def test_zipf_transform_on_the_reference_uniforms():
    """The reference's own uniforms (4 steps of 64 x 1,025 at vocab
    50,304) through the port's transform: at most 1e-4 of the tokens
    differ (float32 exp / log at integer boundaries; 12 read), each by one
    rank."""
    js = JTokenStream(vocab=50304, seq_len=1024, global_batch=64, seed=0)
    differ = total = 0
    for step in range(4):
        key = jax.random.fold_in(jax.random.PRNGKey(0), step)
        u = jax.random.uniform(key, (64, 1025), minval=1e-6)
        toks, tgt, _ = js.batch(step)
        want = np.concatenate([np.asarray(toks), np.asarray(tgt)[:, -1:]], 1)
        got = zipf_tokens(torch.from_numpy(np.array(u)), 50304).numpy()
        assert got.dtype == np.int32
        diff = got.astype(np.int64) - want
        assert np.abs(diff).max() <= 1
        differ += int((diff != 0).sum())
        total += diff.size
    assert differ <= 1e-4 * total


def test_zipf_transform_clamps_like_the_reference():
    """Uniforms at the floor make ranks past the int32 range: the
    reference's cast saturates and the clip keeps the last token."""
    u = np.array([[1e-6, 0.5, 0.999999, 1e-3]], np.float32)
    want = np.asarray(jnp.clip(jnp.exp(jnp.log(jnp.asarray(u)) * -5.0)
                               .astype(jnp.int32) - 1, 0, 999))
    got = zipf_tokens(torch.from_numpy(u), 1000).numpy()
    assert np.array_equal(got, want) and got[0, 0] == 999


def test_token_stream_is_a_function_of_seed_and_step(one_torch_thread):
    """Shards are row slices of one global batch whatever their count,
    regenerated identically; another step or seed gives other tokens;
    targets are the tokens shifted by one."""
    stream = TokenStream(vocab=1000, seq_len=16, global_batch=8, seed=3)
    toks, tgt, mask = stream.batch(5, device="cpu")
    assert toks.dtype == torch.int32 and mask.dtype == torch.float32
    assert toks.shape == (8, 16) and bool((mask == 1).all())
    assert torch.equal(toks[:, 1:], tgt[:, :-1])
    assert int(toks.min()) >= 0 and int(toks.max()) < 1000
    for n in (1, 2, 4, 8):
        parts = [stream.batch(5, i, n, device="cpu") for i in range(n)]
        assert torch.equal(torch.cat([p[0] for p in parts]), toks)
        assert torch.equal(torch.cat([p[1] for p in parts]), tgt)
    again = TokenStream(vocab=1000, seq_len=16, global_batch=8, seed=3)
    assert torch.equal(again.batch(5, 2, 4, device="cpu")[0], toks[4:6])
    assert not torch.equal(stream.batch(6, device="cpu")[0], toks)
    assert not torch.equal(TokenStream(1000, 16, 8, seed=4).batch(
        5, device="cpu")[0], toks)
    with pytest.raises(ValueError):
        stream.batch(0, 0, 3, device="cpu")


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,microbatches", [
    ("tiny", 1), ("tiny", 4), ("xlstm-125m", 1), ("mixtral-8x7b", 1)])
def test_train_step_matches_the_reference(name, microbatches,
                                          one_torch_thread):
    """One make_train_step step (clip, AdamW) from the reference's
    parameters on the same batch: loss, grad norm and lr, each gradient
    leaf (against ``jax.value_and_grad``) and the updated tree within
    TOLS; a dense GQA model (with 4 microbatches, whose gradients stay
    float32), reduced xlstm and reduced mixtral."""
    jm, jp, m, p = _models(name)
    jb, tb = _batch(m.cfg.vocab)
    loss_tol, gnorm_tol, grad_tol, tree_tol = TOLS[name]
    jopt, opt = JAdamW(jconstant(1e-3)), AdamW(constant(1e-3))
    jst, jmet = jax.jit(jmake_train_step(
        _jloss(jm), jopt, microbatches=microbatches))(jinit_state(jp, jopt),
                                                      jb)
    st, met = make_train_step(_loss(m), opt, microbatches=microbatches)(
        init_state(p, opt), tb)
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= loss_tol * abs(
        float(jmet["loss"]))
    assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) <= \
        gnorm_tol * float(jmet["grad_norm"])
    assert float(met["lr"]) == float(jmet["lr"])
    assert _tree_err(st.params, jst.params) <= tree_tol
    assert int(st.opt.step) == int(jst.opt.step) == 1
    assert [x.dtype for x in tree.leaves(st.params)] == [
        x.dtype for x in tree.leaves(p)]
    if microbatches == 1:
        loss, g = value_and_grad(_loss(m), p, tb)
        assert [x.dtype for x in tree.leaves(g)] == [
            x.dtype for x in tree.leaves(p)]
        assert max(_grad_errs(g, _jgrads(name))) <= grad_tol


def test_microbatched_grads_stay_float32(one_torch_thread):
    """With microbatches the accumulated gradients reach the clip and the
    update in float32, as the reference leaves them: the wire report sees
    float32 gradients of bf16 parameters."""
    _, _, m, p = _models("tiny")
    _, tb = _batch(m.cfg.vocab)
    seen = {}
    opt = AdamW(constant(1e-3))
    real = opt.update

    class Spy(AdamW):
        def update(self, grads, state, params):
            seen["dtypes"] = {x.dtype for x in tree.leaves(grads)}
            return real(grads, state, params)

    spy = Spy(constant(1e-3))
    make_train_step(_loss(m), spy, microbatches=4)(init_state(p, spy), tb)
    assert seen["dtypes"] == {torch.float32}
    make_train_step(_loss(m), spy)(init_state(p, spy), tb)
    assert torch.bfloat16 in seen["dtypes"]


@pytest.mark.parametrize("fault", ["block-grads-zeroed", "moe-aux-dropped"])
def test_planted_faults_fail_the_tolerance(fault, one_torch_thread):
    """A loss whose first block gets no gradient, or that drops the MoE
    aux term, reads far beyond the gradient tolerance (100 % read)."""
    _, _, m, p = _models("mixtral-8x7b")
    _, tb = _batch(m.cfg.vocab)

    def zeroed(params, batch):
        blocks = dict(params["blocks"])
        first = sorted(blocks)[0]
        blocks[first] = tree.map_leaves(lambda x: x.detach(), blocks[first])
        return m.loss({**params, "blocks": blocks}, *batch)

    def no_aux(params, batch):
        toks, tgt, mask = batch
        logits, _ = m.forward(params, toks)
        gold = torch.take_along_dim(logits, tgt[..., None].long(), -1)[..., 0]
        return ((torch.logsumexp(logits, -1) - gold) * mask).sum() / \
            mask.sum()

    _, g = value_and_grad(zeroed if fault == "block-grads-zeroed" else no_aux,
                          p, tb)
    assert max(_grad_errs(g, _jgrads("mixtral-8x7b"))) > \
        10 * TOLS["mixtral-8x7b"][2]


def test_cuda_graph_step_takes_cuda_tensors_only(one_torch_thread):
    """The step is captured into a CUDA graph on CUDA tensors only: given
    CPU tensors it captures nothing and runs its eager ``core``, with the
    wire report of the clipped gradients beside."""
    _, _, m, p = _models("tiny")
    _, tb = _batch(m.cfg.vocab)
    opt = AdamW(constant(1e-3))
    step = make_train_step(_loss(m), opt, wire_telemetry=True)
    st = init_state(p, opt)
    got, met = step(st, tb)
    assert step.graph is None and step.capture_s is None
    want, want_met, grads = step.core(st, tb)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(got),
                                                 tree.leaves(want)))
    for k in ("loss", "grad_norm", "lr"):
        assert torch.equal(met[k], want_met[k])
    assert {k: float(v) for k, v in met["wire"].items()} == {
        k: float(v) for k, v in gradient_wire_report(grads, p).items()}


def test_port_loss_decreases(one_torch_thread):
    """The port trains: 25 steps of the tiny LM under WSD on TokenStream
    batches lower the loss by more than 0.5 (the reference's
    test_loss_decreases, on the port's own stream)."""
    _, _, m, p = _models("tiny")
    stream = TokenStream(vocab=256, seq_len=32, global_batch=8)
    opt = AdamW(wsd(3e-3, 100, warmup=5))
    step = make_train_step(_loss(m), opt)
    state = init_state(p, opt)
    losses = []
    for i in range(25):
        state, met = step(state, stream.batch(i, device="cpu"))
        losses.append(float(met["loss"]))
    assert losses[-1] < losses[0] - 0.5


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _port_state(p, sd):
    """A port TrainState one step in, so every leaf is nontrivial."""
    m = _models("tiny")[2]
    _, tb = _batch(m.cfg.vocab)
    opt = AdamW(constant(1e-3), state_dtype=sd)
    return make_train_step(_loss(m), opt)(init_state(p, opt), tb)[0]


def test_checkpoint_written_by_the_reference_restores_in_the_port(
        tmp_path, one_torch_thread):
    """The reference's files (``|V2`` bf16 bytes, ``.name`` keys) into the
    port's tree: every leaf bit for bit, in its dtype."""
    _, jp, _, p = _models("tiny")
    rng = np.random.default_rng(6)
    jg = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape),
                                            x.dtype), jp)
    for sd in ("fp32", "int8"):
        jopt = JAdamW(jconstant(1e-3), state_dtype=sd)
        st0 = jinit_state(jp, jopt)
        jst = type(st0)(*jax.jit(jopt.update)(jg, st0.opt, jp))
        d = str(tmp_path / sd)
        jckpt.save(d, 7, jst)
        with open(os.path.join(d, "step_000000007", "manifest.json")) as f:
            assert json.load(f)["dtypes"][".params/embed"] == "bfloat16"
        like = init_state(p, AdamW(constant(1e-3), state_dtype=sd))
        step, got = checkpoint.restore(d, like)
        assert step == 7
        for a, b in zip(tree.leaves(got), jax.tree.leaves(jst)):
            want = np.asarray(b)
            if want.dtype.name == "bfloat16":
                assert a.dtype == torch.bfloat16
                assert np.array_equal(a.view(torch.int16).numpy(),
                                      want.view(np.int16))
            else:
                assert np.array_equal(a.numpy(), want)


@pytest.mark.parametrize("sd", ["fp32", "int8"])
def test_checkpoint_written_by_the_port_restores_in_the_reference(
        sd, tmp_path, one_torch_thread):
    jm, jp, m, p = _models("tiny")
    st = _port_state(p, sd)
    d = str(tmp_path)
    checkpoint.save(d, 3, st)
    jlike = jinit_state(jp, JAdamW(jconstant(1e-3), state_dtype=sd))
    step, got = jckpt.restore(d, jlike)
    assert step == 3
    for a, b in zip(tree.leaves(st), jax.tree.leaves(got)):
        b = np.asarray(b)
        if a.dtype == torch.bfloat16:
            assert b.dtype.name == "bfloat16"
            assert np.array_equal(a.view(torch.int16).numpy(),
                                  b.view(np.int16))
        else:
            assert np.array_equal(a.numpy(), b)
    # and back into the port
    step, again = checkpoint.restore(d, init_state(p, AdamW(
        constant(1e-3), state_dtype=sd)))
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(st),
                                                 tree.leaves(again)))


def test_checkpoint_skips_torn_writes_and_keeps_the_newest(
        tmp_path, one_torch_thread):
    """A torn newest checkpoint is skipped for the next intact one; the
    keep policy leaves the newest ``keep``; restore rebuilds the tree in
    ``tree_like``'s dtypes."""
    _, _, _, p = _models("tiny")
    st = _port_state(p, "fp32")
    d = str(tmp_path / "torn")
    checkpoint.save(d, 3, st)
    checkpoint.save(d, 9, st)
    os.makedirs(os.path.join(d, "step_000000012"))
    with open(os.path.join(d, "step_000000012", "manifest.json"), "w") as f:
        f.write("{torn!")
    step, got = checkpoint.restore(d, st)
    assert step == 9
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(st),
                                                 tree.leaves(got)))
    assert checkpoint.latest_step(d) == 12
    assert checkpoint.restore(str(tmp_path / "none"), st) is None
    d2 = str(tmp_path / "keep")
    for s in (1, 2, 3, 4):
        checkpoint.save(d2, s, {"w": torch.ones(2)}, keep=2)
    kept = sorted(x for x in os.listdir(d2) if x.startswith("step_"))
    assert kept == ["step_000000003", "step_000000004"]
    step, got = checkpoint.restore(d2, {"w": torch.zeros(2,
                                                         dtype=torch.bfloat16)})
    assert step == 4 and got["w"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_and_resumes_from_its_checkpoint(tmp_path, capsys,
                                                         one_torch_thread):
    """``launch.train.main`` on the CPU with wire telemetry and checkpoints,
    then a longer run that restores the newest one and trains on."""
    d = str(tmp_path / "ckpt")
    argv = ["--arch", "xlstm-125m", "--device", "cpu", "--reduced",
            "--seq", "16", "--batch", "2", "--ckpt", d, "--ckpt-every", "2",
            "--wire-telemetry"]
    run = launch_train.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "| wire-BT O1" in out and out.strip().endswith("done")
    assert run["start"] == 0 and len(run["step_s"]) == 3
    assert sorted(os.listdir(d)) == ["step_000000002", "step_000000003"]
    wire = run["metrics"][-1]["wire"]
    assert wire["bt_baseline"] > 0 and 0 <= wire["bt_o1"] < 2**31
    run2 = launch_train.main(argv + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "restored checkpoint at step 3" in out
    assert run2["start"] == 3 and len(run2["step_s"]) == 1
    assert int(run2["state"].opt.step) == 4


def test_launcher_loss_fns_stub_frames_and_patches(one_torch_thread):
    """The enc-dec loss feeds one-hot frames of the tokens, the VLM loss
    zero patch embeddings, as the reference's launcher does; the schedule
    is WSD for minicpm and the moments int8 for kimi-k2."""
    from repro_torch.models import init_params
    for name in ("whisper-medium", "internvl2-1b"):
        arch = configs.get(name)
        model = arch.build_reduced()
        params = init_params(model.specs(), torch.Generator().manual_seed(0),
                             "cpu")
        _, tb = _batch(model.cfg.vocab, b=2, s=8)
        loss = launch_train.loss_fn_for(arch, model)(params, tb)
        assert loss.shape == () and torch.isfinite(loss)
    assert launch_train.optimizer_for(configs.get("kimi-k2-1t-a32b"), 1e-3,
                                      10).state_dtype == "int8"
    minicpm = launch_train.optimizer_for(configs.get("minicpm-2b"), 1e-3, 100)
    assert float(minicpm.lr_fn(95)) == float(wsd(1e-3, 100)(95))
