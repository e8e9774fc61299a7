"""Port parity: the LM and enc-dec models, the ten architecture configs
and the static popcount layout of an LM (``repro_torch.models``,
``repro_torch.configs``, ``repro_torch.dist.static_reorder``) against live
``repro`` on the same parameters and tokens.

Parameters are the reference's own ``init_params`` (bf16, scan-stacked)
carried across with ``lm_params_from_jax``; tokens and frames come from
numpy seeds. Every matmul of the stack rounds a float32 sum to bf16, in
torch's summation order on one side and XLA's on the other, and those
one-unit differences pass through every later layer: logits are held to
``tol * max|want|``. Each block family's reduced arch has its own ``tol``
in ``FAMILY_TOL``, about 2.5 times the largest error it reads on the CPU
(h2o-danube 1.06 %, mixtral 0.60 %, xlstm 0.69 %, internvl2 1.01 %), and
never above ``LOGIT_TOL`` (5 %), which recurrentgemma needs (4.45 %: its
gates raise the recurrence's weight to the 8th power); the other models
are held to ``LOGIT_TOL``. ``test_planted_faults_fail_the_tolerance`` shows
that a wrong composition reads far above these (35-102 %). The greedy
token is held where the reference's top-2 margin exceeds the tolerance.
Integer outputs - the static layout's permutations, reordered bf16 trees
and stream reports - are held exactly.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import common as jcommon  # noqa: E402
from repro.dist import sharding as jsharding  # noqa: E402
from repro.core.bt import bt_stream  # noqa: E402
from repro.core.flits import pack  # noqa: E402
from repro.dist import static_reorder as jsr  # noqa: E402
from repro.models import LM as JLM, LMConfig as JLMConfig  # noqa: E402
from repro.models.spec import init_params as jinit  # noqa: E402
from repro.models.spec import param_count as jparam_count  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.core.bt import per_flit  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.dist import static_reorder as sr  # noqa: E402
from repro_torch.models import LM, LMConfig, lm_params_from_jax  # noqa: E402
from repro_torch.models.spec import param_count  # noqa: E402

from test_torch_traffic import one_torch_thread  # noqa: E402,F401

LOGIT_TOL = 0.05
FAMILY_TOL = {"h2o-danube-3-4b": 0.025, "mixtral-8x7b": 0.015,
              "recurrentgemma-9b": LOGIT_TOL, "xlstm-125m": 0.02,
              "internvl2-1b": 0.025}
FAMILIES = list(FAMILY_TOL)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol=LOGIT_TOL, vocab=None):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    if vocab is not None:
        got, want = got[..., :vocab], want[..., :vocab]
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)
    return tol * scale


def _same_argmax(got, want, atol, vocab):
    """Greedy tokens equal wherever the reference's top-2 margin is wider
    than the tolerance (a closer race may go either way)."""
    want = np.asarray(want, np.float32)[..., :vocab]
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * atol
    g = got.float().numpy()[..., :vocab].argmax(-1)
    np.testing.assert_array_equal(g[clear], want.argmax(-1)[clear])


@functools.lru_cache(maxsize=None)
def _reduced(name):
    """(reference model, reference params, port model, port params)."""
    jm = jconfigs.get(name).build_reduced()
    jp = jinit(jm.specs(), jax.random.PRNGKey(0))
    return jm, jp, configs.get(name).build_reduced(), lm_params_from_jax(
        jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("name", FAMILIES)
def test_reduced_lm_forward_prefill_decode(name):
    """Forward, prefill and three decode steps of each block family (dense
    + SWA, MoE + SWA, Griffin, xLSTM, VLM with stubbed patch embeddings)
    against the reference; then one decode step from the reference's own
    cache carried across (the cache layouts agree)."""
    jm, jp, m, p = _reduced(name)
    cfg = m.cfg
    tol = FAMILY_TOL[name]
    b, s = 2, 12
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (b, s + 3)).astype(np.int32)
    pe = jpe = None
    if cfg.vlm_prefix:
        pen = rng.standard_normal((b, cfg.vlm_prefix, cfg.d_model)).astype(
            np.float32)
        pe, jpe = torch.from_numpy(pen), jnp.asarray(pen)
    want, jaux = jax.jit(jm.forward)(jp, jnp.asarray(toks[:, :s]), jpe)
    got, aux = m.forward(p, _t(toks[:, :s]), pe)
    assert got.shape == want.shape
    _close(got, want, tol, vocab=cfg.vocab)
    assert abs(float(aux) - float(jaux)) <= 1e-3 * max(abs(float(jaux)), 1)

    jdec = jax.jit(jm.decode_step)
    jlg, jc = jax.jit(jm.prefill, static_argnums=2)(
        jp, jnp.asarray(toks[:, :s]), 32, jpe)
    lg, c = m.prefill(p, _t(toks[:, :s]), 32, pe)
    atol = _close(lg, jlg, tol, vocab=cfg.vocab)
    _same_argmax(lg, jlg, atol, cfg.vocab)
    off = s + cfg.vlm_prefix
    for i in range(3):
        pos = np.full((b,), off + i, np.int32)
        jlg, jc_next = jdec(jp, jnp.asarray(toks[:, s + i]), jc,
                            jnp.asarray(pos))
        lg, c = m.decode_step(p, _t(toks[:, s + i]), c, _t(pos))
        atol = _close(lg, jlg, tol, vocab=cfg.vocab)
        _same_argmax(lg, jlg, atol, cfg.vocab)
        if i == 2:
            carried = tree.from_numpy(jax.tree.map(np.asarray, jc),
                                      device="cpu")
            lg2, _ = m.decode_step(p, _t(toks[:, s + i]), carried, _t(pos))
            _close(lg2, jlg, tol, vocab=cfg.vocab)
        jc = jc_next


@pytest.mark.parametrize("kw", [
    dict(n_experts=4, top_k=2, moe_groups=2, tp_bf16_boundary=True),
    dict(kv_chunk=4, window=6, gated_mlp=False, rope_theta=5e5),
], ids=["moe_groups_bf16_boundary", "kv_chunk_swa_ungated"])
def test_lm_options_equal_reference(kw):
    """Options no arch config sets: MoE dispatch groups (the decode step's
    single token falls back to one group), the bf16 block boundary (an XLA
    barrier in the reference, a cast here), blockwise attention over key
    chunks, a sliding window, an ungated MLP and another RoPE base."""
    base = dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=96,
                vocab=300, tied_embeddings=False)
    jm = JLM(JLMConfig("t", **base, **kw))
    jp = jax.jit(functools.partial(jinit, jm.specs()))(jax.random.PRNGKey(3))
    m = LM(LMConfig("t", **base, **kw))
    p = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(6).integers(0, 300, (2, 12)).astype(np.int32)
    want, jaux = jax.jit(jm.forward)(jp, jnp.asarray(toks))
    got, aux = m.forward(p, _t(toks))
    _close(got, want, vocab=300)
    assert abs(float(aux) - float(jaux)) <= 1e-3 * max(abs(float(jaux)), 1)
    jlg, jc = jax.jit(jm.prefill, static_argnums=2)(
        jp, jnp.asarray(toks[:1, :8]), 16)
    lg, c = m.prefill(p, _t(toks[:1, :8]), 16)
    _close(lg, jlg, vocab=300)
    pos = np.full((1,), 8, np.int32)
    jlg, _ = jax.jit(jm.decode_step)(jp, jnp.asarray(toks[:1, 8]), jc,
                                     jnp.asarray(pos))
    lg, _ = m.decode_step(p, _t(toks[:1, 8]), c, _t(pos))
    _close(lg, jlg, vocab=300)


def test_reduced_encdec_forward_and_decode():
    jm, jp, m, p = _reduced("whisper-medium")
    cfg = m.cfg
    b = 2
    rng = np.random.default_rng(2)
    frames = rng.standard_normal((b, 10, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (b, 6)).astype(np.int32)
    _close(m.forward(p, _t(frames), _t(toks)),
           jax.jit(jm.forward)(jp, jnp.asarray(frames), jnp.asarray(toks)),
           vocab=cfg.vocab)
    jmem = jax.jit(jm.encode)(jp, jnp.asarray(frames))
    jdec = jax.jit(jm.decode_step)
    mem = m.encode(p, _t(frames))
    _close(mem, jmem)
    for with_params in (True, False):      # cached cross k/v, or recomputed
        jc = jm.init_cache(b, 16, jmem, jp if with_params else None)
        c = m.init_cache(b, 16, mem, p if with_params else None)
        for i in range(3):
            pos = np.full((b,), i, np.int32)
            jlg, jc = jdec(jp, jnp.asarray(toks[:, i]), jc, jnp.asarray(pos))
            lg, c = m.decode_step(p, _t(toks[:, i]), c, _t(pos))
            atol = _close(lg, jlg, vocab=cfg.vocab)
            _same_argmax(lg, jlg, atol, cfg.vocab)


def test_decode_leaves_the_callers_cache_alone():
    """Two decode steps from one cache give the same logits, and the
    cache's tensors are unchanged (``init_cache`` gives each group its own
    memory, and no mode writes in place)."""
    _, _, m, p = _reduced("h2o-danube-3-4b")
    toks = torch.arange(8, dtype=torch.int32).reshape(1, 8) + 3
    _, cache = m.prefill(p, toks, 24)
    before = [x.clone() for x in tree.leaves(cache)]
    pos = torch.tensor([8], dtype=torch.int32)
    tok = torch.tensor([5], dtype=torch.int32)
    a, _ = m.decode_step(p, tok, cache, pos)
    b, _ = m.decode_step(p, tok, cache, pos)
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(tree.leaves(cache), before))
    fresh = m.init_cache(1, 24, device="cpu")
    k = fresh["b0_attn"].k
    assert k.shape[0] == m.n_groups and k.stride(0) != 0


def test_swa_prefill_then_decode_consistency():
    """Decoding right after an SWA prefill that overflowed the window (24
    tokens, window 16) attends what a one-longer forward sees, and the
    port's step equals the reference's."""
    jm, jp, m, p = _reduced("h2o-danube-3-4b")
    cfg = m.cfg
    s = 24
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (1, s + 1)).astype(
        np.int32)
    _, cache = m.prefill(p, _t(toks[:, :s]), s)
    step, _ = m.decode_step(p, _t(toks[:, s]), cache,
                            torch.full((1,), s, dtype=torch.int32))
    full, _ = m.forward(p, _t(toks))
    assert int(step.argmax()) == int(full[:, s].argmax())
    tol = FAMILY_TOL["h2o-danube-3-4b"]
    _close(step, full[:, s].numpy(), tol, vocab=cfg.vocab)
    _, jc = jm.prefill(jp, jnp.asarray(toks[:, :s]), s)
    jstep, _ = jm.decode_step(jp, jnp.asarray(toks[:, s]), jc,
                              jnp.full((1,), s, jnp.int32))
    _close(step, jstep, tol, vocab=cfg.vocab)


@functools.lru_cache(maxsize=None)
def _past_window_reference():
    """(tokens, the reference's prefill and decode logits) for the reduced
    h2o-danube: a 20-token prefill at context 32 (ring of 16 = the window)
    and three decode steps, every one past the window."""
    jm, jp, m, _ = _reduced("h2o-danube-3-4b")
    toks = np.random.default_rng(4).integers(0, m.cfg.vocab, (2, 23)).astype(
        np.int32)
    jlg, jc = jax.jit(jm.prefill, static_argnums=2)(
        jp, jnp.asarray(toks[:, :20]), 32)
    out = [np.asarray(jlg, np.float32)]
    jdec = jax.jit(jm.decode_step)
    for i in range(3):
        jlg, jc = jdec(jp, jnp.asarray(toks[:, 20 + i]), jc,
                       jnp.full((2,), 20 + i, jnp.int32))
        out.append(np.asarray(jlg, np.float32))
    return toks, out


def _drop_cache_write(orig):
    def step(params, x, cfg, cache, pos):
        out, _ = orig(params, x, cfg, cache, pos)
        return out, cache              # the ring never takes the new k / v
    return step


def _window_one_short(orig):
    def step(params, x, cfg, cache, pos):
        return orig(params, x, cfg._replace(window=cfg.window - 1), cache,
                    pos)
    return step


@pytest.mark.parametrize("fault", [None, "window_one_short",
                                   "dropped_cache_write", "layer_skipped"])
def test_planted_faults_fail_the_tolerance(fault, monkeypatch):
    """The reduced h2o-danube's prefill and past-window decode logits
    against the reference: the port as it is stays within its family's
    tolerance (1.01 % read), and each planted composition fault reads more
    than twice the tolerance on some step - a decode window one short
    (35-77 % on the decode steps), a decode step whose new key never
    reaches the ring, so the next steps attend a stale slot (47-81 %), and
    the last layer skipped: its parameters zeroed, so the block adds
    nothing to the residual (73-102 %)."""
    from repro_torch.models import layers as L
    _, _, m, p = _reduced("h2o-danube-3-4b")
    vocab = m.cfg.vocab
    if fault == "window_one_short":
        monkeypatch.setattr(L, "attention_decode",
                            _window_one_short(L.attention_decode))
    elif fault == "dropped_cache_write":
        monkeypatch.setattr(L, "attention_decode",
                            _drop_cache_write(L.attention_decode))
    elif fault == "layer_skipped":
        def zero_last(x):
            x = x.clone()
            x[-1] = 0
            return x
        p = dict(p, blocks={k: tree.map_leaves(zero_last, v)
                            for k, v in p["blocks"].items()})
    toks, want = _past_window_reference()
    lg, c = m.prefill(p, _t(toks[:, :20]), 32)
    got = [lg]
    for i in range(3):
        lg, c = m.decode_step(p, _t(toks[:, 20 + i]), c,
                              torch.full((2,), 20 + i, dtype=torch.int32))
        got.append(lg)
    errs = [float(np.abs(g.float().numpy()[..., :vocab] - w[..., :vocab]).max()
                  / np.abs(w[..., :vocab]).max()) for g, w in zip(got, want)]
    tol = FAMILY_TOL["h2o-danube-3-4b"]
    if fault is None:
        assert max(errs) <= tol, errs
    else:
        assert max(errs) > 2 * tol, errs


def _spec_rows(specs, torch_side):
    is_spec = lambda s: hasattr(s, "axes")  # noqa: E731
    flat = tree.leaves(specs) if torch_side else jax.tree.leaves(
        specs, is_leaf=is_spec)
    return [(tuple(s.shape), tuple(s.axes),
             str(s.dtype).replace("torch.", "") if torch_side
             else str(jnp.dtype(s.dtype)), s.init, s.scale) for s in flat]


@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_arch_configs_equal_reference(name):
    """Every field of the full and reduced configs, the spec trees (shape,
    axes, dtype, init, scale of every leaf, in flattening order), the
    parameter count and the shape support, against the reference (specs
    only: nothing is allocated)."""
    ja, a = jconfigs.get(name), configs.get(name)
    assert (a.name, a.kind, a.optimizer_state, a.notes) == (
        ja.name, ja.kind, ja.optimizer_state, ja.notes)
    assert dict(a.rules) == dict(ja.rules)
    for cfg, jcfg in ((a.config, ja.config),
                      (a.reduced_config, ja.reduced_config)):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for build, jbuild in ((a.build, ja.build),
                          (a.build_reduced, ja.build_reduced)):
        specs, jspecs = build().specs(), jbuild().specs()
        assert _spec_rows(specs, True) == _spec_rows(jspecs, False)
        assert param_count(specs) == jparam_count(jspecs)
    for shape in jcommon.SHAPES:
        assert a.supports(shape) == ja.supports(shape)
    got, want = a.input_specs("train_4k"), ja.input_specs("train_4k")
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""),
                v.device.type) for k, v in got.items()} == {
        k: (tuple(v.shape), str(jnp.dtype(v.dtype)), "meta")
        for k, v in want.items()}


def test_h2o_danube_full_parameter_count():
    assert param_count(configs.get("h2o-danube-3-4b").build().specs()) == \
        3_961_839_360


def _fake_mesh(shape, axes=("data", "model")):
    class M:
        axis_names = axes

        def __init__(self):
            self.shape = dict(zip(axes, shape))
    return M()


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "xlstm-125m",
                                  "h2o-danube-3-4b", "whisper-medium"])
def test_cache_and_param_shardings_equal_reference(name):
    """Cache specs through the reference's ``_cache_axes_for`` on its own
    tree paths, and parameter specs, on fake meshes where the divisibility
    fallback bites; placements of a ``LocalMesh``."""
    jm, jp, m, p = _reduced(name)
    if name == "whisper-medium":
        jmem = jnp.zeros((2, 6, m.cfg.d_model), jnp.bfloat16)
        jcache = jm.init_cache(2, 16, jmem, jp)
        cache = m.init_cache(2, 16, torch.zeros(jmem.shape,
                                                dtype=torch.bfloat16), p)
    else:
        jcache, cache = jm.init_cache(2, 16), m.init_cache(2, 16, "cpu")
    for shape in ((2, 4), (1, 8), (4, 1)):
        mesh = _fake_mesh(shape)
        flat, _ = jax.tree_util.tree_flatten_with_path(jcache)
        want = []
        for path, leaf in flat:
            pstr = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                            for q in path)
            axes = jcommon._cache_axes_for(pstr, len(leaf.shape))
            want.append(tuple(jsharding.logical_to_pspec(
                axes, leaf.shape, jcommon._CACHE_RULES, mesh)))
        got = list(configs.cache_pspecs(cache, mesh).values())
        assert [tuple(g) for g in got] == want
        arch, jarch = configs.get(name), jconfigs.get(name)
        is_spec = lambda s: hasattr(s, "axes")  # noqa: E731
        jspecs = jax.tree.leaves(jarch.build_reduced().specs(),
                                 is_leaf=is_spec)
        specs = tree.leaves(arch.build_reduced().specs())
        for s, js in zip(specs, jspecs):
            assert tuple(sh.logical_to_pspec(s.axes, s.shape, arch.rules,
                                             mesh)) == tuple(
                jsharding.logical_to_pspec(js.axes, js.shape, jarch.rules,
                                           mesh))
    one = sh.LocalMesh([["cpu"]], ("data", "model"))
    placed = configs.cache_shardings(cache, one)
    assert set(placed) == set(configs.cache_pspecs(cache, one))
    embed = arch.build().specs()["embed"]
    assert arch.param_shardings(one)["embed"] == sh.placements(
        sh.logical_to_pspec(embed.axes, embed.shape, arch.rules, one), one)


def _tiny_lm(gated):
    """tests/test_static_reorder.py's LM: 4 layers, d 64, ff 128, vocab
    256, parameters from PRNGKey(int(gated)) (``init_params`` jitted)."""
    kw = dict(n_layers=4, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
              gated_mlp=gated)
    jm = JLM(JLMConfig("t", **kw))
    jp = jax.jit(functools.partial(jinit, jm.specs()))(
        jax.random.PRNGKey(int(gated)))
    return jm, jp, LM(LMConfig("t", **kw)), lm_params_from_jax(
        jax.tree.map(np.asarray, jp), device="cpu")


def _same_bits(got, want):
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        want, got = want.view(np.int16), got.view(torch.int16)
    return np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("gated", [True, False])
def test_static_layout_of_an_lm_equals_reference(gated):
    """``reorder_lm_params`` on the scan-stacked tiny LM: each layer's
    permutation and every reordered leaf bit for bit, the stream report
    exactly; the reordered model's logits within tolerance of the
    original's and of the reference's reordered model."""
    jm, jp, m, p = _tiny_lm(gated)
    jnew, new = jsr.reorder_lm_params(jp), sr.reorder_lm_params(p)
    assert all(_same_bits(g, w) for g, w in
               zip(tree.leaves(new), jax.tree.leaves(jnew)))
    _, jperm = jsr.reorder_mlp(jp["blocks"]["b0_attn"]["mlp"])
    _, perm = sr.reorder_mlp(p["blocks"]["b0_attn"]["mlp"])
    assert perm.shape == (4, 128)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    rep, jrep = sr.stream_bt_report(p, new), jsr.stream_bt_report(jp, jnew)
    for k in jrep:
        assert np.float32(rep[k].item()) == np.float32(jrep[k]), k
    # the totals a block-by-block report reads: the reference's int32 sum
    total, flits = sr.stream_bt_total(new)
    jstream = pack(jsr._unit_major_stream(jnew, jnp.bfloat16), 16)
    assert total == int(bt_stream(jstream))
    assert flits == jstream.words.shape[0]
    assert np.float32(per_flit(total, flits)) == np.float32(
        jrep["bt_per_flit_after"])
    toks = np.random.default_rng(4).integers(0, 256, (2, 16)).astype(np.int32)
    base, _ = m.forward(p, _t(toks))
    got, _ = m.forward(new, _t(toks))
    want, _ = jax.jit(jm.forward)(jnew, jnp.asarray(toks))
    _close(got, base.numpy())
    _close(got, want)


def test_static_layout_of_a_moe_tree_equals_reference():
    """The reduced mixtral's stacked (layers, experts, d, f) expert FFNs:
    one permutation per layer and expert, the router passed through
    untouched, every leaf and the stream report equal to the reference's."""
    _, jp, _, p = _reduced("mixtral-8x7b")
    jnew, new = jsr.reorder_lm_params(jp), sr.reorder_lm_params(p)
    assert all(_same_bits(g, w) for g, w in
               zip(tree.leaves(new), jax.tree.leaves(jnew)))
    moe = p["blocks"]["b0_attn"]["moe"]
    assert new["blocks"]["b0_attn"]["moe"]["router"] is moe["router"]
    _, perm = sr.reorder_mlp(moe)
    _, jperm = jsr.reorder_mlp(jp["blocks"]["b0_attn"]["moe"])
    assert perm.shape == (2, 4, 256)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    rep, jrep = sr.stream_bt_report(p, new), jsr.stream_bt_report(jp, jnew)
    for k in jrep:
        assert np.float32(rep[k].item()) == np.float32(jrep[k]), k
