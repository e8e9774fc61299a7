"""Port parity: the LM stack's layers and recurrent blocks
(``repro_torch.models.layers`` / ``recurrent``) against live
``repro.models.layers`` / ``recurrent`` on the same numpy inputs.

Parameters and activations are float32 here unless a test says otherwise,
so every difference is a float32 summation-order difference (torch's
reductions and XLA's sum in other orders; the RG-LRU scan combines in a
doubling order where XLA uses its associative tree): outputs are held to
``atol = 1e-5 * max|want|`` (``_close``). A wrong formula - GELU's erf form
in place of the tanh approximation, ``F.softplus``'s threshold, a mask off
by one - moves outputs by 1e-4 or more of their scale. bf16 cases are held
to two bf16 units of the largest value (2^-7 * max|want|). MoE routing
(which expert, which capacity slot, which token is dropped) is held
exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import recurrent as R  # noqa: E402

from test_torch_traffic import one_torch_thread  # noqa: E402,F401

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -7


def _np(x):
    return np.asarray(x).astype(np.float32)


def _close(got, want, tol=F32_TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else _np(got)
    want = _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _params(specs_fn, seed, scale=0.3):
    """Random float32 parameters in the structure ``specs_fn`` gives the
    reference: (jax tree, torch tree)."""
    rng = np.random.default_rng(seed)
    specs = specs_fn()
    is_spec = lambda s: hasattr(s, "axes")  # noqa: E731
    shapes = jax.tree.map(lambda s: s.shape, specs, is_leaf=is_spec)
    flat, treedef = jax.tree.flatten(
        shapes, is_leaf=lambda s: isinstance(s, tuple))
    arrs = [(scale * rng.standard_normal(s)).astype(np.float32) for s in flat]
    p = treedef.unflatten(arrs)
    return jax.tree.map(jnp.asarray, p), tree.from_numpy(p, device="cpu")


def _x(seed, shape, dtype=np.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    return jx, tree.from_numpy(np.asarray(jx), device="cpu")


def test_rms_norm_and_rope():
    jx, x = _x(0, (2, 6, 4, 16))
    jw, w = _x(1, (16,))
    _close(L.rms_norm(x, w), JL.rms_norm(jx, jw))
    pos = np.array([[0, 1, 2, 3, 4, 5], [7, 100, 4095, 4096, 9, 30000]])
    for theta in (10000.0, 1e6):
        _close(L.rope(x, torch.from_numpy(pos), theta),
               JL.rope(jx, jnp.asarray(pos), theta))
    bx, tx = _x(2, (2, 6, 4, 16), jnp.bfloat16)
    _close(L.rms_norm(tx, w.bfloat16()),
           JL.rms_norm(bx, jw.astype(jnp.bfloat16)), BF16_TOL)
    _close(L.rope(tx, torch.from_numpy(pos)), JL.rope(bx, jnp.asarray(pos)),
           BF16_TOL)


ATTN = {
    "causal": dict(),
    "swa": dict(window=5),
    "noncausal": dict(causal=False, use_rope=False),
    "kv_chunk": dict(kv_chunk=4),
    "swa_kv_chunk": dict(window=6, kv_chunk=4),
}


@pytest.mark.parametrize("case", sorted(ATTN))
def test_attention(case):
    cfg = JL.AttnConfig(32, 4, 2, 8, **ATTN[case])
    tcfg = L.AttnConfig(*cfg)
    jp, p = _params(lambda: JL.attention_specs(cfg), 3)
    jx, x = _x(4, (2, 12, 32))
    _close(L.attention(p, x, tcfg), JL.attention(jp, jx, cfg))


def test_cross_attention_kv_override():
    cfg = JL.AttnConfig(32, 4, 4, 8, use_rope=False, causal=False)
    jp, p = _params(lambda: JL.attention_specs(cfg), 5)
    jx, x = _x(6, (2, 5, 32))
    jm, m = _x(7, (2, 9, 32))
    jk = jnp.einsum("bsd,dnh->bsnh", jm, jp["wk"])
    jv = jnp.einsum("bsd,dnh->bsnh", jm, jp["wv"])
    k = torch.einsum("bsd,dnh->bsnh", m, p["wk"])
    v = torch.einsum("bsd,dnh->bsnh", m, p["wv"])
    jpos = jnp.broadcast_to(jnp.arange(9), (2, 9))
    want = JL.attention(jp, jx, cfg, kv_override=(jk, jv, jpos))
    got = L.attention(p, x, L.AttnConfig(*cfg),
                      kv_override=(k, v, torch.arange(9).expand(2, 9)))
    _close(got, want)


@pytest.mark.parametrize("window,s_cache", [(0, 24), (6, 6), (0, 8)])
def test_attention_decode_ring(window, s_cache):
    """Decode far past the ring (24 steps through a cache of 6 or 8 slots:
    several wraps), the reference's cache carried alongside. The caller's
    cache must be left as it was."""
    cfg = JL.AttnConfig(32, 4, 2, 8, window=window)
    tcfg = L.AttnConfig(*cfg)
    jp, p = _params(lambda: JL.attention_specs(cfg), 8)
    jc = JL.KVCache(jnp.zeros((2, s_cache, 2, 8)), jnp.zeros((2, s_cache, 2, 8)))
    c = L.KVCache(torch.zeros(2, s_cache, 2, 8), torch.zeros(2, s_cache, 2, 8))
    xs = np.random.default_rng(9).standard_normal((24, 2, 1, 32)).astype(
        np.float32)
    for t in range(24):
        pos = np.array([t, t + 3], np.int32)
        want, jc = JL.attention_decode(jp, jnp.asarray(xs[t]), cfg, jc,
                                       jnp.asarray(pos))
        before = c.k.clone()
        got, c2 = L.attention_decode(p, torch.from_numpy(xs[t]), tcfg, c,
                                     torch.from_numpy(pos))
        assert torch.equal(c.k, before)
        c = c2
        _close(got, want)
        _close(c.k, jc.k)
        _close(c.v, jc.v)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp(gated):
    jp, p = _params(lambda: JL.mlp_specs(32, 48, gated), 10, scale=1.0)
    jx, x = _x(11, (2, 7, 32))
    _close(L.mlp(p, x, gated), JL.mlp(jp, jx, gated))
    bp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    bx = jx.astype(jnp.bfloat16)
    tp = tree.from_numpy(jax.tree.map(np.asarray, bp), device="cpu")
    _close(L.mlp(tp, tree.from_numpy(np.asarray(bx), device="cpu"), gated),
           JL.mlp(bp, bx, gated), BF16_TOL)


def test_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    got = L.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - got).max() > 1e-4


@pytest.mark.parametrize("groups,cap_factor", [(1, 1.25), (2, 1.25),
                                               (1, 0.5), (2, 0.5)])
def test_moe(groups, cap_factor):
    """Capacity 0.5 drops about half the choices; groups 2 gives each half
    of the tokens its own capacity."""
    cfg = JL.MoEConfig(32, 24, 4, 2, cap_factor)
    jp, p = _params(lambda: JL.moe_specs(cfg), 12, scale=0.5)
    jx, x = _x(13, (2, 8, 32))
    want, jaux = JL.moe(jp, jx, cfg, groups=groups)
    got, aux = L.moe(p, x, L.MoEConfig(*cfg), groups=groups)
    _close(got, want)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    dropped = np.all(_np(want) == 0, axis=-1)
    np.testing.assert_array_equal(np.all(got.numpy() == 0, axis=-1), dropped)
    if cap_factor < 1:
        assert dropped.any()
    shard, _ = L.moe(p, x, L.MoEConfig(*cfg), groups=groups,
                     shard=("data", "model"))
    assert torch.equal(shard, got)


def test_moe_top_k_ties_route_to_lower_experts():
    """A zero router gives every expert probability 1/E: ``lax.top_k``
    takes experts 0 and 1 for every token, so experts 0 and 1 fill to their
    capacity in token order and every later token is dropped (y == 0)."""
    cfg = JL.MoEConfig(32, 24, 4, 2, 1.0)
    jp, p = _params(lambda: JL.moe_specs(cfg), 14)
    jp["router"] = jnp.zeros_like(jp["router"])
    p["router"] = torch.zeros_like(p["router"])
    jx, x = _x(15, (1, 8, 32))
    want, _ = JL.moe(jp, jx, cfg)
    got, _ = L.moe(p, x, L.MoEConfig(*cfg))
    cap = int(1.0 * 8 * 2 / 4)
    kept = ~np.all(_np(want) == 0, axis=-1)[0]
    np.testing.assert_array_equal(kept, np.arange(8) < cap)
    np.testing.assert_array_equal(~np.all(got.numpy() == 0, axis=-1)[0], kept)
    _close(got, want)


def test_rglru_scan_and_step():
    jp, p = _params(lambda: JR.rglru_specs(32), 16, scale=0.5)
    jx, x = _x(17, (2, 23, 32))
    _close(R.rglru_scan(p, x), JR.rglru_scan(jp, jx))
    jh = JR.RGLRUState(jnp.asarray(np.ones((2, 32), np.float32)))
    h = R.RGLRUState(torch.ones(2, 32))
    for t in range(3):
        jy, jh = JR.rglru_step(jp, jx[:, t], jh)
        y, h = R.rglru_step(p, x[:, t], h)
        _close(y, jy)
        _close(h.h, jh.h)


def test_causal_conv1d_and_step():
    jp, p = _params(lambda: JR.conv1d_specs(32), 18, scale=1.0)
    jx, x = _x(19, (2, 9, 32))
    _close(R.causal_conv1d(p, x), JR.causal_conv1d(jp, jx))
    jhist, hist = jnp.zeros((2, 3, 32)), torch.zeros(2, 3, 32)
    for t in range(5):
        jy, jhist = JR.causal_conv1d_step(jp, jx[:, t], jhist)
        y, hist = R.causal_conv1d_step(p, x[:, t], hist)
        _close(y, jy)
        _close(hist, jhist)


def test_mlstm_scan_and_step():
    jp, p = _params(lambda: JR.mlstm_specs(32, 4), 20, scale=0.5)
    jx, x = _x(21, (2, 10, 32))
    _close(R.mlstm_scan(p, x, 4), JR.mlstm_scan(jp, jx, 4))
    js, s = JR.mlstm_init_state(2, 4, 8), R.mlstm_init_state(2, 4, 8)
    for t in range(4):
        jy, js = JR.mlstm_step(jp, jx[:, t], js, 4)
        y, s = R.mlstm_step(p, x[:, t], s, 4)
        _close(y, jy)
        for a, b in zip(s, js):
            _close(a, b)
    # the scan's final state is what a prefill caches
    _, final = R.mlstm_scan_state(p, x[:, :4], 4)
    for a, b in zip(final, js):
        _close(a, b)


def test_slstm_scan_and_step():
    jp, p = _params(lambda: JR.slstm_specs(32, 4), 22, scale=0.5)
    jx, x = _x(23, (2, 10, 32))
    _close(R.slstm_scan(p, x, 4), JR.slstm_scan(jp, jx, 4))
    js, s = JR.slstm_init_state(2, 32), R.slstm_init_state(2, 32)
    for t in range(4):
        jy, js = JR.slstm_step(jp, jx[:, t], js, 4)
        y, s = R.slstm_step(p, x[:, t], s, 4)
        _close(y, jy)
        for a, b in zip(s, js):
            _close(a, b)
    _, final = R.slstm_scan_state(p, x[:, :4], 4)
    for a, b in zip(final, js):
        _close(a, b)
