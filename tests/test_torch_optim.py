"""Port parity: the optimizer (``repro_torch.optim``: AdamW with float32 and
block-wise int8 moments, global-norm clipping, the LR schedules) and the
elastic policy (``repro_torch.train.elastic``) against live ``repro`` on
the same numpy inputs.

Exact where the arithmetic is the same IEEE operations in the same order:
the int8 code tables bit for bit, the Q8 codes and scales, float32 moments
against the reference's update run op by op. Two functions round their
last bit differently on the two sides: torch's CPU ``sqrt`` (not correctly
rounded: 623 of 100,000 float32 values differ from numpy's by one ulp) and
``cos`` (XLA's and torch's differ by one ulp at some arguments). So
parameters are held within ``ULPS`` units of their dtype's epsilon of the
operands' scale, ``|p| + |p_new - p|``; against the jitted update, whose
fused multiply-adds round ``b1 * m + (1 - b1) * g`` once, moments are held
within ``ULPS`` epsilons of ``|b1 * m| + |(1 - b1) * g|``, and parameters,
whose step ``p - lr * (u + wd * p)`` it fuses too, within ``ULPS`` epsilons
of ``|p| + lr * (|u| + wd * |p|)``, u = mhat / (sqrt(vhat) + eps).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import clip as jclip  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.train import elastic as jelastic  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.optim import adamw, clip, schedules  # noqa: E402
from repro_torch.train import elastic  # noqa: E402

from test_torch_traffic import one_torch_thread  # noqa: E402,F401

ULPS = 2
EPS = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7}
# leaf -> (shape, dtype): a decayed 3-D matrix, a stacked 1-D norm weight
# (decayed: it has two dimensions), a vector, a scalar, a bf16 matrix whose
# last axis leaves its last block one value long.
SHAPES = {"w": ((3, 40, 300), "f32"), "ln": ((3, 64), "bf16"),
          "e": ((513,), "f32"), "s": ((), "f32"), "m": ((17, 257), "bf16")}


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _draw(rng, shape):
    """Normal values over ten decades of scale."""
    return np.asarray(rng.standard_normal(shape)
                      * np.exp(rng.uniform(-8, 2, shape)), np.float32)


def _jtree(arrays):
    return {k: (jnp.asarray(a).astype(jnp.bfloat16) if SHAPES[k][1] == "bf16"
                else jnp.asarray(a)) for k, a in arrays.items()}


def _ttree(jtree):
    return tree.from_numpy(jax.tree.map(np.asarray, jtree), "cpu")


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _within(got, want, scale, dtype, what, ulps=ULPS):
    got, want, scale = _f32(got), _f32(want), np.abs(_f32(scale))
    bound = ulps * EPS[dtype] * scale
    bad = np.abs(got - want) > bound
    assert not bad.any(), (f"{what}: {int(bad.sum())} of {bad.size} values "
                           f"beyond {ulps} ulps of their scale: worst "
                           f"{float((np.abs(got - want) / np.maximum(bound, 1e-45)).max() * ulps)}")


def test_int8_tables_are_the_references_bit_for_bit():
    assert adamw._TABLE_SIGNED.dtype == torch.float32
    assert np.array_equal(_bits(adamw._TABLE_SIGNED),
                          _bits(jadamw._TABLE_SIGNED))
    assert np.array_equal(_bits(adamw._TABLE_UNSIGNED),
                          _bits(jadamw._TABLE_UNSIGNED))
    assert adamw._TABLE_SIGNED.shape == (255,)
    assert adamw._TABLE_UNSIGNED.shape == (256,)


@pytest.mark.parametrize("shape", [(), (1,), (3, 255), (2, 256), (257,),
                                   (2, 3, 600)])
@pytest.mark.parametrize("signed", [True, False])
def test_q8_encode_decode_equal_the_reference(shape, signed):
    rng = np.random.default_rng(len(shape) * 7 + sum(shape))
    x = _draw(rng, shape)
    if not signed:
        x = np.asarray(np.abs(x))
    if x.size > 300:
        x.reshape(-1)[:256] = 0.0          # an all-zero block: scale floor
    assert adamw._q8_shape(shape) == jadamw._q8_shape(shape)
    want = jadamw._q8_encode(jnp.asarray(x), signed)
    got = adamw._q8_encode(torch.from_numpy(x), signed)
    assert got.q.dtype == torch.uint8 and got.scale.dtype == torch.float32
    assert np.array_equal(got.q.numpy(), np.asarray(want.q))
    assert np.array_equal(_bits(got.scale), _bits(want.scale))
    dec = adamw._q8_decode(got, shape, signed)
    jdec = jadamw._q8_decode(want, shape, signed)
    assert tuple(dec.shape) == shape
    assert np.array_equal(_bits(dec), _bits(jdec))


def _adamw_pair(state_dtype):
    sched = dict(lr=1e-2, total_steps=10, warmup=2)
    return (jadamw.AdamW(jsched.cosine(**sched), state_dtype=state_dtype),
            adamw.AdamW(schedules.cosine(**sched), state_dtype=state_dtype))


def _carry(jst) -> adamw.AdamWState:
    """The reference's optimizer state as the port's (Q8 pairs included)."""
    def mom(t):
        if isinstance(t, jadamw.Q8):
            return adamw.Q8(torch.from_numpy(np.array(t.q)),
                            torch.from_numpy(np.array(t.scale)))
        return torch.from_numpy(np.array(t))
    return adamw.AdamWState(
        torch.from_numpy(np.array(jst.step)),
        {k: mom(v) for k, v in jst.m.items()},
        {k: mom(v) for k, v in jst.v.items()})


def _moments(opt, st, shape, k):
    m, v = st.m[k], st.v[k]
    if opt.state_dtype == "int8":
        m = adamw._q8_decode(m, shape, signed=True)
        v = adamw._q8_decode(v, shape, signed=False)
    return m.numpy(), v.numpy()


def _step_scale(opt, old_st, st, p, g, k) -> np.ndarray:
    """The operands' scale of leaf k's new value: |p| + lr * (|m| + |b1 *
    m_old| + |(1 - b1) * g|) / c1 / (sqrt(vhat) + eps) + lr * wd * |p|."""
    m_old, _ = _moments(opt, old_st, p[k].shape, k)
    m, v = _moments(opt, st, p[k].shape, k)
    step = float(st.step)
    mscale = np.abs(m) + 0.9 * np.abs(m_old) + 0.1 * np.abs(g)
    u = (mscale / (1 - 0.9 ** step)) / (
        np.sqrt(v / (1 - 0.95 ** step)) + opt.eps)
    old = np.abs(_f32(p[k]))
    wd = opt.weight_decay if p[k].dim() >= 2 else 0.0
    return old + float(opt.lr_fn(st.step)) * (u + wd * old)


@pytest.mark.parametrize("jit", [False, True], ids=["op-by-op", "jit"])
@pytest.mark.parametrize("state_dtype", ["fp32", "int8"])
def test_adamw_update_matches_the_reference(state_dtype, jit,
                                            one_torch_thread):
    """Two updates, each from the reference's parameters and state carried
    across and fed the reference's own gradients (bf16 where the parameter
    is), against the reference's update op by op and jitted."""
    rng = np.random.default_rng(0)
    jp = _jtree({k: _draw(rng, s) for k, (s, _) in SHAPES.items()})
    jopt, opt = _adamw_pair(state_dtype)
    jst = jopt.init(jp)
    st = opt.init(_ttree(jp))
    assert [k for k, _ in tree.leaves_with_path(st)] == [
        "/".join(str(getattr(q, "key", getattr(q, "idx", q))) for q in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jst)[0]]
    for a, b in zip(tree.leaves(st), jax.tree.leaves(jst)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    update = jax.jit(jopt.update) if jit else jopt.update
    for _ in range(2):
        jg = _jtree({k: _draw(rng, s) for k, (s, _) in SHAPES.items()})
        p, st = _ttree(jp), _carry(jst)
        new, nst = opt.update(_ttree(jg), st, p)
        jnew, jst = update(jg, jst, jp)
        assert int(nst.step) == int(jst.step)
        assert nst.step.dtype == torch.int32
        for k in SHAPES:
            assert new[k].dtype == p[k].dtype
            g = _f32(jg[k])
            _within(new[k], jnew[k], _step_scale(opt, st, nst, p, g, k),
                    p[k].dtype, f"parameter {k}")
            if state_dtype == "int8":
                for mom, jmom in ((nst.m[k], jst.m[k]), (nst.v[k], jst.v[k])):
                    assert np.array_equal(mom.q.numpy(), np.asarray(jmom.q))
                    if jit:
                        _within(mom.scale, jmom.scale, jmom.scale,
                                torch.float32, f"int8 scale of {k}")
                    else:
                        assert np.array_equal(_bits(mom.scale),
                                              _bits(jmom.scale))
            elif jit:
                _within(nst.m[k], jst.m[k], 0.9 * np.abs(_f32(st.m[k]))
                        + 0.1 * np.abs(g), torch.float32, f"m of {k}")
                _within(nst.v[k], jst.v[k], 0.95 * _f32(st.v[k])
                        + 0.05 * g * g, torch.float32, f"v of {k}")
            else:
                assert np.array_equal(_bits(nst.m[k]), _bits(jst.m[k]))
                assert np.array_equal(_bits(nst.v[k]), _bits(jst.v[k]))
        jp = jnew


def test_adamw_decays_stacked_one_dimensional_leaves(one_torch_thread):
    """Weight decay goes by the stacked leaf's rank, as in the reference:
    a stacked norm weight (L, d) decays, a vector does not."""
    x = {"ln": np.ones((2, 8), np.float32), "b": np.ones(8, np.float32)}
    g = {k: np.zeros_like(v) for k, v in x.items()}
    p = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    opt = adamw.AdamW(schedules.constant(0.5), weight_decay=0.1)
    new, _ = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                        opt.init(p), p)
    jopt = jadamw.AdamW(jsched.constant(0.5), weight_decay=0.1)
    jx = jax.tree.map(jnp.asarray, x)
    jnew, _ = jopt.update(jax.tree.map(jnp.asarray, g), jopt.init(jx), jx)
    assert np.allclose(new["ln"].numpy(), 0.95)
    assert np.array_equal(new["b"].numpy(), x["b"])
    for k in p:
        assert np.array_equal(_bits(new[k]), _bits(jnew[k]))


def test_schedules_over_120_steps():
    """constant and wsd bit for bit; cosine within 4 ulps: the two sides'
    float32 cos differ by one ulp at some arguments (held below), and
    ``1 + cos`` cancels near the end of the decay (3 ulps read at its last
    step)."""
    pairs = {
        "constant": (jsched.constant(3e-3), schedules.constant(3e-3), 0),
        "wsd": (jsched.wsd(3e-3, 120, warmup=10),
                schedules.wsd(3e-3, 120, warmup=10), 0),
        "wsd-defaults": (jsched.wsd(1e-2, 100), schedules.wsd(1e-2, 100), 0),
        "cosine": (jsched.cosine(3e-3, 120, warmup=10),
                   schedules.cosine(3e-3, 120, warmup=10), 4),
        "cosine-short": (jsched.cosine(1e-2, 12, warmup=2),
                         schedules.cosine(1e-2, 12, warmup=2), 4),
    }
    for name, (jfn, fn, ulps) in pairs.items():
        want = np.array([np.asarray(jfn(jnp.int32(s))) for s in range(121)],
                        np.float32)
        got = np.array([fn(torch.tensor(s, dtype=torch.int32)).item()
                        for s in range(121)], np.float32)
        assert fn(torch.tensor(5)).dtype == torch.float32
        diff = np.abs(want.view(np.int32).astype(np.int64)
                      - got.view(np.int32))
        assert diff.max() <= ulps, (name, diff.max())
    t = np.float32(np.pi) * np.linspace(0, 1, 121, dtype=np.float32)
    jc = np.asarray(jnp.cos(jnp.asarray(t))).view(np.int32).astype(np.int64)
    tc = torch.cos(torch.from_numpy(t)).numpy().view(np.int32)
    assert np.abs(jc - tc).max() <= 1


def test_clip_by_global_norm_within_the_summation_bound(one_torch_thread):
    """The float32 norm over a bf16 / float32 tree (summed in another order
    on each side: within n * u of the sum of squares), the clipped leaves
    in their dtypes within the norm's relative difference and two
    roundings, and no clip below the threshold."""
    rng = np.random.default_rng(4)
    jg = _jtree({k: _draw(rng, s) for k, (s, _) in SHAPES.items()})
    g = _ttree(jg)
    n = sum(int(np.prod(s)) for s, _ in SHAPES.values())
    for max_norm in (1.0, 1e6):
        jc, jn = jclip.clip_by_global_norm(jg, max_norm)
        c, norm = clip.clip_by_global_norm(g, max_norm)
        assert norm.dtype == torch.float32
        rel = abs(float(norm) - float(jn)) / float(jn)
        assert rel <= n * 2.0 ** -24
        for k in SHAPES:
            assert c[k].dtype == g[k].dtype
            want = _f32(jc[k])
            np.testing.assert_allclose(
                _f32(c[k]), want, rtol=rel + 2 * EPS[g[k].dtype], atol=0)
        if max_norm > float(jn):
            assert all(torch.equal(c[k], g[k]) for k in SHAPES)


def test_elastic_policy_equals_the_reference():
    for n in (8, 15, 16, 17, 32, 256, 480, 512, 1000):
        for mp in (1, 4, 16):
            for pods in (None, 1, 2, 3):
                try:
                    want = jelastic.choose_mesh(n, mp, pods)
                except ValueError as e:
                    with pytest.raises(ValueError, match=re.escape(str(e))):
                        elastic.choose_mesh(n, mp, pods)
                else:
                    assert elastic.choose_mesh(n, mp, pods) == want
    for gb in (8, 12, 256):
        for per in (1, 2, 3):
            for data in (1, 2, 4, 8):
                try:
                    want = jelastic.microbatches_for(gb, per, data)
                except ValueError as e:
                    with pytest.raises(ValueError, match=re.escape(str(e))):
                        elastic.microbatches_for(gb, per, data)
                else:
                    assert elastic.microbatches_for(gb, per, data) == want
