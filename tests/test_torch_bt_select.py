"""Port parity for the BT counter's total (K3) and the chain select (K6
step), on the CPU, against live ``repro`` on the same numpy inputs.

* ``ops.bt_total`` / ``core.bt.bt_stream`` equal ``repro.core.bt.bt_stream``
  and the port's ``wire.measure`` (which counts a stream's BT once) equals
  ``repro.core.wire.measure``: integers and the per-flit ratio exactly, the
  expected BT (a float32 sum taken in another order) to rtol 1e-6.
* ``ops.chain_select``'s order is the stable ascending order of its key:
  its first ``beam`` columns equal the reference's ``_select_beam`` (what
  the reference chain runs) on tie-heavy keys and on a row holding an
  INT32_MIN key, and the whole order equals ``chain_select_pallas``
  (interpret mode) on distinct keys that wrap past INT32_MAX. On ties and
  INT32_MIN the Pallas kernel is not stable or overflows (ROADMAP C10), so
  it is not asserted there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bt as jbt, flits as jflits  # noqa: E402
from repro.core.wire import measure as jmeasure  # noqa: E402
from repro.kernels.min_hamming import (_select_beam,  # noqa: E402
                                       chain_select_pallas)
from repro_torch.core import bt, flits  # noqa: E402
from repro_torch.core.wire import measure  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

INT32_MIN = -(2**31)
CHAIN_PENALTIES = np.array([0, 1 << 28, 1 << 30, (1 << 30) + (1 << 28)],
                           np.int64)


def _words(rng, n):
    w = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    w[:min(n, 2)] = [0x80000000, 0xFFFFFFFF][:min(n, 2)]
    return w


def _lenet_like(rng, n=8000):
    """Trained-LeNet-like weights: small float32 values, half negative."""
    return (rng.standard_normal(n) * 0.05).astype(np.float32)


def _torch(a):
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    return torch.from_numpy(a.copy())


def _check_stream(values, lanes):
    s = flits.pack(_torch(values), lanes)
    js = jflits.pack(jnp.asarray(values), lanes)
    want = int(jbt.bt_stream(js))
    total = ops.bt_total(s.words)
    assert total.dtype == torch.int32 and total.shape == ()
    assert int(total) == int(bt.bt_stream(s)) == want
    assert int(total) == int(ops.bt_boundaries(s.words).sum())
    got, ref = measure(s), jmeasure(js)
    assert got.keys() == ref.keys()
    for k in ("total_bt", "bt_per_flit", "num_flits", "flit_bits"):
        assert got[k] == ref[k], k
    assert got["bt_per_flit"] == float(bt.bt_per_flit(s))
    np.testing.assert_allclose(got["expected_bt"], ref["expected_bt"],
                               rtol=1e-6)


@pytest.mark.parametrize("lanes", [1, 3, 8, 33])
@pytest.mark.parametrize("f", [1, 2, 3])
def test_bt_total_and_measure_match_reference(f, lanes):
    _check_stream(_words(np.random.default_rng(f * 100 + lanes), f * lanes),
                  lanes)


@pytest.mark.parametrize("quantized", [False, True])
def test_bt_total_and_measure_match_reference_lenet_like(quantized):
    v = _lenet_like(np.random.default_rng(7))
    if quantized:
        v = np.clip(np.round(v * 512), -128, 127).astype(np.int8)
    _check_stream(v, 8)


def _planes(rng, r, w, planes):
    return [rng.integers(0, 2**32, (r, w), dtype=np.uint64).astype(np.uint32)
            for _ in range(planes)]


def _keys(xors, pen, k2):
    """The select key dvec * k2 + idx + pen, wrapping as int32 does."""
    d = sum(np.vectorize(lambda v: bin(int(v)).count("1"))(x) for x in xors)
    idx = np.arange(pen.shape[1], dtype=np.int64)
    key = d.astype(np.int64) * k2 + idx + pen.astype(np.int64)
    return ((key + 2**31) % 2**32 - 2**31).astype(np.int32)


def _port_select(xors, pen):
    dvec, order = ops.chain_select([_torch(x) for x in xors],
                                   torch.from_numpy(pen))
    assert dvec.dtype == order.dtype == torch.int32
    return dvec.numpy(), order.numpy()


def _select_beams(keys, beam):
    sel = jax.jit(jax.vmap(lambda k: _select_beam(k, beam)))
    return np.asarray(sel(jnp.asarray(keys)))


@pytest.mark.parametrize("beam", [2, None])
@pytest.mark.parametrize("r,w,planes", [(6, 17, 1), (6, 40, 2)])
def test_chain_select_matches_select_beam_on_ties(r, w, planes, beam):
    """Penalties ``-idx + {0, 1, 2}`` leave keys dvec * W + {0, 1, 2}:
    rows full of ties, which the chain breaks by lane, as ``_select_beam``'s
    first-minimum argmin does."""
    rng = np.random.default_rng(r * w + planes)
    xors = _planes(rng, r, w, planes)
    pen = (-np.arange(w)[None, :] + rng.integers(0, 3, (r, w))).astype(
        np.int32)
    keys = _keys(xors, pen, w)
    assert len(np.unique(keys)) < keys.size        # ties present
    beam = w if beam is None else beam
    _, order = _port_select(xors, pen)
    np.testing.assert_array_equal(order[:, :beam], _select_beams(keys, beam))


@pytest.mark.parametrize("r,w,planes", [(5, 128, 1), (3, 256, 2)])
def test_chain_select_matches_pallas_on_wrapping_keys(r, w, planes):
    """A row-constant penalty near INT32_MAX wraps the larger keys to the
    most negative ones; keys stay distinct (they embed the lane), so the
    reference's negated network gives the same order. W is a power of two
    >= 128, where the Pallas kernel adds no padding lanes."""
    rng = np.random.default_rng(w + planes)
    xors = _planes(rng, r, w, planes)
    pen = np.repeat((2**31 - 1) - rng.integers(0, 64 * w, (r, 1)), w,
                    axis=1).astype(np.int32)
    keys = _keys(xors, pen, w)
    assert (keys < 0).any() and (keys > 0).any()   # some keys wrapped
    assert (keys != INT32_MIN).all()
    assert all(len(np.unique(k)) == w for k in keys)
    jd, jo = chain_select_pallas([jnp.asarray(x) for x in xors],
                                 jnp.asarray(pen))
    dvec, order = _port_select(xors, pen)
    np.testing.assert_array_equal(dvec, np.asarray(jd))
    np.testing.assert_array_equal(order, np.asarray(jo))


@pytest.mark.parametrize("r,w,planes", [(1, 4, 1), (4, 152, 2)])
def test_chain_select_orders_an_int32_min_key_first(r, w, planes):
    """One key of each row is INT32_MIN (the chain's penalties elsewhere):
    the order is a permutation of the lanes, ascending by key, with that
    lane first, and its beam is ``_select_beam``'s."""
    rng = np.random.default_rng(w * 3 + planes)
    xors = _planes(rng, r, w, planes)
    pen = rng.choice(CHAIN_PENALTIES, (r, w))
    d = _keys(xors, np.zeros((r, w), np.int32), 1) - np.arange(w)
    lanes = rng.integers(0, w, r)
    for i, j in enumerate(lanes):
        pen[i, j] = INT32_MIN - int(d[i, j]) * w - int(j)
    pen = ((pen + 2**31) % 2**32 - 2**31).astype(np.int32)
    keys = _keys(xors, pen, w)
    assert (keys[np.arange(r), lanes] == INT32_MIN).all()
    _, order = _port_select(xors, pen)
    for k, o, j in zip(keys, order, lanes):
        np.testing.assert_array_equal(np.sort(o), np.arange(w))
        assert (np.diff(k[o].astype(np.int64)) >= 0).all()
        assert o[0] == j
    np.testing.assert_array_equal(order[:, :2], _select_beams(keys, 2))
