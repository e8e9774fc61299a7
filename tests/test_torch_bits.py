"""Port parity: bit math, flit packing, fixed-8 quantization and the BT
measures of ``repro_torch.core``/``repro_torch.quant`` against live
``repro.core``/``repro.quant`` on the same numpy inputs.

Integers (popcounts, transitions, flit words, BT totals, quantized values)
must be exactly equal; the float measures (expected BT, per-position
probabilities) are sums taken in another order, held to float32 rtol 1e-6.
Inputs include negative floats and words with bit 31 set."""
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import bits as jbits, bt as jbt, flits as jflits  # noqa: E402
from repro.core.wire import measure as jmeasure  # noqa: E402
from repro.quant import quantize_fixed8 as jquant  # noqa: E402
from repro_torch.core import bits, bt, flits  # noqa: E402
from repro_torch.core.wire import measure  # noqa: E402
from repro_torch.quant import dequantize_fixed8, quantize_fixed8  # noqa: E402

RNG = np.random.default_rng(20251017)
WORDS = np.concatenate([
    RNG.integers(0, 2**32, 4000, dtype=np.uint64).astype(np.uint32),
    np.array([0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 1], np.uint32)])
FLOATS = np.concatenate([
    RNG.standard_normal(3000).astype(np.float32) * 3,
    np.array([-0.0, 0.0, -1.0, 1e-30, -3.4e38, np.inf, -np.inf], np.float32)])
INT8S = RNG.integers(-128, 128, 3000).astype(np.int8)


def _t(a):
    """numpy -> the port's carrier (uint32 travels as int32)."""
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    return torch.from_numpy(a.copy())


def _np(t):
    a = t.numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


@pytest.mark.parametrize("name", ["words", "floats", "int8"])
def test_popcount_matches_reference(name):
    a = {"words": WORDS, "floats": FLOATS, "int8": INT8S}[name]
    got = bits.popcount(_t(a))
    want = np.asarray(jbits.popcount(jnp.asarray(a)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_swar_forms_match_reference():
    got32 = bits.popcount32(_t(WORDS))
    np.testing.assert_array_equal(
        got32.numpy(), np.asarray(jbits.popcount32(jnp.asarray(WORDS))))
    u8 = INT8S.view(np.uint8)
    np.testing.assert_array_equal(
        bits.popcount8(torch.from_numpy(u8.copy())).numpy(),
        np.asarray(jbits.popcount8(jnp.asarray(u8))))
    for dt in (np.float32, np.int8):
        assert bits.bit_width(torch.from_numpy(np.zeros(1, dt)).dtype) == \
            jbits.bit_width(dt)


def test_popcount_of_bit31_words_counts_the_sign_bit():
    got = bits.popcount(_t(np.array([0x80000000, 0xFFFFFFFF], np.uint32)))
    assert got.tolist() == [1, 32]


@pytest.mark.parametrize("name", ["words", "floats", "int8"])
def test_transitions_match_reference(name):
    a = {"words": WORDS, "floats": FLOATS, "int8": INT8S}[name]
    b = np.roll(a, 7)
    got = bits.transitions(_t(a), _t(b))
    want = np.asarray(jbits.transitions(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["floats", "int8"])
def test_bits_of_matches_reference(name):
    a = {"floats": FLOATS, "int8": INT8S}[name][:200]
    got = bits.bits_of(_t(a)).numpy()
    want = np.asarray(jbits.bits_of(jnp.asarray(a)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lanes", [8, 16])
@pytest.mark.parametrize("name", ["floats", "int8"])
def test_pack_and_pack_paired_match_reference(name, lanes):
    a = {"floats": FLOATS, "int8": INT8S}[name][:1001]
    b = np.roll(a, 3)
    p, jp = flits.pack(_t(a), lanes), jflits.pack(jnp.asarray(a), lanes)
    np.testing.assert_array_equal(_np(p.words), np.asarray(jp.words))
    assert (p.lanes, p.value_bits) == (jp.lanes, jp.value_bits)
    pp = flits.pack_paired(_t(a), _t(b), lanes)
    jpp = jflits.pack_paired(jnp.asarray(a), jnp.asarray(b), lanes)
    np.testing.assert_array_equal(_np(pp.words), np.asarray(jpp.words))
    back = flits.unpack(p, a.size, torch.from_numpy(a).dtype)
    np.testing.assert_array_equal(back.numpy().view(np.uint8),
                                  a.view(np.uint8))


def test_quantize_fixed8_matches_reference():
    for scale in (0.01, 0.7, 3.0, 200.0):
        x = (RNG.standard_normal(5000) * scale).astype(np.float32)
        q = quantize_fixed8(torch.from_numpy(x))
        jq = jquant(jnp.asarray(x))
        np.testing.assert_array_equal(q.values.numpy(),
                                      np.asarray(jq.values))
        assert int(q.frac_bits) == int(jq.frac_bits)
        deq = dequantize_fixed8(q).numpy()
        np.testing.assert_array_equal(
            deq, q.values.numpy().astype(np.float32) * 2.0 ** -int(jq.frac_bits))


@pytest.mark.parametrize("lanes", [8, 16])
@pytest.mark.parametrize("name", ["floats", "int8", "words"])
def test_bt_measures_match_reference(name, lanes):
    a = {"words": WORDS, "floats": FLOATS, "int8": INT8S}[name]
    s, js = flits.pack(_t(a), lanes), jflits.pack(jnp.asarray(a), lanes)
    assert int(bt.bt_stream(s)) == int(jbt.bt_stream(js))
    assert int(bt.bt_between(s.words[0], s.words[1])) == int(
        jbt.bt_between(js.words[0], js.words[1]))
    assert float(bt.bt_per_flit(s)) == float(jbt.bt_per_flit(js))
    np.testing.assert_allclose(bt.bt_per_position(s).numpy(),
                               np.asarray(jbt.bt_per_position(js)), rtol=1e-6)
    np.testing.assert_allclose(bt.ones_prob_per_position(s).numpy(),
                               np.asarray(jbt.ones_prob_per_position(js)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(bt.expected_bt_stream(s)),
                               float(jbt.expected_bt_stream(js)), rtol=1e-6)
    got, want = measure(s), jmeasure(js)
    assert got.keys() == want.keys()
    for k in ("total_bt", "bt_per_flit", "num_flits", "flit_bits"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["expected_bt"], want["expected_bt"],
                               rtol=1e-6)


def test_expected_bt_pair_and_pairing_objective():
    x = RNG.integers(0, 33, 64).astype(np.int32)
    y = RNG.integers(0, 33, 64).astype(np.int32)
    np.testing.assert_allclose(
        bt.expected_bt_pair(torch.from_numpy(x), torch.from_numpy(y), 32).numpy(),
        np.asarray(jbt.expected_bt_pair(jnp.asarray(x), jnp.asarray(y), 32)),
        rtol=1e-6)
    assert float(bt.pairing_objective(torch.from_numpy(x),
                                      torch.from_numpy(y))) == float(
        jbt.pairing_objective(jnp.asarray(x), jnp.asarray(y)))
