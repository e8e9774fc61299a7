"""Port parity: O0/O1/O2 ordering of ``repro_torch.core`` against live
``repro.core`` on the same numpy inputs. Permutations and ordered words
must be exactly equal, under both tiebreaks, for float32 and fixed8 values
- including negative floats, whose bit 31 is set (the ``pattern`` tiebreak
sorts the pattern as unsigned)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import ordering as jord  # noqa: E402
from repro.core.wire import by_name as jby_name  # noqa: E402
from repro.quant import quantize_fixed8 as jquant  # noqa: E402
from repro_torch.core import ordering  # noqa: E402
from repro_torch.core.wire import by_name  # noqa: E402

RNG = np.random.default_rng(7)
# Heavy popcount ties: few distinct magnitudes, both signs.
FLOATS = (RNG.choice([-2.0, -0.5, 0.0, 0.25, 1.0, 3.0], 600)
          * RNG.choice([1.0, 1.5], 600)).astype(np.float32)
FIXED8 = np.array(jquant(jnp.asarray(
    RNG.standard_normal(600).astype(np.float32))).values)
CASES = {"float32": FLOATS, "fixed8": FIXED8}


def _np(t):
    a = t.numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _bits(a):
    """numpy values -> unsigned bit patterns for comparison."""
    return a.view({4: np.uint32, 1: np.uint8}[a.dtype.itemsize])


@pytest.mark.parametrize("window", [None, 25, 64])
@pytest.mark.parametrize("tiebreak", ["stable", "pattern"])
@pytest.mark.parametrize("prec", ["float32", "fixed8"])
def test_descending_perm_matches_reference(prec, tiebreak, window):
    a = CASES[prec]
    got = ordering.descending_perm(torch.from_numpy(a), window, tiebreak)
    want = np.asarray(jord.descending_perm(jnp.asarray(a), window, tiebreak))
    np.testing.assert_array_equal(got.numpy(), want)


def test_pattern_tiebreak_orders_bit31_words_as_unsigned():
    # Equal popcounts: 0x80000001 > 0x00000003 as unsigned, so it sorts
    # first under a descending pattern tiebreak (a signed key would put it
    # last).
    w = np.array([3, 0x80000001], np.uint32)
    got = ordering.descending_perm(torch.from_numpy(w.view(np.int32)),
                                   None, "pattern")
    want = np.asarray(jord.descending_perm(jnp.asarray(w), None, "pattern"))
    assert got.tolist() == want.tolist() == [1, 0]


@pytest.mark.parametrize("fill,lanes", [("rowmajor", None), ("interleave", 8)])
def test_descending_order_matches_reference(fill, lanes):
    a = FLOATS
    got = ordering.descending_order(torch.from_numpy(a), window=64,
                                    fill=fill, lanes=lanes)
    want = jord.descending_order(jnp.asarray(a), window=64, fill=fill,
                                 lanes=lanes)
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
    np.testing.assert_array_equal(_bits(got.values.numpy()),
                                  _bits(np.asarray(want.values)))


def test_permutation_helpers_match_reference():
    perm = np.array(jord.descending_perm(jnp.asarray(FLOATS), 50, "pattern"))
    inv = ordering.inverse_permutation(torch.from_numpy(perm))
    np.testing.assert_array_equal(
        inv.numpy(), np.asarray(jord.inverse_permutation(jnp.asarray(perm))))
    vals = ordering.apply_permutation(torch.from_numpy(FLOATS),
                                      torch.from_numpy(perm))
    np.testing.assert_array_equal(vals.numpy(), FLOATS[perm])
    for w in (1, 2, 25, 150, 400):
        assert ordering.index_overhead_bits(w) == jord.index_overhead_bits(w)


@pytest.mark.parametrize("tiebreak", ["stable", "pattern"])
@pytest.mark.parametrize("prec", ["float32", "fixed8"])
@pytest.mark.parametrize("name", ["O0", "O1", "O2"])
def test_wire_transforms_apply_match_reference(name, prec, tiebreak):
    a = CASES[prec]
    i, w = a[:300], a[300:]
    tr, jtr = (by_name(name, tiebreak=tiebreak),
               jby_name(name, tiebreak=tiebreak))
    got = tr.apply(torch.from_numpy(i), torch.from_numpy(w), 16)
    want = jtr.apply(jnp.asarray(i), jnp.asarray(w), 16)
    np.testing.assert_array_equal(_np(got.words), np.asarray(want.words))
    single = tr.apply_single(torch.from_numpy(w), 16)
    jsingle = jtr.apply_single(jnp.asarray(w), 16)
    np.testing.assert_array_equal(_np(single.words), np.asarray(jsingle.words))
    for win in (25, 150):
        for paired in (True, False):
            assert (tr.overhead_bits_per_value(win, paired)
                    == jtr.overhead_bits_per_value(win, paired))


@pytest.mark.parametrize("window", [None, 16, 40])
@pytest.mark.parametrize("name", ["O1", "O2", "desc"])
def test_order_packets_equals_per_packet_order(name, window):
    """The packetizer's row-batched ordering == the reference transform
    applied packet by packet (window inside the packet, padding included)."""
    k = 50
    i = FLOATS[:6 * k].reshape(6, k)
    w = FLOATS[300:300 + 6 * k].reshape(6, k)
    tr = by_name(name, window=window, tiebreak="pattern")
    jtr = jby_name(name, window=window, tiebreak="pattern")
    oi, ow = tr.order_packets(torch.from_numpy(i), torch.from_numpy(w), 16)
    for r in range(6):
        ji, jw = jtr.order(jnp.asarray(i[r]), jnp.asarray(w[r]), 16)
        np.testing.assert_array_equal(_bits(oi[r].numpy()),
                                      _bits(np.asarray(ji)))
        np.testing.assert_array_equal(_bits(ow[r].numpy()),
                                      _bits(np.asarray(jw)))


def test_later_slice_transforms_raise():
    """O3/O3a were left to a later slice and raised; they are ported now,
    so this pins them to the reference's recovery overhead instead."""
    for name in ("O3", "O3a"):
        tr, jtr = by_name(name), jby_name(name)
        assert tr.name == name and tr.reorders
        for w in (1, 2, 25, 150, 400):
            for paired in (True, False):
                assert (tr.overhead_bits_per_value(w, paired)
                        == jtr.overhead_bits_per_value(w, paired))
