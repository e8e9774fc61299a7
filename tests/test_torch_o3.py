"""Port parity: O3/O3a min-Hamming ordering of ``repro_torch`` against live
``repro`` on the same numpy inputs.

* ``min_hamming_chain`` (whose steps run the plain chain select on the
  CPU) equals the reference's on perm, cost and nonzeros: one and two
  planes, windows with zeros, all-zero windows, ``w = 1`` and ``beam > w``;
  the port's numpy copy of the reference oracle equals the reference's;
* the three O3 orderings and the O3/O3a transforms equal the reference's
  on fixed8 words and on float32 words with bit 31 set (ROADMAP C1, C7).

The sweep rows are in test_torch_o3_sweep.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import ordering as jord  # noqa: E402
from repro.core.wire import by_name as jby_name  # noqa: E402
from repro.kernels import min_hamming as jmh  # noqa: E402
from repro_torch.core import ordering  # noqa: E402
from repro_torch.core.wire import by_name  # noqa: E402
from repro_torch.kernels import min_hamming as mh  # noqa: E402

from test_torch_ordering import FIXED8, FLOATS, _bits  # noqa: E402
from test_torch_traffic import one_torch_thread  # noqa: E402,F401


def _planes(rng, r, w, planes, zero_frac):
    xs = [rng.integers(0, 2**32, (r, w), dtype=np.uint64).astype(np.uint32)
          for _ in range(planes)]
    zero = rng.random((r, w)) < zero_frac
    for x in xs:
        x[zero] = 0
    return xs


def _t(x):
    return torch.from_numpy(x.view(np.int32))


@pytest.mark.parametrize("r,w,planes,zero_frac,beam", [
    (6, 9, 1, 0.3, 2),      # zeros inside windows
    (4, 9, 2, 0.3, 2),      # affiliated: summed two-plane distance
    (5, 40, 1, 0.2, 2),     # more values than starts
    (3, 130, 2, 0.1, 3),
    (2, 7, 1, 1.0, 2),      # all-zero windows (z = 0)
    (3, 1, 2, 0.0, 2),      # w = 1
    (4, 3, 1, 0.3, 5),      # beam > w
])
def test_chain_matches_reference(r, w, planes, zero_frac, beam):
    rng = np.random.default_rng(r * 100 + w + planes)
    xs = _planes(rng, r, w, planes, zero_frac)
    streams = xs[0] if planes == 1 else xs
    want = jmh.min_hamming_chain(
        jnp.asarray(streams) if planes == 1 else [jnp.asarray(x) for x in xs],
        beam=beam)
    got = mh.min_hamming_chain(_t(xs[0]) if planes == 1
                               else [_t(x) for x in xs], beam=beam)
    for name, g, v in zip(("perm", "cost", "nonzeros"), got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(v), name)
    np.testing.assert_array_equal(
        mh.chain_cost([_t(x) for x in xs], got.perm).numpy(),
        np.asarray(jmh.chain_cost([jnp.asarray(x) for x in xs],
                                  jnp.asarray(want.perm))))


@pytest.mark.parametrize("planes", [1, 2])
def test_numpy_reference_copy_matches_reference(planes):
    """The port's numpy oracle == the reference's on <= 6-value windows
    (where the multi-start search is exhaustive), and == the port's chain."""
    rng = np.random.default_rng(40 + planes)
    for w in (2, 4, 6):
        xs = _planes(rng, 5, w, planes, 0.25)
        want = jmh.min_hamming_chain_reference(xs)
        got = mh.min_hamming_chain_reference(xs)
        chain = mh.min_hamming_chain([_t(x) for x in xs])
        for g, v, c in zip(got, want, chain):
            np.testing.assert_array_equal(g, v)
            np.testing.assert_array_equal(c.numpy(), v)


def test_chain_rejects_bad_arguments():
    x = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="beam"):
        mh.min_hamming_chain(x, beam=0)
    with pytest.raises(ValueError, match="starts"):
        mh.min_hamming_chain(x, starts=0)
    with pytest.raises(ValueError, match="encoding bound"):
        mh.min_hamming_chain(torch.zeros((1, 16001), dtype=torch.int32))
    empty = mh.min_hamming_chain(torch.zeros((3, 0), dtype=torch.int32))
    assert empty.perm.shape == (3, 0) and int(empty.cost.sum()) == 0


CASES = {"float32": FLOATS, "fixed8": FIXED8}


@pytest.mark.parametrize("prec", ["float32", "fixed8"])
@pytest.mark.parametrize("window", [None, 20])
def test_min_hamming_orderings_match_reference(prec, window):
    vals = CASES[prec][:120]
    other = CASES[prec][300:420]
    lanes = 8
    want = jord.min_hamming_order(jnp.asarray(vals), window=window,
                                  lanes=lanes)
    got = ordering.min_hamming_order(torch.from_numpy(vals), window=window,
                                     lanes=lanes)
    np.testing.assert_array_equal(_bits(got.values.numpy()),
                                  _bits(np.asarray(want.values)))
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
    np.testing.assert_array_equal(
        ordering.min_hamming_perm(torch.from_numpy(vals), window).numpy(),
        np.asarray(jord.min_hamming_perm(jnp.asarray(vals), window)))
    for name in ("affiliated_min_hamming_order",
                 "separated_min_hamming_order"):
        want = getattr(jord, name)(jnp.asarray(vals), jnp.asarray(other),
                                   window=window, lanes=lanes // 2)
        got = getattr(ordering, name)(torch.from_numpy(vals),
                                      torch.from_numpy(other), window=window,
                                      lanes=lanes // 2)
        for g, v in zip(got, want):
            g = g.numpy()
            if g.dtype == np.int64:       # permutations
                np.testing.assert_array_equal(g, np.asarray(v), name)
            else:
                np.testing.assert_array_equal(_bits(g), _bits(np.asarray(v)),
                                              name)


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("name", ["O3", "O3a"])
def test_o3_order_packets_equals_per_packet_order(name, window):
    """The packetizer's row-batched O3 ordering (every window padded to
    ``lanes // 2`` on its own) == the reference transform per packet."""
    k = 50
    i = FIXED8[:4 * k].reshape(4, k)
    w = FIXED8[300:300 + 4 * k].reshape(4, k)
    tr, jtr = by_name(name, window=window), jby_name(name, window=window)
    oi, ow = tr.order_packets(torch.from_numpy(i), torch.from_numpy(w), 16)
    for r in range(4):
        ji, jw = jtr.order(jnp.asarray(i[r]), jnp.asarray(w[r]), 16)
        np.testing.assert_array_equal(_bits(oi[r].numpy()),
                                      _bits(np.asarray(ji)))
        np.testing.assert_array_equal(_bits(ow[r].numpy()),
                                      _bits(np.asarray(jw)))
