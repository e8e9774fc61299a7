"""The no-NoC recorder's fused sums (``ops.bt_measure``: the BT total and
Eq. 3's S1 = sum(x + y), S2 = sum(x y) in one launch on the card), on the
CPU against live ``repro`` on the same numpy inputs.

* the BT total equals ``repro.core.bt.bt_stream`` exactly, also where the
  int32 sum wraps; S1 and S2 equal a Python-int oracle, also where S2
  passes 2^32;
* the expected BT formed from the sums (``core.bt.expected_bt``, what
  ``wire.measure`` and ``expected_bt_stream`` both call) equals
  ``repro.core.bt.expected_bt_stream`` (a float32 sum taken in another
  order) to rtol 1e-6;
* on a card (marked ``cuda``) the kernel equals its plain version exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
import jax.numpy as jnp  # noqa: E402
from test_torch_traffic import one_torch_thread  # noqa: E402,F401

from repro.core import bt as jbt, flits as jflits  # noqa: E402
from repro_torch.core import bt, flits  # noqa: E402
from repro_torch.core.wire import measure  # noqa: E402
from repro_torch.kernels import bt_count, ops, ref  # noqa: E402

KINDS = {"int8": 8, "int16": 16, "float32": 32, "uint32": 32}


def _values(kind, rng, n):
    if kind == "int8":
        return rng.integers(-128, 128, n).astype(np.int8)
    if kind == "int16":
        return rng.integers(-2**15, 2**15, n).astype(np.int16)
    if kind == "float32":          # half negative: bit 31 set
        return rng.standard_normal(n).astype(np.float32)
    w = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    w[:min(n, 2)] = [0x80000000, 0xFFFFFFFF][:min(n, 2)]
    return w


def _torch(a):
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    return torch.from_numpy(a.copy())


def _popcounts(a, lanes):
    """(F, lanes) int64 '1'-bit counts of the values' bit patterns."""
    u = a.view(f"u{a.dtype.itemsize}").reshape(-1, lanes)
    bits = np.unpackbits(u[..., None].view(np.uint8), axis=-1)
    return bits.sum(-1).astype(np.int64)


def _oracle(c):
    """(S1, S2) as Python ints over consecutive rows of counts ``c``."""
    x, y = c[:-1].tolist(), c[1:].tolist()
    s1 = sum(a + b for rx, ry in zip(x, y) for a, b in zip(rx, ry))
    s2 = sum(a * b for rx, ry in zip(x, y) for a, b in zip(rx, ry))
    return s1, s2


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("lanes", [1, 3, 8, 16])
@pytest.mark.parametrize("f", [1, 2, 37])
def test_bt_measure_plain_matches_reference(f, lanes, kind):
    rng = np.random.default_rng(1000 * f + 10 * lanes + len(kind))
    v = _values(kind, rng, f * lanes)
    s = flits.pack(_torch(v), lanes)
    js = jflits.pack(jnp.asarray(v), lanes)
    assert s.value_bits == KINDS[kind] and s.words.shape == (f, lanes)
    got = ops.bt_measure(s.words)
    assert got.dtype == torch.int64 and got.shape == (3,)
    total, s1, s2 = got.tolist()
    assert total == int(jbt.bt_stream(js)) == int(ops.bt_total(s.words))
    assert (s1, s2) == _oracle(_popcounts(v, lanes))
    e = bt.expected_bt(s1, s2, s.value_bits)
    np.testing.assert_allclose(e, float(jbt.expected_bt_stream(js)),
                               rtol=1e-6)
    es = bt.expected_bt_stream(s)
    assert es.dtype == torch.float32 and es.shape == () and float(es) == e
    m = measure(s)
    assert (m["total_bt"], m["expected_bt"]) == (float(total), e)
    assert bt.stream_sums(s) == (total, s1, s2)


def test_bt_total_wraps_as_the_reference_int32_sum():
    """(2^21 + 1) x 32 words alternating 0 and all-ones: 2^26 pairs of 32
    transitions each, 2^31 in all, which the int32 sum wraps to INT32_MIN;
    S1 = 2^31 and S2 = 0 (every pair holds a zero word)."""
    rows = np.zeros((2**21 + 1, 32), np.uint32)
    rows[1::2] = 0xFFFFFFFF
    words = torch.from_numpy(rows.view(np.int32))
    total, s1, s2 = ops.bt_measure(words).tolist()
    assert total == int(jbt.bt_stream(jflits.FlitStream(
        jnp.asarray(rows), 32, 32))) == -2**31
    assert (s1, s2) == (2**31, 0)


def test_bt_measure_s2_past_2_to_the_32():
    """All-ones (2^17 + 2) x 32 words: every pair adds 32 * 32 to S2, which
    reaches 2^32 + 2^15 - past any 32-bit sum - and 64 to S1; no
    transitions."""
    words = torch.full((2**17 + 2, 32), -1, dtype=torch.int32)
    pairs = (2**17 + 1) * 32
    total, s1, s2 = ops.bt_measure(words).tolist()
    assert (total, s1, s2) == (0, 64 * pairs, 1024 * pairs)
    assert s2 > 2**32
    assert bt.expected_bt(s1, s2, 32) == 0.0


def test_bt_measure_rejects_what_the_kernel_cannot_take():
    x = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bt_count.bt_measure(x)


# --- on the card -----------------------------------------------------------

cuda = pytest.mark.skipif(torch.cuda.device_count() < 1,
                          reason="needs a CUDA device")


@pytest.mark.cuda
@cuda
@pytest.mark.parametrize("f,lanes,offset", [
    (0, 8, 0), (1, 8, 0), (2, 1, 0), (37, 3, 0), (37, 16, 0), (37, 33, 0),
    (4097, 8, 1), (4097, 8, 2), (7778, 8, 0), (2**20, 8, 0),
    (2**17 + 1, 32, 0)])
def test_bt_measure_kernel_equals_plain(f, lanes, offset):
    rng = np.random.default_rng(f + lanes + offset)
    flat = torch.from_numpy(rng.integers(0, 2**32, offset + f * lanes,
                                         dtype=np.uint64)
                            .astype(np.uint32).view(np.int32))
    if f == 2**17 + 1:
        flat[:] = -1                  # all ones: S2 = 2^32
    words = flat[offset:].view(f, lanes)
    ops.reset_launch_counts()
    got = bt_count.bt_measure(flat.cuda()[offset:].view(f, lanes))
    assert bt_count.MEASURE.launches == 1 and bt_count.KERNEL.launches == 0
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref.bt_measure_ref(words))
    # The workspace is re-armed: a second launch gives the same sums.
    again = bt_count.bt_measure(flat.cuda()[offset:].view(f, lanes))
    assert torch.equal(again.cpu(), got.cpu())
