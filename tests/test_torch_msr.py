"""Port parity: ``repro_torch.core.msr`` (the MSR 8b -> 5b codec) against
``repro.core.msr`` and the port's own numpy oracles.

* the exhaustive 256-value int8 and uint8 round trip at several windows;
* ``compress`` equal, bit for bit, to the port's ``compress_reference`` and
  to the reference's;
* the geometry helpers and ``msr_pack`` / ``msr_pack_paired`` words equal
  to the reference's for lanes 2-16 and n in {1, 5, 16, 63, 64, 257};
* the row-batched packers equal to packing row by row;
* ``escape_bits``, ``outlier_mask`` and the stream overhead equal to the
  reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")

from repro.core import msr as jmsr  # noqa: E402
from repro.core import wire as jwire  # noqa: E402
from repro_torch.core import msr, wire  # noqa: E402

from test_torch_traffic import one_torch_thread  # noqa: E402,F401

ALL = np.arange(256, dtype=np.uint8)
LANES = (2, 4, 6, 8, 10, 12, 14, 16)
COUNTS = (1, 5, 16, 63, 64, 257)


@pytest.mark.parametrize("dtype", [np.int8, np.uint8])
@pytest.mark.parametrize("window", [1, 7, 16, 64, 256, 300])
def test_exhaustive_round_trip_and_oracles(dtype, window):
    vals = ALL.view(dtype)
    comp = msr.compress(torch.from_numpy(vals.copy()), window)
    back = msr.decompress(comp)
    assert back.dtype == torch.from_numpy(vals).dtype
    np.testing.assert_array_equal(back.numpy(), vals)
    own = msr.compress_reference(vals, window)
    theirs = jmsr.compress_reference(vals, window)
    for got, a, b in ((comp.codes, own.codes, theirs.codes),
                      (comp.outlier, own.outlier, theirs.outlier),
                      (comp.top, own.top, theirs.top)):
        np.testing.assert_array_equal(got.numpy(), a)
        np.testing.assert_array_equal(a, b)
    assert (comp.window, comp.count, comp.shape, comp.dtype) == (
        own.window, own.count, own.shape, own.dtype)
    np.testing.assert_array_equal(msr.decompress_reference(own), vals)
    assert comp.overhead_bits() == theirs.overhead_bits()
    # outliers are exactly the values outside [-16, 15] on the int8 view
    i8 = ALL.view(np.int8)
    np.testing.assert_array_equal(msr.outlier_mask(
        torch.from_numpy(vals.copy())).numpy(), (i8 < -16) | (i8 > 15))


def test_compress_keeps_shape_and_pads_windows():
    rng = np.random.default_rng(3)
    x = rng.integers(-128, 128, (5, 7)).astype(np.int8)
    comp = msr.compress(torch.from_numpy(x), 8)
    assert comp.codes.shape == (5, 8) and comp.count == 35
    np.testing.assert_array_equal(msr.decompress(comp).numpy(), x)
    np.testing.assert_array_equal(comp.codes.numpy(),
                                  jmsr.compress_reference(x, 8).codes)
    with pytest.raises(ValueError, match="window"):
        msr.compress(torch.from_numpy(x), 0)
    with pytest.raises(TypeError, match="int8"):
        msr.compress(torch.zeros(4), 2)


def test_geometry_and_packing_match_reference():
    rng = np.random.default_rng(0)
    for lanes in LANES:
        for n in COUNTS:
            v = rng.integers(-128, 128, n).astype(np.int8)
            w = rng.integers(-128, 128, n).astype(np.int8)
            assert (msr.compressed_payload_flits(n, lanes)
                    == jmsr.compressed_payload_flits(n, lanes))
            assert (msr.compressed_paired_payload_flits(n, lanes)
                    == jmsr.compressed_paired_payload_flits(n, lanes))
            assert msr.compressed_bytes(n) == jmsr.compressed_bytes(n)
            got = msr.msr_pack(torch.from_numpy(v), lanes)
            want = jmsr.msr_pack_reference(v, lanes)
            assert got.words.dtype == torch.uint8 and got.value_bits == 8
            np.testing.assert_array_equal(got.words.numpy(), want)
            np.testing.assert_array_equal(msr.msr_pack_reference(v, lanes),
                                          want)
            got = msr.msr_pack_paired(torch.from_numpy(v),
                                      torch.from_numpy(w), lanes)
            want = jmsr.msr_pack_paired_reference(v, w, lanes)
            np.testing.assert_array_equal(got.words.numpy(), want)
            np.testing.assert_array_equal(
                msr.msr_pack_paired_reference(v, w, lanes), want)
            # the codes come back from the dense bytes
            data = got.words[:, :lanes // 2].reshape(-1).numpy()
            np.testing.assert_array_equal(
                msr.unpack_codes_reference(data, n),
                jmsr.unpack_codes_reference(data, n))
            np.testing.assert_array_equal(
                msr.unpack_codes_reference(data, n), v.view(np.uint8) & 31)
    # and the reference's jitted packers on one shape
    v = rng.integers(-128, 128, 257).astype(np.int8)
    w = rng.integers(-128, 128, 257).astype(np.int8)
    np.testing.assert_array_equal(
        msr.msr_pack(torch.from_numpy(v), 16).words.numpy(),
        np.asarray(jmsr.msr_pack(v, 16).words))
    np.testing.assert_array_equal(
        msr.msr_pack_paired(torch.from_numpy(v), torch.from_numpy(w),
                            16).words.numpy(),
        np.asarray(jmsr.msr_pack_paired(v, w, 16).words))
    arr = np.array([0, 1, 17, 64, 257])
    np.testing.assert_array_equal(msr.compressed_payload_flits(arr, 16),
                                  jmsr.compressed_payload_flits(arr, 16))
    with pytest.raises(ValueError, match="even"):
        msr.msr_pack_paired(torch.zeros(3, dtype=torch.int8),
                            torch.zeros(3, dtype=torch.int8), 5)


def test_row_batched_packing_equals_per_row():
    rng = np.random.default_rng(1)
    for lanes, k in ((16, 27), (16, 150), (8, 7), (4, 64), (2, 1)):
        x = torch.from_numpy(rng.integers(-128, 128, (9, k)).astype(np.int8))
        y = torch.from_numpy(rng.integers(0, 256, (9, k)).astype(np.uint8))
        rows = msr.msr_pack_rows(x, lanes)
        prow = msr.msr_pack_paired_rows(x, y, lanes)
        assert rows.dtype == prow.dtype == torch.int32
        for i in range(9):
            np.testing.assert_array_equal(
                rows[i].numpy(), msr.msr_pack(x[i], lanes).words.numpy())
            np.testing.assert_array_equal(
                prow[i].numpy(),
                msr.msr_pack_paired(x[i], y[i], lanes).words.numpy())


def test_escape_bits_and_overheads_match_reference():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((40, 27)) * 12).astype(np.int8)
    for window in (27, 32, 400):
        assert (msr.escape_bits(torch.from_numpy(x), window)
                == jmsr.escape_bits(x, window))
        flat = x.reshape(-1)
        assert (msr.escape_bits(torch.from_numpy(flat), window)
                == jmsr.escape_bits(flat, window))
        assert (wire.compression_overhead_bits("msr", torch.from_numpy(x),
                                               window)
                == jwire.compression_overhead_bits("msr", x, window))
    assert wire.compression_overhead_bits("none", torch.from_numpy(x),
                                          27) == 0
    assert msr.escape_bits(torch.zeros(0, dtype=torch.int8), 8) == 0
    for window, nw, no in ((1, 3, 2), (64, 10, 0), (300, 1, 17)):
        assert (msr.msr_stream_overhead_bits(window, nw, no)
                == jmsr.msr_stream_overhead_bits(window, nw, no))
        assert (msr.msr_overhead_bits(window, no)
                == jmsr.msr_overhead_bits(window, no))
    with pytest.raises(ValueError, match="fit"):
        msr.escape_bits(torch.from_numpy(x), 16)
    with pytest.raises(KeyError, match="compression"):
        wire.compression_overhead_bits("zip", torch.from_numpy(x), 27)
    assert wire.COMPRESSIONS == jwire.COMPRESSIONS
