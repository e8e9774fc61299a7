"""The window sort's register layout (K4, ``csrc/bitonic_sort.cu``), pinned
on the CPU by a numpy model of what each lane of the warp does.

For 32 <= W <= 1,024 the kernel sorts a row of int32 keys on G warps (one
below 256 keys, two from 256): lane ``l`` of part ``g`` holds elements
``(g 32 + l) E .. + E - 1`` (E = W / 32 G). The key is compared signed and
strictly (a lane-dependent direction is one comparison on keys XORed with
0 or ``0xffffffff``, since ``~x = -x - 1`` reverses the signed order); with
payloads each element's index rides beside its key (or, in the layout
``tools/k4_probe.py`` times against it, in one 64-bit word ``(key ^ 2^31)
<< 32 | index`` compared on its high half), and the payloads are gathered by
the final index. A substage with ``2^j < E`` compares two of a thread's
registers, one with ``E <= 2^j < 32 E`` pairs lane ``l`` with lane ``l ^
(2^j / E)``, one above pairs part ``g`` with part ``g ^ (2^j / 32 E)``.
:func:`warp_model` runs exactly that and must equal ``ref.sort_windows_ref``
and (at W = 128 and 256) the reference's ``sort_windows_pallas``
(interpret mode) on tie-heavy
keys and on full-range keys with INT32_MIN and INT32_MAX, with two
payloads: a bitonic network is not stable, so ties pin where each element
goes. On a card (marked ``cuda``) the kernel equals its plain version at
every width and payload count, and so do the probe's layouts.
"""
import functools
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.bitonic_sort import sort_windows_pallas  # noqa: E402
from repro_torch.kernels import bitonic_sort, ops, ref  # noqa: E402

WARP_WIDTHS = [128, 256, 512, 1024]
INT32_MIN, INT32_MAX = -2**31, 2**31 - 1
FLIP = np.int32(-1)                      # every bit: reverses a > b
WIDE_FLIP = np.uint64(0xFFFFFFFF00000000)
LOW = np.uint64(0xFFFFFFFF)


def _keys(kind: str, r: int, w: int, seed: int = 0) -> np.ndarray:
    """``ties``: keys in [0, 33), as benchmarks/ordering_throughput.py makes
    them; ``full``: full-range int32 with INT32_MIN (twice) and INT32_MAX
    in every row and a run of values in [-2, 2)."""
    rng = np.random.default_rng(w + r + seed + len(kind))
    if kind == "ties":
        return rng.integers(0, 33, (r, w)).astype(np.int32)
    k = rng.integers(INT32_MIN, INT32_MAX + 1, (r, w), dtype=np.int64)
    cols = rng.permutation(w)
    k[:, cols[0]], k[:, cols[1]], k[:, cols[2]] = INT32_MIN, INT32_MAX, \
        INT32_MIN
    k[:, cols[3:9]] = rng.integers(-2, 2, (r, 6))
    return k.astype(np.int32)


def _payloads(r: int, w: int):
    rng = np.random.default_rng(r * w)
    return [rng.integers(INT32_MIN, INT32_MAX + 1, (r, w),
                         dtype=np.int64).astype(np.int32) for _ in range(2)]


def warp_model(keys: np.ndarray, payloads, parts: int = 1,
               wide: bool = False):
    """(R, W) int32 keys and payloads -> ``(keys, *payloads)`` sorted as the
    warp kernel sorts them on ``parts`` warps a row: arrays indexed (row,
    part, lane, register), element ``(part 32 + lane) E + r``."""
    r_, w = keys.shape
    e = w // (32 * parts)
    le, lt = e.bit_length() - 1, (32 * e).bit_length() - 1
    part = np.arange(parts)[None, :, None, None]
    lane = np.arange(32)[None, None, :, None]
    reg = np.arange(e)[None, None, None, :]
    index = np.broadcast_to((part * 32 + lane) * e + reg,
                            (r_, parts, 32, e)).astype(np.int64)
    k4 = keys.reshape(r_, parts, 32, e)
    if wide:
        key = (((k4.view(np.uint32) ^ np.uint32(0x80000000))
                .astype(np.uint64) << np.uint64(32))
               | index.astype(np.uint64))
        flip_word = WIDE_FLIP

        def before(a, b):
            return a > (b | LOW)
    else:
        key = k4.copy()
        flip_word = FLIP

        def before(a, b):
            return a > b
    idx = index.copy()
    zero = key.dtype.type(0)

    def high_bit(b):                  # bit b >= le of the element index
        return (lane >> (b - le)) & 1 if b < lt else (part >> (b - lt)) & 1

    def exchange(take, k_other, i_other):
        return np.where(take, k_other, key), np.where(take, i_other, idx)

    for k in range(w.bit_length() - 1):
        for j in range(k, -1, -1):
            if j < le:                       # inside the thread
                for r in range(e):
                    if r & (1 << j):
                        continue
                    q = r | (1 << j)
                    a, b = key[..., r].copy(), key[..., q].copy()
                    ia, ib = idx[..., r].copy(), idx[..., q].copy()
                    if k + 1 < le:
                        fwd = ((r >> (k + 1)) & 1) == 0
                        swap = before(b, a) if fwd else before(a, b)
                    else:                    # the lane's direction: flip
                        flip = np.where(high_bit(k + 1)[..., 0] == 0,
                                        flip_word, zero)
                        swap = before(a ^ flip, b ^ flip)
                    key[..., r], key[..., q] = (np.where(swap, b, a),
                                                np.where(swap, a, b))
                    idx[..., r], idx[..., q] = (np.where(swap, ib, ia),
                                                np.where(swap, ia, ib))
                continue
            lo = high_bit(j) == 0
            fwd = (high_bit(k + 1) == 0) if k + 1 < w.bit_length() - 1 \
                else np.ones_like(lo)
            flip = np.where(fwd == lo, flip_word, zero)
            if j < lt:                       # across lanes, same register
                sel = (slice(None), slice(None),
                       np.arange(32) ^ (1 << (j - le)), slice(None))
            else:                            # across warps, same lane
                sel = (slice(None), np.arange(parts) ^ (1 << (j - lt)),
                       slice(None), slice(None))
            take = before(key ^ flip, key[sel] ^ flip)
            key, idx = exchange(take, key[sel], idx[sel])
    if wide:
        out_keys = ((key >> np.uint64(32)).astype(np.uint32)
                    ^ np.uint32(0x80000000)).view(np.int32)
        idx = (key & LOW).astype(np.int64)
    else:
        out_keys = key
    perm = idx.reshape(r_, w)
    return (out_keys.reshape(r_, w),
            *(np.take_along_axis(p, perm, axis=1) for p in payloads))


# Widths held to the Pallas kernel too (each width is one interpret-mode
# compile of a few seconds): one warp's E = 4 and two warps' first
# across-warp substages. The plain version is held to it in
# test_torch_sort.py up to W = 512.
PALLAS_WIDTHS = (128, 256)


@functools.lru_cache(maxsize=None)
def _references(kind: str, w: int):
    """The plain version's outputs on 8 rows of ``kind`` keys and two
    payloads, and the Pallas kernel's at PALLAS_WIDTHS, once for every
    layout."""
    keys, pays = _keys(kind, 8, w), _payloads(8, w)
    want = [t.numpy() for t in ref.sort_windows_ref(
        torch.from_numpy(keys), *(torch.from_numpy(p) for p in pays))]
    if w not in PALLAS_WIDTHS:
        return want, want
    got = sort_windows_pallas(jnp.asarray(keys),
                              *(jnp.asarray(p) for p in pays),
                              interpret=True)
    return want, [np.asarray(t) for t in got]


@pytest.mark.parametrize("w", WARP_WIDTHS)
@pytest.mark.parametrize("kind", ["ties", "full"])
@pytest.mark.parametrize("layout", ["one warp", "two warps", "wide word"])
def test_warp_model_equals_plain_and_pallas(layout, kind, w):
    parts = 2 if layout == "two warps" else 1
    got = warp_model(_keys(kind, 8, w), _payloads(8, w), parts,
                     wide=layout == "wide word")
    want, pallas = _references(kind, w)
    for g, v, j in zip(got, want, pallas):
        np.testing.assert_array_equal(g, v)
        np.testing.assert_array_equal(g, j)


def test_flip_reverses_signed_before():
    """XOR with every bit reverses the signed order, INT32_MIN and
    INT32_MAX included; the wide word's flip reverses its high halves."""
    rng = np.random.default_rng(5)
    a = rng.integers(INT32_MIN, INT32_MAX + 1, 4096,
                     dtype=np.int64).astype(np.int32)
    b = rng.integers(INT32_MIN, INT32_MAX + 1, 4096,
                     dtype=np.int64).astype(np.int32)
    a[:4] = [INT32_MIN, INT32_MAX, INT32_MIN, 0]
    b[:4] = [INT32_MAX, INT32_MIN, INT32_MIN, -1]
    np.testing.assert_array_equal((a ^ FLIP) > (b ^ FLIP), b > a)
    wa = ((a.view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64)
          << np.uint64(32)) | np.uint64(7)
    wb = ((b.view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64)
          << np.uint64(32)) | np.uint64(3)
    np.testing.assert_array_equal(wa > (wb | LOW), a > b)
    np.testing.assert_array_equal((wa ^ WIDE_FLIP) > ((wb ^ WIDE_FLIP) | LOW),
                                  b > a)


# --- on the card -----------------------------------------------------------

cuda = pytest.mark.skipif(torch.cuda.device_count() < 1,
                          reason="needs a CUDA device")


@pytest.mark.cuda
@cuda
@pytest.mark.parametrize("w", [32, 64] + WARP_WIDTHS + [2048])
@pytest.mark.parametrize("kind", ["ties", "full"])
@pytest.mark.parametrize("n_pay", [0, 1, 2])
@pytest.mark.parametrize("rows", [37, 2201])
def test_window_sort_kernel_equals_plain(rows, n_pay, kind, w):
    """Rows that do not fill the last block (four warps a block), every
    payload count, both key ranges; W = 2,048 takes the shared network."""
    keys = torch.from_numpy(_keys(kind, rows, w))
    pays = [torch.from_numpy(p) for p in _payloads(rows, w)[:n_pay]]
    ops.reset_launch_counts()
    got = bitonic_sort.sort_windows(keys.cuda(), *(p.cuda() for p in pays))
    assert bitonic_sort.KERNEL.launches == 1
    torch.cuda.synchronize()
    want = ref.sort_windows_ref(keys, *pays)
    assert len(got) == 1 + n_pay
    for g, v in zip(got, want):
        assert torch.equal(g.cpu(), v)


@pytest.mark.cuda
@cuda
def test_window_sort_kernel_off_alignment():
    """Arrays 4 bytes off 16-byte alignment take the shared-memory
    network."""
    keys = torch.from_numpy(_keys("full", 65, 256))
    pay = torch.from_numpy(_payloads(65, 256)[0])
    buf = torch.empty((2, 65 * 256 + 1), dtype=torch.int32, device="cuda")
    k_off, p_off = buf[0, 1:].view(65, 256), buf[1, 1:].view(65, 256)
    k_off.copy_(keys)
    p_off.copy_(pay)
    got = bitonic_sort.sort_windows(k_off, p_off)
    torch.cuda.synchronize()
    for g, v in zip(got, ref.sort_windows_ref(keys, pay)):
        assert torch.equal(g.cpu(), v)


@functools.lru_cache(maxsize=None)
def _k4_probe():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "k4_probe.py")
    spec = importlib.util.spec_from_file_location("k4_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@cuda
@pytest.mark.parametrize("w", WARP_WIDTHS)
@pytest.mark.parametrize("kind", ["ties", "full"])
@pytest.mark.parametrize("layout", ["shared", "index_one_warp",
                                    "index_two_warps", "wide_one_warp",
                                    "wide_two_warps"])
def test_probe_layouts_equal_plain(layout, kind, w):
    keys = torch.from_numpy(_keys(kind, 37, w))
    pay = torch.from_numpy(_payloads(37, w)[0])
    got = _k4_probe().run_layout(layout, keys.cuda(), pay.cuda())
    torch.cuda.synchronize()
    for g, v in zip(got, ref.sort_windows_ref(keys, pay)):
        assert torch.equal(g.cpu(), v)
