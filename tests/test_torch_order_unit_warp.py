"""The ordering unit's warp layout (K5, ``csrc/order_unit.cu``), pinned on
the CPU by a numpy model of what each lane of the warp does.

For 32 <= W <= 1,024 the kernel sorts a row on G warps (one below 256
words, two from 256): lane ``l`` of part ``g`` holds elements ``(g 32 + l)
E .. + E - 1`` (E = W / 32 G) as the key word ``(popcount << 16) | index``;
a substage with ``2^j < E`` compares two of a thread's registers, one with
``E <= 2^j < 32 E`` pairs lane ``l`` with lane ``l ^ (2^j / E)`` (same
register), one above pairs part ``g`` with part ``g ^ (2^j / 32 E)`` (same
lane and register), and each partner reaches the decision on its own from
bit k+1 of the element index; the values are gathered from the row by the
final indices. :func:`warp_model` runs exactly that, lane by lane, on one
and on two warps a row, and must equal ``ref.order_unit_ref`` and the
reference's ``order_unit_pallas`` (interpret mode) on tie-heavy rows: a
bitonic network is not stable, so ties pin the index mapping itself. On a
card (marked ``cuda``) the kernel equals its plain version on the same
rows (one warp a row, two, and the shared-memory path at W = 2,048), and
so do ``warp_bitonic``'s payload layouts that ``tools/k5_probe.py`` builds
(the value as a second register; the value and the index as two).
"""
import functools
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.order_unit import order_unit_pallas  # noqa: E402
from repro_torch.kernels import order_unit, ops, ref  # noqa: E402

WARP_WIDTHS = [128, 256, 512, 1024]


def _popcount(u):
    return np.unpackbits(u.view(np.uint8)).reshape(u.shape + (32,)).sum(
        -1).astype(np.int64)


def _before(a, b):
    """Key word ``a`` strictly precedes ``b``: a higher popcount (the high
    half)."""
    return a > (b | 0xFFFF)


# XORed into both words, reverses _before: _before(a ^ FLIP, b ^ FLIP) ==
# _before(b, a). The kernel compares a lane-dependent direction this way.
FLIP = 0xFFFF0000


def warp_model(words: np.ndarray, parts: int = 1):
    """(R, W) uint32 -> (ordered words, permutation int32), computed as the
    warp kernel computes it on ``parts`` warps a row: arrays indexed (row,
    part, lane, register), element ``(part 32 + lane) E + r``."""
    r_, w = words.shape
    e = w // (32 * parts)
    le, lt = e.bit_length() - 1, (32 * e).bit_length() - 1
    part = np.arange(parts)[None, :, None, None]
    lane = np.arange(32)[None, None, :, None]
    reg = np.arange(e)[None, None, None, :]
    key = ((_popcount(words).reshape(r_, parts, 32, e) << 16)
           | ((part * 32 + lane) * e + reg))

    def high_bit(b):                  # bit b >= le of the element index
        return (lane >> (b - le)) & 1 if b < lt else (part >> (b - lt)) & 1

    for k in range(w.bit_length() - 1):
        for j in range(k, -1, -1):
            if j < le:                       # inside the thread
                for r in range(e):
                    if r & (1 << j):
                        continue
                    q = r | (1 << j)
                    a, b = key[..., r].copy(), key[..., q].copy()
                    if k + 1 < le:
                        fwd = ((r >> (k + 1)) & 1) == 0
                        swap = _before(b, a) if fwd else _before(a, b)
                    else:                    # the lane's direction: flip
                        flip = np.where(high_bit(k + 1)[..., 0] == 0, FLIP, 0)
                        swap = _before(a ^ flip, b ^ flip)
                    key[..., r] = np.where(swap, b, a)
                    key[..., q] = np.where(swap, a, b)
                continue
            lo = high_bit(j) == 0
            fwd = high_bit(k + 1) == 0
            flip = np.where(fwd == lo, FLIP, 0)
            if j < lt:                       # across lanes, same register
                other = key[:, :, np.arange(32) ^ (1 << (j - le)), :]
            else:                            # across warps, same lane
                other = key[:, np.arange(parts) ^ (1 << (j - lt)), :, :]
            take = _before(key ^ flip, other ^ flip)
            key = np.where(take, other, key)
    perm = (key & 0xFFFF).reshape(r_, w).astype(np.int32)
    return np.take_along_axis(words, perm, axis=1), perm


def _tie_heavy(rng, r, w):
    """Rows of few distinct popcounts: row 0 of a single popcount (distinct
    words, so the permutation shows where each went), the others drawn
    from a pool of 12 words with 3 popcounts, bit 31 set in some."""
    pool = np.array([0x0000000F, 0x80000007, 0x00F00000, 0xF0000000,
                     0x000003FF, 0x800001FF, 0x3FF00000, 0xFFC00000,
                     0x00000000, 0x00000000, 0xFFFFFFFF, 0x7FFFFFFF],
                    np.uint32)
    rows = rng.choice(pool, (r, w))
    bits = np.argsort(rng.random((w, 32)), axis=1)[:, :7]
    rows[0] = (np.uint32(1) << bits.astype(np.uint32)).sum(
        axis=1, dtype=np.uint64).astype(np.uint32)
    assert len(set(_popcount(rows[0]))) == 1
    return rows


def _random(rng, r, w):
    return rng.integers(0, 2**32, (r, w), dtype=np.uint64).astype(np.uint32)


def _words(kind, w, rows=8, seed=0):
    rng = np.random.default_rng(w + len(kind) + seed)
    return (_tie_heavy if kind == "ties" else _random)(rng, rows, w)


@functools.lru_cache(maxsize=None)
def _references(kind, w):
    """The plain version's and the Pallas kernel's outputs on ``_words(kind,
    w)``, once for both warp counts."""
    words = _words(kind, w)
    want_out, want_perm = ref.order_unit_ref(
        torch.from_numpy(words.view(np.int32)))
    jout, jperm = order_unit_pallas(jnp.asarray(words), interpret=True)
    return (want_out.numpy().view(np.uint32), want_perm.numpy(),
            np.asarray(jout), np.asarray(jperm))


@pytest.mark.parametrize("w", WARP_WIDTHS)
@pytest.mark.parametrize("kind", ["ties", "random"])
@pytest.mark.parametrize("parts", [1, 2])
def test_warp_model_equals_plain_and_pallas(parts, kind, w):
    out, perm = warp_model(_words(kind, w), parts)
    want_out, want_perm, jout, jperm = _references(kind, w)
    np.testing.assert_array_equal(out, want_out)
    np.testing.assert_array_equal(perm, want_perm)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(perm, jperm)


def test_flip_reverses_before():
    rng = np.random.default_rng(3)
    a = (rng.integers(0, 33, 4096) << 16) | rng.integers(0, 1024, 4096)
    b = (rng.integers(0, 33, 4096) << 16) | rng.integers(0, 1024, 4096)
    np.testing.assert_array_equal(_before(a ^ FLIP, b ^ FLIP), _before(b, a))


# --- on the card -----------------------------------------------------------

cuda = pytest.mark.skipif(torch.cuda.device_count() < 1,
                          reason="needs a CUDA device")


@pytest.mark.cuda
@cuda
@pytest.mark.parametrize("w", [32, 64] + WARP_WIDTHS + [2048])
@pytest.mark.parametrize("kind", ["ties", "random"])
@pytest.mark.parametrize("rows", [37, 2200])
def test_order_unit_kernel_equals_plain(rows, kind, w):
    """A few rows and many (four warps a scheduler on 132 SMs at W < 256):
    the warps' row-bound guards either way."""
    words = torch.from_numpy(_words(kind, w, rows, rows).view(np.int32))
    ops.reset_launch_counts()
    out, perm = order_unit.order_unit_words(words.cuda())
    assert order_unit.KERNEL.launches == 1
    torch.cuda.synchronize()
    want_out, want_perm = ref.order_unit_ref(words)
    assert torch.equal(out.cpu(), want_out)
    assert torch.equal(perm.cpu(), want_perm)


@functools.lru_cache(maxsize=None)
def _k5_probe():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "k5_probe.py")
    spec = importlib.util.spec_from_file_location("k5_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@cuda
@pytest.mark.parametrize("w", WARP_WIDTHS)
@pytest.mark.parametrize("kind", ["ties", "random"])
@pytest.mark.parametrize("layout", ["value_register", "reference_layout"])
def test_warp_bitonic_payloads_equal_plain(layout, kind, w):
    """``warp_bitonic`` with one payload (the value beside the key word)
    and with two (the value and the index beside the popcount): the
    reference's swaps, ties included."""
    words = torch.from_numpy(_words(kind, w, 37, 1).view(np.int32))
    out, perm = _k5_probe().run_layout(layout, words.cuda())
    torch.cuda.synchronize()
    want_out, want_perm = ref.order_unit_ref(words)
    assert torch.equal(out.cpu(), want_out)
    assert torch.equal(perm.cpu(), want_perm)
