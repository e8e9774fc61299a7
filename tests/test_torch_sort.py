"""Port parity: the plain versions of the window sort (K4), the ordering
unit (K5) and the chain select (K6) against the reference's Pallas kernels
in interpret mode, on the same numpy inputs, bit for bit. Keys are
tie-heavy (popcounts in [0, 33)): a bitonic network is not stable, so this
pins the network itself, not just a sorted multiset."""
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
import jax.numpy as jnp  # noqa: E402
from test_torch_traffic import one_torch_thread  # noqa: E402,F401

from repro.kernels import order_unit as jorder_unit  # noqa: E402
from repro.kernels import sort_windows_desc as jsort  # noqa: E402
from repro.kernels.min_hamming import chain_select_pallas  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

_TORCH = {np.int8: torch.int8, np.int32: torch.int32,
          np.uint32: torch.uint32, np.float32: torch.float32}


def _t(a):
    """numpy -> torch of the same dtype (uint32 through its int32 bits)."""
    dt = _TORCH[a.dtype.type]
    if dt == torch.uint32:
        return torch.from_numpy(a.view(np.int32)).view(torch.uint32)
    return torch.from_numpy(a)


def _bits(x):
    """torch or numpy values -> numpy unsigned bit patterns."""
    a = x.view(torch.int32).numpy() if isinstance(x, torch.Tensor) and \
        x.dtype == torch.uint32 else np.asarray(x)
    return a.view(f"u{a.dtype.itemsize}")


def _payload(kind, rng, shape):
    if kind == "int8":
        return rng.integers(-128, 128, shape).astype(np.int8)
    if kind == "float32":     # negative floats: bit 31 set
        return (rng.standard_normal(shape).astype(np.float32)
                * rng.choice(np.float32([-1, 1]), shape))
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("w", [128, 256, 512])
@pytest.mark.parametrize("kinds", [(), ("int8",), ("float32",),
                                   ("int8", "float32")])
def test_sort_windows_desc_matches_pallas(w, kinds):
    rng = np.random.default_rng(w + 7 * len(kinds))
    r = 5 + w // 32               # never a multiple of the TPU's 8-row tile
    keys = rng.integers(0, 33, (r, w)).astype(np.int32)
    pays = [_payload(k, rng, (r, w)) for k in kinds]
    want = jsort(jnp.asarray(keys), *(jnp.asarray(p) for p in pays))
    got = ops.sort_windows_desc(torch.from_numpy(keys),
                                *(_t(p) for p in pays))
    assert len(got) == len(want) == 1 + len(pays)
    assert got[0].dtype == torch.int32
    for g, v, p in zip(got[1:], want[1:], pays):
        assert g.dtype == _TORCH[p.dtype.type]
    for g, v in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(np.asarray(v)))


def test_sort_windows_desc_rejects_bad_windows():
    keys = torch.zeros((2, 100), dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        ops.sort_windows_desc(keys)
    with pytest.raises(ValueError, match="power of two"):
        ops.sort_windows_desc(torch.zeros((2, 64), dtype=torch.int32))
    with pytest.raises(ValueError, match="payload shape"):
        ops.sort_windows_desc(torch.zeros((2, 128), dtype=torch.int32),
                              torch.zeros((2, 256), dtype=torch.int32))


@pytest.mark.parametrize("dtype,r,w", [(np.uint32, 10, 256),
                                       (np.int32, 3, 128),
                                       (np.float32, 10, 256)])
def test_order_unit_matches_pallas(dtype, r, w):
    rng = np.random.default_rng(r * w)
    u = rng.integers(0, 2**32, (r, w), dtype=np.uint64).astype(np.uint32)
    u[:, ::4] = u[:, 1::4]        # repeated words: popcount ties
    u[0, :3] = [0, 0xFFFFFFFF, 0x80000000]
    v = u.view(dtype)
    jout, jperm = jorder_unit(jnp.asarray(v))
    out, perm = ops.order_unit(_t(v))
    assert out.dtype == _TORCH[dtype] and perm.dtype == torch.int32
    np.testing.assert_array_equal(_bits(out), _bits(np.asarray(jout)))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))


def test_order_unit_refuses_narrow_dtypes():
    """The reference returns (R, W, 4) for 8-bit input (ROADMAP C8); the
    port raises instead of copying that."""
    with pytest.raises(TypeError, match="C8"):
        ops.order_unit(torch.zeros((2, 128), dtype=torch.int8))
    with pytest.raises(TypeError, match="C8"):
        ops.order_unit(torch.zeros((2, 128), dtype=torch.uint8))


@pytest.mark.parametrize("r,w,planes", [(1, 4, 1), (3, 17, 1), (5, 130, 2),
                                        (8, 128, 1), (2, 300, 2),
                                        (3, 400, 2)])
def test_chain_select_matches_pallas(r, w, planes):
    rng = np.random.default_rng(r * 1000 + w + planes)
    xors = [rng.integers(0, 2**32, (r, w), dtype=np.uint64).astype(np.uint32)
            for _ in range(planes)]
    penalty = rng.choice(np.array([0, 1 << 28, 1 << 30, (1 << 30) + (1 << 28)],
                                  np.int32), (r, w)).astype(np.int32)
    jd, jo = chain_select_pallas([jnp.asarray(x) for x in xors],
                                 jnp.asarray(penalty))
    dvec, order = ops.chain_select([_t(x) for x in xors],
                                   torch.from_numpy(penalty))
    assert dvec.dtype == order.dtype == torch.int32
    np.testing.assert_array_equal(dvec.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jo))
