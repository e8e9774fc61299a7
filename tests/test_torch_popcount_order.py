"""The popcount window-order kernel's two entry points and their plain
versions (``ops.descending_perm_rows``, ``ops.chain_inputs``).

* on CPU tensors: ``ordering.descending_perm`` (the plain
  ``descending_perm_rows_ref``) equals live ``repro.core.ordering``'s
  exactly - float32, fixed8 (int8) and bf16 values, both tiebreaks,
  windows 1-400, tie-heavy rows, all-zero windows, the zero tail the
  padding adds and words with the top bit set; ``chain_inputs_ref``
  equals a numpy oracle of the reference's ``_chain_window`` preamble
  (``repro/kernels/min_hamming.py``) on 1-2 planes, z = 0, z <= starts
  and W = 1; the identity that lets the kernel take the start ranks from
  the same pass as the partition; dispatch and argument checks;
* on a CUDA card (marked ``cuda``) each entry point equals its plain
  version on the same cases and at W = 4,096, 16,000 and ~62,000 (the
  whole-stream window of the no-NoC path, whose buffers live in device
  scratch), and on (1, 0) shapes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
from repro_torch.core import ordering  # noqa: E402
from repro_torch.kernels import ops, popcount_order, ref  # noqa: E402

PRECS = ("float32", "fixed8", "bf16")
_UNSIGNED = {"float32": np.uint32, "fixed8": np.uint8, "bf16": np.uint16}


def _patterns(prec, n, seed):
    """n tie-heavy bit patterns of ``prec``'s width (unsigned numpy): a few
    distinct values, half of them with the top bit set (negative floats,
    negative int8), one window's worth of zeros."""
    rng = np.random.default_rng(seed)
    ut = _UNSIGNED[prec]
    nb = np.dtype(ut).itemsize * 8
    pool = rng.integers(0, 2**nb, 12, dtype=np.uint64).astype(ut)
    pool[:4] |= ut(1 << (nb - 1))
    pool[4] = 0
    a = rng.choice(pool, n)
    a[: min(n, 7)] = 0
    return a


def _torch_values(prec, u):
    t = torch.from_numpy(u.view({np.uint32: np.float32, np.uint8: np.int8,
                                 np.uint16: np.int16}[u.dtype.type]).copy())
    return t.view(torch.bfloat16) if prec == "bf16" else t


def _jax_values(prec, u):
    import jax
    import jax.numpy as jnp
    if prec == "bf16":
        return jax.lax.bitcast_convert_type(jnp.asarray(u), jnp.bfloat16)
    return jnp.asarray(u.view(np.float32 if prec == "float32" else np.int8))


@pytest.mark.parametrize("window", [1, 25, 150, 400])
@pytest.mark.parametrize("tiebreak", ["stable", "pattern"])
@pytest.mark.parametrize("prec", PRECS)
def test_descending_perm_plain_equals_reference(prec, tiebreak, window):
    from repro.core import ordering as jord
    # Three and a half windows: the last is padded with zeros.
    u = _patterns(prec, 3 * window + (window + 1) // 2, seed=window)
    got = ordering.descending_perm(_torch_values(prec, u), window, tiebreak)
    want = np.asarray(jord.descending_perm(_jax_values(prec, u), window,
                                           tiebreak))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def _np_popcount(x):
    x = x.astype(np.uint64)
    return np.array([bin(int(v)).count("1") for v in x.ravel()],
                    np.int64).reshape(x.shape)


def _oracle_chain_inputs(u, starts):
    """numpy mirror of the reference's ``_chain_window`` preamble, window
    by window: pops, z, the stable zeros-to-tail partition, the
    partitioned planes, the identity cost and ``dperm[(s z) // S]``."""
    p, r, w = u.shape
    parts, qs, zs, cids, sps = [], [], [], [], []
    for i in range(r):
        pops = _np_popcount(u[:, i]).sum(0)
        nz = pops > 0
        z = int(nz.sum())
        part = np.argsort(np.where(nz, 0, 1), kind="stable")
        q = u[:, i, part]
        cid = int(_np_popcount(q[:, :-1] ^ q[:, 1:]).sum()) if w > 1 else 0
        dperm = np.argsort(-pops[part], kind="stable")
        ranks = (np.arange(starts, dtype=np.int64) * z) // starts
        parts.append(part)
        qs.append(q)
        zs.append(z)
        cids.append(cid)
        sps.append(dperm[ranks])
    return (np.stack(parts), np.stack(qs, axis=1), np.array(zs, np.int32),
            np.array(cids, np.int32), np.stack(sps))


def _chain_case(seed, planes, r, w, live):
    """(P, R, W) uint32 planes; ``live`` per row is its count of non-zero
    positions, scattered over the row (bit 31 set on a third of them)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2**32, (planes, r, w), dtype=np.uint64).astype(
        np.uint32)
    u[:, :, ::3] |= np.uint32(0x80000000)
    for i in range(r):
        dead = rng.permutation(w)[: w - min(live[i], w)]
        u[:, i, dead] = 0
    if planes == 2:   # a position live in one plane only is still live
        u[1, :, 1::4] = 0
    return u


CHAIN_CASES = [
    # (planes, r, w, live per row, starts)
    (1, 3, 1, [0, 1, 1], 8),            # W = 1: cid 0
    (2, 3, 1, [1, 0, 1], 8),
    (1, 4, 31, [0, 0, 31, 5], 8),       # z = 0, z <= starts
    (2, 4, 31, [3, 8, 0, 31], 8),
    (1, 3, 152, [152, 100, 7], 8),      # conv2's padded window
    (2, 3, 152, [9, 152, 0], 8),
    (2, 2, 40, [40, 12], 3),            # other start counts
    (1, 2, 40, [40, 2], 1),
]


@pytest.mark.parametrize("planes,r,w,live,starts", CHAIN_CASES)
def test_chain_inputs_plain_equals_oracle(planes, r, w, live, starts):
    u = _chain_case(w + planes, planes, r, w, live)
    got = ops.chain_inputs(torch.from_numpy(u.view(np.int32)), starts)
    want = _oracle_chain_inputs(u, starts)
    dtypes = (torch.int64, torch.int32, torch.int32, torch.int32, torch.int64)
    for g, wnt, dt in zip(got, want, dtypes):
        assert g.dtype == dt
        np.testing.assert_array_equal(
            g.numpy().view(np.uint32) if g.dtype == torch.int32
            and g.dim() == 3 else g.numpy(), wnt)


@pytest.mark.parametrize("seed", range(6))
def test_start_ranks_from_the_partition_pass(seed):
    # The kernel's identity: a count group is all live or all zero, and the
    # partition keeps the order inside each, so the stable descending-count
    # order of the original row, mapped through the inverse partition, is
    # the stable descending-count order of the partitioned row.
    rng = np.random.default_rng(seed)
    w = int(rng.integers(1, 200))
    pops = rng.choice(np.array([0, 0, 1, 3, 3, 9, 64]), w)
    part = np.argsort(np.where(pops > 0, 0, 1), kind="stable")
    inv = np.empty(w, np.int64)
    inv[part] = np.arange(w)
    order = np.argsort(-pops, kind="stable")
    np.testing.assert_array_equal(
        inv[order], np.argsort(-pops[part], kind="stable"))


def test_cpu_tensors_take_the_plain_versions():
    ops.reset_launch_counts()
    u = _chain_case(0, 2, 3, 40, [40, 3, 0])
    rows = torch.from_numpy(_patterns("float32", 120, 1).view(np.int32)
                            ).reshape(3, 40)
    assert torch.equal(ops.descending_perm_rows(rows, "pattern", 32),
                       ref.descending_perm_rows_ref(rows, "pattern", 32))
    for g, w_ in zip(ops.chain_inputs(torch.from_numpy(u.view(np.int32)), 8),
                     ref.chain_inputs_ref(torch.from_numpy(u.view(np.int32)),
                                          8)):
        assert torch.equal(g, w_)
    assert all(k.launches == 0 for k in popcount_order.KERNELS)
    # The kernel wrappers take CUDA tensors only.
    with pytest.raises(ValueError, match="CUDA"):
        popcount_order.descending_perm(rows, "stable", 32)
    with pytest.raises(ValueError, match="CUDA"):
        popcount_order.chain_inputs(torch.from_numpy(u.view(np.int32)), 8)


def test_bad_arguments_raise():
    rows = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.descending_perm_rows(rows.reshape(-1), "stable", 32)
    with pytest.raises(ValueError):
        ops.descending_perm_rows(rows.to(torch.int64), "stable", 32)
    with pytest.raises(ValueError, match="nbits"):
        ops.descending_perm_rows(rows, "stable", 12)
    with pytest.raises(ValueError, match="tiebreak"):
        ops.descending_perm_rows(rows, "bits", 32)
    u = torch.zeros((3, 2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.chain_inputs(u, 8)
    with pytest.raises(ValueError):
        ops.chain_inputs(u[:2].to(torch.int64), 8)
    with pytest.raises(ValueError, match="W >= 1"):
        ops.chain_inputs(u[:1, :, :0], 8)
    with pytest.raises(ValueError, match="starts"):
        ops.chain_inputs(u[:1], 0)
    with pytest.raises(ValueError, match="width 40000"):
        popcount_order.layout("chain", 40000, 2)


def test_layout_fits_a_block():
    from repro_torch.kernels._build import SMEM_BYTES
    for kind, w in (("stable", 25), ("pattern", 150), ("pattern", 400),
                    ("stable", 4096), ("pattern", 16000), ("chain", 152),
                    ("chain", 16000)):
        lay = popcount_order.layout(kind, w, 2)
        assert lay.in_smem and lay.smem_bytes <= SMEM_BYTES
        assert lay.rows * lay.warps * 32 <= 1024
    # The no-NoC path's whole-stream window keeps its buffers in scratch.
    lay = popcount_order.layout("pattern", 62224)
    assert not lay.in_smem and lay.smem_bytes <= SMEM_BYTES


# --- on the card -----------------------------------------------------------

cuda = pytest.mark.skipif(torch.cuda.device_count() < 1,
                          reason="needs a CUDA device")


@pytest.mark.cuda
@cuda
@pytest.mark.parametrize("window", [1, 25, 150, 400, 600, 2300, 4096,
                                    16000, 62224])
@pytest.mark.parametrize("tiebreak", ["stable", "pattern"])
@pytest.mark.parametrize("prec", PRECS)
def test_descending_perm_kernel_equals_plain(prec, tiebreak, window):
    u = _patterns(prec, 3 * window + (window + 1) // 2, seed=window)
    vals = _torch_values(prec, u)
    ops.reset_launch_counts()
    got = ordering.descending_perm(vals.cuda(), window, tiebreak)
    assert popcount_order.DESCENDING_PERM.launches == 1
    want = ordering.descending_perm(vals, window, tiebreak)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@cuda
@pytest.mark.parametrize("tiebreak", ["stable", "pattern"])
def test_descending_perm_kernel_on_empty_rows(tiebreak):
    for shape in ((1, 0), (0, 25)):
        rows = torch.zeros(shape, dtype=torch.int32, device="cuda")
        got = popcount_order.descending_perm(rows, tiebreak, 32)
        assert got.shape == (0,) and got.dtype == torch.int64


@pytest.mark.cuda
@cuda
@pytest.mark.parametrize("planes,r,w,live,starts", CHAIN_CASES + [
    (1, 4, 4096, [4096, 1000, 3, 0], 8),
    (2, 2, 16000, [16000, 5000], 8),
    (2, 64, 152, [3 * i % 153 for i in range(64)], 8),
    (1, 5, 700, [700, 9, 0, 350, 1], 8),    # G = 3: two rows a block
    (2, 3, 2300, [2300, 100, 8], 8),
])
def test_chain_inputs_kernel_equals_plain(planes, r, w, live, starts):
    u = torch.from_numpy(_chain_case(w + planes, planes, r, w, live)
                         .view(np.int32))
    ops.reset_launch_counts()
    got = ops.chain_inputs(u.cuda(), starts)
    assert popcount_order.CHAIN_INPUTS.launches == 1
    want = ref.chain_inputs_ref(u, starts)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and torch.equal(g.cpu(), w_)


@pytest.mark.cuda
@cuda
def test_chain_inputs_kernel_on_empty_rows():
    got = ops.chain_inputs(torch.zeros((2, 0, 152), dtype=torch.int32,
                                       device="cuda"), 8)
    assert [tuple(t.shape) for t in got] == [(0, 152), (2, 0, 152), (0,),
                                             (0,), (0, 8)]
