"""Port parity: the whole O3 chain step loop (``ops.chain_greedy``) against
the reference's ``_greedy_from`` scan, vmapped over starts, window by
window, on the same numpy inputs; integers compared exactly.

* on CPU tensors ``ops.chain_greedy`` runs its plain version
  (``ref.chain_greedy_ref``): one and two planes, beams of 1-3, widths
  1-152, all-zero windows, windows with fewer live values than the beam
  (so visited or zero-region lanes become candidates) and words with bit
  31 set;
* the kernel's wrapper refuses CPU tensors and rows wider than the int32
  score encoding allows, naming the width, and picks the register tier
  (W <= 1,024, beam <= 2) or the wide tier from the shape alone
  (``tier_of``), refusing the register tier for a shape beyond it;
* on a CUDA card (marked ``cuda``) the kernel equals the plain version at
  W up to 16,000, both tiers at their edges (W = 32, 33, 576, 1,024 and
  1,025), and the two tiers equal each other where both take a shape.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
from repro_torch.kernels import chain_greedy as kgreedy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _inputs(seed, planes, r, w, s, kind):
    """Partitioned (P, R, W) uint32 planes (zeros at each window's tail, as
    the chain's partition leaves them), live counts and start positions."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2**32, (planes, r, w), dtype=np.uint64).astype(
        np.uint32)
    if kind == "bit31":
        u |= np.uint32(0x80000000)
    live = {"allzero": np.zeros(r, np.int64),
            "zlow": rng.integers(0, 2, r),
            }.get(kind, rng.integers(0, w + 1, r))
    live = np.minimum(live, w)
    for i in range(r):
        u[:, i, live[i]:] = 0
    z = live.astype(np.int32)
    start = rng.integers(0, w, (r, s)).astype(np.int32)
    return u, z, start


@functools.lru_cache(maxsize=None)
def _reference(beam):
    # Imported here, not at the top: the card-only test below runs where
    # the CUDA build of torch is installed and JAX is not.
    import jax
    from repro.kernels import min_hamming as jmh
    return jax.jit(jax.vmap(functools.partial(jmh._greedy_from, beam=beam),
                            in_axes=(None, None, 0)))


def _want(u, z, start, beam):
    f = _reference(beam)
    outs = [f(u[:, i], np.int32(z[i]), start[i])
            for i in range(u.shape[1])]
    return (np.stack([np.asarray(o) for o, _ in outs]),
            np.stack([np.asarray(c) for _, c in outs]))


@pytest.mark.parametrize("planes,beam,w,s,kind", [
    (1, 1, 1, 8, "random"),     # one value: no step
    (2, 2, 2, 8, "random"),
    (1, 3, 5, 8, "zlow"),       # z < beam: visited / zone candidates
    (2, 3, 5, 3, "zlow"),
    (1, 2, 31, 8, "bit31"),
    (2, 1, 31, 8, "random"),
    (1, 2, 31, 8, "allzero"),   # z = 0 everywhere
    (2, 2, 152, 8, "random"),   # conv2's padded window
    (1, 3, 152, 8, "bit31"),
    (2, 2, 32, 8, "random"),    # the register tier's one-slot edge
    (1, 3, 33, 8, "zlow"),      # a second slot of one live lane
    (2, 1, 33, 8, "bit31"),
    (1, 2, 64, 8, "random"),    # two full slots
    (2, 3, 64, 8, "allzero"),
])
def test_chain_greedy_matches_reference(planes, beam, w, s, kind):
    u, z, start = _inputs(planes * 1000 + w * 10 + beam, planes, 4, w, s,
                          kind)
    want_o, want_c = _want(u, z, start, beam)
    got_o, got_c = ops.chain_greedy(torch.from_numpy(u.view(np.int32)),
                                    torch.from_numpy(z),
                                    torch.from_numpy(start), beam)
    assert got_o.dtype == torch.int32 and got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_o.numpy(), want_o)
    np.testing.assert_array_equal(got_c.numpy(), want_c)


def test_chain_greedy_refuses_bad_arguments():
    q = torch.zeros((1, 2, 8), dtype=torch.int32)
    z = torch.zeros((2,), dtype=torch.int32)
    st = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="beam"):
        ops.chain_greedy(q, z, st, 9)
    with pytest.raises(ValueError, match="beam"):
        ops.chain_greedy(q, z, st, 0)
    with pytest.raises(ValueError, match="start"):
        ops.chain_greedy(q, z, st[:1], 2)


def test_chain_greedy_wrapper_refuses_cpu_tensors_and_wide_rows():
    """The wrapper launches the kernel or raises: a CPU tensor never
    reaches a kernel, and a row wider than ``_MAX_WINDOW`` is refused,
    naming its width."""
    q = torch.zeros((2, 2, 152), dtype=torch.int32)
    z = torch.zeros((2,), dtype=torch.int32)
    st = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kgreedy.chain_greedy(q, z, st, 2)
    wide = torch.zeros((2, 1, 16001), dtype=torch.int32)
    with pytest.raises(ValueError, match="width 16001"):
        kgreedy.chain_greedy(wide, z[:1], st[:1], 2)
    with pytest.raises(ValueError, match="P, R, W"):
        kgreedy.chain_greedy(q[None], z, st, 2)


@pytest.mark.parametrize("w,beam,tier", [
    (1, 1, "register"),
    (32, 1, "register"), (32, 2, "register"),
    (32, 3, "wide"),            # above the register tier's beam
    (33, 1, "register"), (33, 2, "register"), (33, 3, "wide"),
    (1024, 1, "register"), (1024, 2, "register"), (1024, 3, "wide"),
    (1024, 4, "wide"),
    (1025, 1, "wide"), (1025, 2, "wide"), (1025, 3, "wide"),
    (16000, 1, "wide"), (16000, 2, "wide"), (16000, 3, "wide"),
    (16000, 4, "wide"),
])
def test_chain_greedy_tier_of(w, beam, tier):
    """The tier is a function of (W, beam) alone: the register tier up to
    1,024 lanes and beam 2, the wide tier past either."""
    assert kgreedy.tier_of(w, beam) == tier


def test_chain_greedy_wrapper_refuses_register_tier_beyond_its_shape():
    """A register tier asked for past its shape is refused, naming it,
    before any tensor reaches the card; an unknown tier too."""
    z = torch.zeros((1,), dtype=torch.int32)
    st = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="W <= 1024"):
        kgreedy.chain_greedy(torch.zeros((1, 1, 1025), dtype=torch.int32),
                             z, st, 2, tier="register")
    with pytest.raises(ValueError, match="beam <= 2"):
        kgreedy.chain_greedy(torch.zeros((1, 1, 64), dtype=torch.int32),
                             z, st, 3, tier="register")
    with pytest.raises(ValueError, match="tier must be one of"):
        kgreedy.chain_greedy(torch.zeros((1, 1, 64), dtype=torch.int32),
                             z, st, 2, tier="shared")


# --------------------------------------------------------------------------
# On the card: the kernel against its plain version, exact equality.

cuda = pytest.mark.skipif(torch.cuda.device_count() < 1,
                          reason="needs a CUDA device")


@pytest.mark.cuda
@cuda
@pytest.mark.parametrize("planes,beam", [(1, 1), (1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("w", [4, 31, 32, 33, 152, 400, 576, 1024, 1025,
                               4096, 16000])
def test_chain_greedy_kernel_equals_plain(w, planes, beam):
    r = 2 if w >= 4096 else 64
    u, z, start = _inputs(w + planes + beam, planes, r, w, 8, "random")
    q = torch.from_numpy(u.view(np.int32)).cuda()
    zt, st = torch.from_numpy(z).cuda(), torch.from_numpy(start).cuda()
    before = kgreedy.KERNEL.launches
    got = kgreedy.chain_greedy(q, zt, st, beam)
    want = ref.chain_greedy_ref(q, zt, st, beam)
    torch.cuda.synchronize()
    assert kgreedy.KERNEL.launches == before + 1
    for g, v in zip(got, want):
        assert torch.equal(g, v)


@pytest.mark.cuda
@cuda
@pytest.mark.parametrize("beam", [1, 2, 3])
@pytest.mark.parametrize("planes,w,kind", [(1, 33, "zlow"), (2, 152, "bit31"),
                                           (2, 576, "random"),
                                           (1, 1024, "allzero")])
def test_chain_greedy_tiers_agree(planes, w, kind, beam):
    """Each tier that takes a shape equals the plain version: the wide
    tier at every beam, the register tier up to its beam of 2."""
    u, z, start = _inputs(w * 7 + planes + beam, planes, 48, w, 8, kind)
    q = torch.from_numpy(u.view(np.int32)).cuda()
    zt, st = torch.from_numpy(z).cuda(), torch.from_numpy(start).cuda()
    want = ref.chain_greedy_ref(q, zt, st, beam)
    for tier in sorted({"wide", kgreedy.tier_of(w, beam)}):
        got = kgreedy.chain_greedy(q, zt, st, beam, tier=tier)
        torch.cuda.synchronize()
        for g, v in zip(got, want):
            assert torch.equal(g, v), tier
