"""Port parity: ``repro_torch.dist.sharding`` against live
``repro.dist.sharding``.

* ``logical_to_pspec`` equal to the reference's on fake meshes (a
  ``.shape`` / ``.axis_names`` stand-in, as tests/test_sharding.py uses):
  every LeNet and DarkNet spec, a small LM's specs, and
  tests/test_sharding.py's divisibility, duplicate-axis, pod and
  batch-one cases and the kimi rules; ``data_axis_size`` likewise;
* the DTensor placements built from those entries: ``Shard(d)`` on exactly
  the mesh dims a tensor dim's entry names; each device's block under them
  (torch's local shape and offset for every mesh coordinate) equal to
  JAX's block for that device on an 8-device host mesh (a subprocess with
  forced host devices);
* ``batch_shardings`` against the reference's on a one-device mesh, and
  its fallback on a fake one;
* ``distribute_tensor`` round trips of LeNet's and DarkNet's parameters,
  and ``compact_batch``, on a one-rank gloo ``DeviceMesh``
  ``("data", "model")`` (a ``HashStore``: no network), the group
  destroyed after the module.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
import torch.distributed as tdist  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402
from torch.distributed.tensor import distribute_tensor  # noqa: E402
from torch.distributed.tensor._utils import (  # noqa: E402
    _compute_local_shape_and_global_offset)

from repro.configs import get as jget  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.models import DarkNetLike as JDarkNet, LeNet as JLeNet  # noqa: E402
from repro.models import LM, LMConfig  # noqa: E402
from repro.models.spec import is_spec  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.models import DarkNetLike, LeNet  # noqa: E402

from test_torch_traffic import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fake_mesh(shape=(16, 16), axes=("data", "model")):
    class M:
        axis_names = axes

        def __init__(self):
            self.shape = dict(zip(axes, shape))
    return M()


MESHES = [fake_mesh(), fake_mesh((2, 16, 16), ("pod", "data", "model")),
          fake_mesh((4, 2)), fake_mesh((1, 1)), fake_mesh((8, 1)),
          fake_mesh((2, 2, 2), ("pod", "data", "model"))]


def _spec_list(specs):
    return [(s.axes, s.shape) for s in jax.tree.leaves(specs,
                                                       is_leaf=is_spec)]


def _all_specs():
    """(axes, shape) of every LeNet / DarkNet spec (the port's equal to the
    reference's) and of a small LM's."""
    out = []
    for port, ref in ((LeNet.specs(), JLeNet().specs()),
                      (DarkNetLike.specs(), JDarkNet().specs())):
        assert _spec_list(ref) == [(s.axes, s.shape)
                                   for s in tree.leaves(port)]
        out += _spec_list(ref)
    cfg = LMConfig("t", n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                   vocab=256)
    return out + _spec_list(LM(cfg).specs())


CASES = [  # tests/test_sharding.py's cases: (axes, shape, rules)
    (("embed", "heads", "head_dim"), (896, 14, 64), None),
    (("embed", "heads", "head_dim"), (6144, 48, 128), None),
    (("embed", "heads", "head_dim"), (5120, 32, 128),
     dict(jsh.DEFAULT_RULES, head_dim="model")),
    (("batch", "seq"), (256, 4096), None),
    (("batch", "seq"), (1, 524288), None),
    (("layers", "experts", "embed", "mlp"), (61, 384, 7168, 2048),
     jget("kimi-k2-1t-a32b").rules),
    (("batch", "embed"), (64, 32), dict(jsh.DEFAULT_RULES,
                                        embed=("data", "model"))),
]


def test_default_rules_equal():
    assert sh.DEFAULT_RULES == jsh.DEFAULT_RULES


@pytest.mark.parametrize("mi", range(len(MESHES)))
def test_logical_to_pspec_equals_reference(mi):
    mesh = MESHES[mi]
    cases = [(a, s, None) for a, s in _all_specs()] + CASES
    for axes, shape, rules in cases:
        rules = rules or jsh.DEFAULT_RULES
        want = jsh.logical_to_pspec(axes, shape, rules, mesh)
        got = sh.logical_to_pspec(axes, shape, rules, mesh)
        assert got == tuple(want), (axes, shape)
        pl = sh.placements(got, mesh)
        names = list(mesh.axis_names)
        assert len(pl) == len(names)
        for i, name in enumerate(names):
            dims = [d for d, e in enumerate(got)
                    if e == name or (isinstance(e, tuple) and name in e)]
            assert pl[i] == (Shard(dims[0]) if dims else Replicate())
    assert sh.data_axis_size(mesh) == jsh.data_axis_size(mesh)
    with pytest.raises(ValueError) as mine:
        sh.logical_to_pspec(("batch",), (4, 4), jsh.DEFAULT_RULES, mesh)
    with pytest.raises(ValueError) as theirs:
        jsh.logical_to_pspec(("batch",), (4, 4), jsh.DEFAULT_RULES, mesh)
    assert str(mine.value) == str(theirs.value)


def test_placements_refuse_out_of_order_axes():
    mesh = fake_mesh((2, 2, 2), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="mesh-dim order"):
        sh.placements(sh.PSpec(("data", "pod")), mesh)


# Specs with (pod, data) entries, tuple entries over other axes, and
# replicated dims, on JAX's 8-device mesh (2, 2, 2).
BLOCK_CASES = [
    (("batch", "seq"), (8, 6)),
    (("embed", "mlp"), (8, 4)),
    (("batch", "embed", "mlp"), (4, 8, 6)),
    (("embed",), (8,)),
]
BLOCK_RULES = dict(jsh.DEFAULT_RULES, embed=("data", "model"))


def _jax_blocks():
    """JAX's (offset, shape) of each case's block on every device of a
    (2, 2, 2) mesh, from a process with 8 forced host devices."""
    code = f"""
import json, numpy as np, jax
from jax.sharding import Mesh, NamedSharding
from repro.dist import sharding as jsh
rules = {BLOCK_RULES!r}
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2, 2),
            ("pod", "data", "model"))
coord = {{d: c for c, d in np.ndenumerate(mesh.devices)}}
out = []
for axes, shape in {BLOCK_CASES!r}:
    spec = jsh.logical_to_pspec(axes, shape, rules, mesh)
    m = NamedSharding(mesh, spec).devices_indices_map(shape)
    out.append({{",".join(map(str, coord[d])): [
        [s.start or 0 for s in idx],
        [(s.stop if s.stop is not None else n) - (s.start or 0)
         for s, n in zip(idx, shape)]] for d, idx in m.items()}})
print(json.dumps(out))
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    return json.loads(run.stdout.strip().splitlines()[-1])


def test_device_blocks_equal_jax():
    mesh = fake_mesh((2, 2, 2), ("pod", "data", "model"))
    want = _jax_blocks()
    for (axes, shape), blocks in zip(BLOCK_CASES, want):
        pl = sh.placements(sh.logical_to_pspec(axes, shape, BLOCK_RULES,
                                               mesh), mesh)
        assert len(blocks) == 8
        for coord, (offset, size) in blocks.items():
            got = _compute_local_shape_and_global_offset(
                shape, (2, 2, 2), [int(c) for c in coord.split(",")], pl)
            assert list(got[0]) == size and list(got[1]) == offset, (
                axes, coord)


def test_batch_shardings_equal_reference():
    jmesh = jax.sharding.Mesh(np.asarray(jax.local_devices()[:1]),
                              ("data",))
    t = {"a": np.zeros((6, 3)), "s": np.zeros(()), "odd": np.zeros((7, 2))}
    want = jsh.batch_shardings(jmesh, t, "data")
    one = sh.LocalMesh(["cpu"], ("data",))
    got = sh.batch_shardings(one, t, "data")
    for k in t:
        assert got[k] == sh.placements(sh.PSpec(*want[k].spec), one)
    four = fake_mesh((4, 2), ("data", "model"))
    got = sh.batch_shardings(four, t, "data")
    assert got["a"] == [Replicate(), Replicate()]       # 6 % 4
    assert got["s"] == [Replicate(), Replicate()]
    got = sh.batch_shardings(four, {"b": np.zeros((8, 1))}, "data")
    assert got["b"] == [Shard(0), Replicate()]


@pytest.fixture(scope="module")
def gloo_mesh():
    """A one-rank gloo DeviceMesh ("data", "model"), torn down after the
    module."""
    tdist.init_process_group("gloo", store=tdist.HashStore(), rank=0,
                             world_size=1)
    try:
        yield DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                         mesh_dim_names=("data", "model"))
    finally:
        tdist.destroy_process_group()


def test_distribute_tensor_round_trips(gloo_mesh):
    rng = np.random.default_rng(0)
    for cls in (LeNet, DarkNetLike):
        specs = cls.specs()
        placed = sh.spec_shardings(specs, sh.DEFAULT_RULES, gloo_mesh)
        for name, spec in specs.items():
            want = sh.placements(sh.logical_to_pspec(
                spec.axes, spec.shape, sh.DEFAULT_RULES,
                fake_mesh((1, 1))), gloo_mesh)
            assert placed[name] == want
            x = torch.from_numpy(rng.standard_normal(spec.shape)
                                 .astype(np.float32))
            d = distribute_tensor(x, gloo_mesh, placed[name])
            assert tuple(d.placements) == tuple(want)
            assert torch.equal(d.full_tensor(), x)


def test_compact_batch(gloo_mesh):
    x = torch.arange(12.0).reshape(6, 2)
    t = {"x": distribute_tensor(x, gloo_mesh, [Shard(0), Replicate()]),
         "y": torch.arange(6)}
    out = sh.compact_batch(gloo_mesh, t, [4, 1, 1])
    assert tuple(out["x"].placements) == (Shard(0), Replicate())
    assert torch.equal(out["x"].full_tensor(), x[[4, 1, 1]])
    assert torch.equal(out["y"].full_tensor(), torch.tensor([4, 1, 1]))
