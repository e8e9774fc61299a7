"""Port parity: the dry runs (``repro_torch.launch.dryrun``, ``hillclimb``,
``mesh``; ``models.spec.abstract_params``, ``ArchDef.input_specs`` /
``input_pspecs``) against live ``repro``.

Shapes, dtypes and PartitionSpecs are held exactly for every arch at full
width: the reference's ShapeDtypeStructs and ``NamedSharding`` specs come
from ``jax.eval_shape`` and its ``_train_setup`` on
``jax.sharding.AbstractMesh`` (16, 16) and (2, 16, 16), which the port's
sharding functions read as they read any mesh (axis names and sizes).
FLOPs, bytes and peaks are the port's own figures (the reference's come
from XLA's analyses): they are held to the same call on real CPU tensors,
and the xLSTM extrapolation to a direct count, on reduced configs.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the port's tests need torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.spec import abstract_params as jabstract  # noqa: E402
from repro.models.spec import param_bytes as jparam_bytes  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.configs import SHAPES  # noqa: E402
from repro_torch.dist.sharding import LocalMesh, PSpec  # noqa: E402
from repro_torch.launch import dryrun, hillclimb, mesh as tmesh  # noqa: E402
from repro_torch.models.spec import (  # noqa: E402
    abstract_params, init_params, param_bytes, param_count)
from repro_torch.optim.adamw import Q8  # noqa: E402

from test_torch_traffic import one_torch_thread  # noqa: E402,F401

ARCHS = sorted(jconfigs.ARCHS)
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def jdry():
    """``repro.launch.dryrun``, imported once the JAX backend is up (its
    XLA_FLAGS line cannot take effect then; the variable is put back)."""
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jd, hillclimb as jh
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return jd, jh


def _abstract_mesh(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


def _jspecs(tree_):
    """PartitionSpecs of a NamedSharding tree, as tuples, in leaf order."""
    return [tuple(s.spec) for s in jax.tree.leaves(tree_)]


def _specs(tree_):
    return [tuple(s) for s in tree.leaves(tree_, lambda x: isinstance(
        x, PSpec))]


def _rows(xs):
    return [(tuple(x.shape), str(x.dtype).replace("torch.", "")
             .replace("jnp.", "")) for x in xs]


def _jrows(xs):
    return [(tuple(x.shape), str(jnp.dtype(x.dtype))) for x in xs]


@pytest.mark.parametrize("name", ARCHS)
def test_abstract_params_equal_reference(name):
    """Every leaf's shape and dtype, in flattening order, on meta; counts
    and bytes."""
    arch, jarch = configs.get(name), jconfigs.get(name)
    specs, jspecs = arch.build().specs(), jarch.build().specs()
    got, want = tree.leaves(abstract_params(specs)), jax.tree.leaves(
        jabstract(jspecs))
    assert all(x.device.type == "meta" for x in got)
    assert _rows(got) == _jrows(want)
    assert param_bytes(specs) == jparam_bytes(jspecs)
    assert param_count(specs) == sum(int(np.prod(x.shape)) for x in want)


@pytest.mark.parametrize("name", ARCHS)
def test_input_specs_equal_reference(name):
    """Names, shapes and dtypes of every supported cell's inputs
    (tests/test_sharding.py's input_specs check over all archs)."""
    arch, jarch = configs.get(name), jconfigs.get(name)
    for shape in SHAPES:
        if not arch.supports(shape)[0]:
            continue
        got, want = arch.input_specs(shape), jarch.input_specs(shape)
        assert list(got) == list(want)
        assert all(v.device.type == "meta" for v in got.values())
        assert _rows(got.values()) == _jrows(want.values())


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_partition_specs_equal_reference(jdry, name, mesh_name):
    """Parameter and optimizer-state specs (Q8 moments included) of the
    reference's ``_train_setup``, and every cell's input and decode-cache
    specs, on the production mesh sizes."""
    jd, _ = jdry
    mesh = _abstract_mesh(mesh_name)
    arch, jarch = configs.get(name), jconfigs.get(name)
    _, p_abs, p_spec, _, o_abs, o_spec = dryrun._train_setup(arch, mesh)
    _, jp_abs, jp_shard, _, jo_abs, jo_shard = jd._train_setup(jarch, mesh)
    assert _specs(p_spec) == _jspecs(jp_shard)
    assert _specs(o_spec) == _jspecs(jo_shard)
    assert _rows(tree.leaves(o_abs)) == _jrows(jax.tree.leaves(jo_abs))
    q8 = [isinstance(x, Q8) for x in tree.leaves(
        o_abs.m, lambda x: isinstance(x, Q8))]
    assert all(q8) == (arch.optimizer_state == "int8") and any(q8) == all(q8)
    for shape, cell in SHAPES.items():
        if not arch.supports(shape)[0]:
            continue
        ins, jins = arch.input_specs(shape), jarch.input_specs(shape)
        got = arch.input_pspecs(ins, mesh)
        want = jarch.input_shardings(jins, mesh)
        assert {k: tuple(v) for k, v in got.items()} == {
            k: tuple(v.spec) for k, v in want.items()}
        if cell.mode != "decode":
            continue
        _, args, shard = dryrun.build_cell(name, shape, mesh)
        b, ctx = cell.global_batch, cell.seq_len
        jm = jarch.build()
        if jarch.kind == "encdec":
            mem = jax.ShapeDtypeStruct((b, ctx, jarch.config.d_model),
                                       jnp.bfloat16)
            jcache = jax.eval_shape(
                lambda m, p: jm.init_cache(b, max(ctx // 4, 8), m, p), mem,
                jabstract(jm.specs()))
        else:
            jcache = jax.eval_shape(lambda: jm.init_cache(
                b, jarch.config.cache_len(ctx)))
        assert _rows(tree.leaves(args[2])) == _jrows(jax.tree.leaves(jcache))
        assert _specs(shard[2]) == _jspecs(
            jconfigs.cache_shardings(jcache, mesh))


@pytest.mark.parametrize("name", ARCHS)
def test_build_cell_is_meta_only(name):
    """Every argument of every cell on meta (the reference's
    test_dryrun_cell_builder_abstract_only, over all archs and shapes),
    one spec a leaf, and the function takes them."""
    m = tmesh.make_production_mesh()
    for shape, cell in SHAPES.items():
        fn, args, shard = dryrun.build_cell(name, shape, m)
        xs = tree.leaves(args)
        assert xs and all(isinstance(x, torch.Tensor)
                          and x.device.type == "meta" for x in xs)
        specs = tree.leaves(shard, lambda x: isinstance(x, PSpec))
        assert len(specs) == len(xs)
        assert all(len(s) == x.dim() for s, x in zip(specs, xs))
        assert callable(fn)
        assert len(args) == {"train": 3, "prefill": 2, "decode": 4}[cell.mode]


def test_skip_records_equal_reference(jdry, tmp_path):
    """A cell ``supports()`` refuses: the same record, key for key, and the
    same file; the one-card mesh's only differs in its name."""
    jd, _ = jdry
    for name in ARCHS:
        if configs.get(name).supports("long_500k")[0]:
            continue
        for mp in (False, True):
            want = jd.run_cell(name, "long_500k", multi_pod=mp,
                               out_dir=str(tmp_path / "j"))
            got = dryrun.run_cell(name, "long_500k", multi_pod=mp,
                                  out_dir=str(tmp_path / "t"))
            assert got == want and got["status"] == "skip"
            fname = f"{name}__long_500k__{got['mesh']}.json"
            assert (tmp_path / "t" / fname).read_text() == (
                tmp_path / "j" / fname).read_text()
        one = dryrun.run_cell(name, "long_500k", mesh="card1x1",
                              out_dir=str(tmp_path / "t"))
        assert one == dict(want, mesh="card1x1")


def test_hillclimb_variants_equal_reference(jdry):
    _, jh = jdry
    assert hillclimb.VARIANTS == jh.VARIANTS
    assert list(hillclimb.VARIANTS) == list(jh.VARIANTS)


def test_meshes():
    """The production meshes' shapes and axes (the reference's), the
    one-card mesh, and the host mesh (the CPU only when asked for)."""
    for mp, (shape, axes) in ((False, MESHES["pod16x16"]),
                              (True, MESHES["pod2x16x16"])):
        m = tmesh.make_production_mesh(multi_pod=mp)
        assert isinstance(m, LocalMesh) and m.axis_names == axes
        assert m.devices.shape == shape
        assert {d.type for d in m.devices.flat} == {"meta"}
    assert tmesh.make_one_card_mesh().shape == {"data": 1, "model": 1}
    assert tmesh.make_host_mesh("cpu").shape == {"data": 1, "model": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_host_mesh()
    one = tmesh.make_one_card_mesh()
    arch = configs.get("h2o-danube-3-4b")
    assert set(arch.input_shardings(arch.input_specs("train_4k"), one)) == {
        "tokens", "targets", "mask"}


def _reduced(name):
    a = configs.get(name)
    return dataclasses.replace(a, config=a.reduced_config)


def _real(x, gen):
    """A CPU tensor of a meta tensor's shape and dtype, seeded."""
    if x.dtype in (torch.int32, torch.int64):
        return torch.randint(0, 64, x.shape, generator=gen, dtype=x.dtype)
    if x.dtype == torch.uint8:
        return torch.full(x.shape, 127, dtype=x.dtype)
    return torch.randn(x.shape, generator=gen).abs().to(x.dtype)


@pytest.mark.parametrize("name,shape,seq", [
    ("h2o-danube-3-4b", "train_4k", 24), ("mixtral-8x7b", "train_4k", 16),
    ("kimi-k2-1t-a32b", "train_4k", 8), ("recurrentgemma-9b", "train_4k", 16),
    ("whisper-medium", "train_4k", 32), ("h2o-danube-3-4b", "prefill_32k", 40),
    ("h2o-danube-3-4b", "decode_32k", 48)])
def test_meta_counts_equal_real_cpu_step(name, shape, seq):
    """The counters on meta tensors and on real CPU tensors of the same
    shapes (a reduced arch at a short length; the cell's batch): FLOPs,
    bytes saved for backward, output bytes and the peak, equal."""
    arch = _reduced(name)
    fn, args, _ = dryrun._build(arch, shape, tmesh.make_one_card_mesh(), seq)
    meta = dryrun.count_call(fn, args)
    gen = torch.Generator().manual_seed(0)
    if SHAPES[shape].mode == "train":
        params = init_params(arch.build().specs(), gen, "cpu")
        opt_state = args[1]._replace(step=torch.zeros((), dtype=torch.int32))
        opt_state = tree.unflatten(opt_state, [
            _real(x, gen) if x.dim() else torch.zeros((), dtype=x.dtype)
            for x in tree.leaves(opt_state)])
        real = (params, opt_state,
                {k: _real(v, gen) for k, v in args[2].items()})
        real[2]["mask"] = torch.ones_like(real[2]["mask"])
    else:
        real = tree.unflatten(args, [_real(x, gen)
                                     for x in tree.leaves(args)])
    cpu = dryrun.count_call(fn, real)
    keys = ("flops", "saved_for_backward_bytes", "output_bytes", "peak_bytes")
    assert {k: cpu[k] for k in keys} == {k: meta[k] for k in keys}
    assert meta["flops"] > 0


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_xlstm_extrapolation_equals_direct_count(shape):
    """Traced at 4 and 8 and extrapolated, against a direct trace at 20 on
    the reduced xlstm: FLOPs, output and saved bytes equal; the prefill's
    peak equal, the train step's a lower bound."""
    arch = _reduced("xlstm-125m")
    ex = dryrun._trace(arch, shape, seq_len=20, short=(4, 8))
    direct = dryrun.count_call(*dryrun._build(
        arch, shape, tmesh.make_one_card_mesh(), 20)[:2])
    for k in ("flops", "output_bytes", "saved_for_backward_bytes"):
        assert ex[k] == direct[k], k
    if shape == "train_4k":
        assert ex["peak_is"] == "lower bound"
        assert ex["peak_bytes"] <= direct["peak_bytes"]
    else:
        assert ex["peak_is"] == "exact"
        assert ex["peak_bytes"] == direct["peak_bytes"]
    assert "extrapolated" in ex["count_method"]


@pytest.mark.parametrize("name", ["h2o-danube-3-4b", "recurrentgemma-9b",
                                  "xlstm-125m", "mixtral-8x7b",
                                  "whisper-medium"])
def test_donated_decode_equals_functional(name):
    """``decode_step(donate=True)`` writes the functional step's new cache
    into the given one, bit for bit, with the same logits."""
    arch = configs.get(name)
    model = arch.build_reduced()
    gen = torch.Generator().manual_seed(3)
    params = init_params(model.specs(), gen, "cpu")
    b, ctx = 2, 24
    if arch.kind == "encdec":
        mem = torch.randn((b, 6, model.cfg.d_model), generator=gen).to(
            torch.bfloat16)
        cache = model.init_cache(b, ctx, mem, params)
    else:
        cache = model.init_cache(b, ctx, "cpu")
    tok = torch.randint(0, 64, (b,), generator=gen, dtype=torch.int32)
    for pos in (0, 5, 23):
        p = torch.full((b,), pos, dtype=torch.int32)
        want_l, want_c = model.decode_step(params, tok, cache, p)
        given = tree.map_leaves(torch.clone, cache)
        got_l, got_c = model.decode_step(params, tok, given, p, donate=True)
        assert got_c is given
        assert torch.equal(got_l, want_l)
        assert all(torch.equal(g, w) for g, w in zip(tree.leaves(got_c),
                                                     tree.leaves(want_c)))
        cache = want_c


def test_run_cell_records_and_main(tmp_path, capsys):
    """An ok record's keys and figures on each mesh (one trace), the
    one-card fit, C26's omission, and the CLI's line and file."""
    out, traces = str(tmp_path), {}
    recs = {m: dryrun.run_cell("xlstm-125m", "decode_32k", mesh=m,
                               out_dir=out, traces=traces)
            for m in dryrun.MESHES}
    assert len(traces) == 1
    one = recs["card1x1"]
    assert one["status"] == "ok" and one["devices"] == 1
    assert one["fits_one_h100"] is True and one["peak_is"] == "exact"
    assert one["argument_bytes_per_device"] == one["argument_bytes"]
    assert one["collective_bytes_per_device"] is None and "C26" in one[
        "omitted"]
    assert one["donated"] == ["cache"] and one["saved_for_backward_bytes"] \
        is None
    for m in ("pod16x16", "pod2x16x16"):
        r = recs[m]
        assert r["flops"] == one["flops"] and r["peak_bytes"] == one[
            "peak_bytes"]
        assert r["argument_bytes_per_device"]["total"] < one[
            "argument_bytes"]["total"]
    assert recs["pod2x16x16"]["devices"] == 512
    assert one["argument_bytes"]["params"] == param_bytes(
        configs.get("xlstm-125m").build().specs())
    with open(os.path.join(out, "xlstm-125m__decode_32k__card1x1.json")) as f:
        assert json.load(f) == one
    dryrun.main(["--arch", "xlstm-125m", "--shape", "long_500k",
                 "--one-card", "--out", out])
    assert "[ok  ] xlstm-125m x long_500k x 1 card" in capsys.readouterr().out
    rec = dryrun.run_cell("kimi-k2-1t-a32b", "decode_32k", out_dir=out,
                          moe_shard=("data", None), tag="_t")
    assert "C18" in rec["moe_shard"] and rec["fits_one_h100"] is False


def test_run_on_card_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.run_on_card("xlstm-125m", "decode_32k", {})
