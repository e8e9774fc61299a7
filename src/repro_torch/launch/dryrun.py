"""Dry run on the meta device: every (arch x shape) cell traced once, its
sizes, FLOPs and peak memory recorded for the production meshes and for
one card (the port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for 512 forced host devices and
reads XLA's memory and cost analyses. Here each cell's function runs on
meta tensors (shapes and dtypes, no storage), so a 1T-parameter train step
traces in seconds on any host:

* FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
  convolutions and attention, forward and backward; elementwise work is
  not counted), for the whole cell;
* argument bytes - parameters, optimizer state, inputs, cache - and their
  share on one device of the record's mesh, from each leaf's local shard
  under its spec;
* output bytes, and for train cells the bytes autograd saves for backward
  (``saved_tensors_hooks``; each storage once, parameters and inputs not
  counted) and the gradients' bytes;
* the peak: the most bytes of storage alive at once during the call,
  arguments included, from each meta storage's lifetime (a storage is
  freed when its last tensor goes, as on the card). ``fits_one_h100`` is
  ``peak_bytes <= card_bytes``: one card holds the whole cell. The card's
  bytes are ``torch.cuda.get_device_properties(0).total_memory`` when a
  card is present, else that value as read on an H100 80GB HBM3 at 700 W.

Decode cells donate their cache: the step writes its new entries into the
cache it is given (``decode_step(donate=True)``), as a server does, so a
step holds one cache and not two. The reference's decode cell does not
donate; XLA's memory analysis of it counts a second cache as output.

The mLSTM / sLSTM scans step through time in Python
(``models/recurrent.py``), so an xLSTM train or prefill cell of thousands
of steps would take minutes to hours to trace. Their FLOPs, saved bytes
and peak are affine in the sequence length (no attention), so those cells
are traced at two short lengths and extrapolated, as the reference
multiplies a scan body by its trip count; the record names the method.

Left out (ROADMAP C26): per-device FLOPs and collective bytes on the pod
meshes. The reference reads both from XLA's SPMD-partitioned program;
PyTorch has no partitioner that produces one without running every rank.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm-2b \\
        --shape train_4k [--multipod | --one-card] \\
        [--out experiments/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, SHAPES, cache_pspecs, get
from ..dist.sharding import PSpec, mesh_axes, spec_pspecs
from ..models import recurrent as R
from ..models.spec import (abstract_params, init_params, param_bytes,
                           param_count)
from ..optim import AdamW, wsd
from ..optim.adamw import AdamWState, Q8
from ..train.loop import value_and_grad
from ..tree import leaves, unflatten
from .mesh import make_one_card_mesh, make_production_mesh

__all__ = ["MESHES", "CARD_BYTES_H100", "build_cell", "run_cell",
           "count_call", "card_bytes", "run_on_card", "main"]

DEFAULT_OUT = "experiments/dryrun_torch"

# Record name -> mesh, and the label main() prints.
MESHES = {"pod16x16": ("16x16", lambda: make_production_mesh()),
          "pod2x16x16": ("2x16x16",
                         lambda: make_production_mesh(multi_pod=True)),
          "card1x1": ("1 card", make_one_card_mesh)}

# torch.cuda.get_device_properties(0).total_memory on an NVIDIA H100 80GB
# HBM3 at a 700.00 W power limit (chip_smoke.py's dryrun phase prints it).
CARD_BYTES_H100 = 85_017_493_504

# xLSTM train / prefill cells: traced at these two lengths, extrapolated.
_SHORT_SEQS = (4, 8)

_C26 = ("per-device FLOPs and collective bytes need an SPMD-partitioned "
        "program, which PyTorch does not produce without running every "
        "rank (ROADMAP C26)")


# ---------------------------------------------------------------------------
# cell construction: the function each (arch, shape) runs, on meta tensors
# ---------------------------------------------------------------------------

def _is_pspec(x) -> bool:
    return isinstance(x, PSpec)


def _train_setup(arch, mesh):
    """Model, meta parameters and their specs, the optimizer, its meta
    state and that state's specs. The step's spec is replicated; the
    moments mirror the parameters. Q8 moments keep the parameter's spec on
    their leading axes (the block layout preserves them, ``optim.adamw.Q8``);
    the block-count axis takes the parameter's last-dim axis only where it
    still divides."""
    model = arch.build()
    specs = model.specs()
    params_abs = abstract_params(specs)
    params_spec = spec_pspecs(specs, arch.rules, mesh)
    opt = AdamW(wsd(3e-4, 10000, warmup=500), state_dtype=arch.optimizer_state)
    opt_abs = opt.init(params_abs)
    sizes = mesh_axes(mesh)

    def axsize(ax) -> int:
        if ax is None:
            return 1
        n = 1
        for a in ((ax,) if isinstance(ax, str) else ax):
            n *= sizes[a]
        return n

    def one(leaf, ps: PSpec):
        if not isinstance(leaf, Q8):
            return ps
        rank = leaf.q.dim()
        parts = (list(ps) + [None] * rank)[:rank - 1]
        last_ax = parts[-1] if parts else None
        nb = leaf.q.shape[-2]
        nb_ax = last_ax if (last_ax and nb % axsize(last_ax) == 0) else None
        return Q8(PSpec(*(parts[:-1] + [nb_ax, None])),
                  PSpec(*(parts[:-1] + [nb_ax])))

    pspecs = leaves(params_spec, _is_pspec)

    def for_moment(tree):
        return unflatten(params_abs, [one(x, p) for x, p in zip(
            leaves(tree, lambda x: isinstance(x, Q8)), pspecs)])

    opt_spec = AdamWState(PSpec(), for_moment(opt_abs.m),
                          for_moment(opt_abs.v))
    return model, params_abs, params_spec, opt, opt_abs, opt_spec


def _loss_fn(arch, model):
    if arch.kind == "encdec":
        def loss_fn(params, batch):
            return model.loss(params, batch["frames"], batch["tokens"],
                              batch["targets"], batch["mask"])
    elif getattr(arch.config, "vlm_prefix", 0):
        def loss_fn(params, batch):
            return model.loss(params, batch["tokens"], batch["targets"],
                              batch["mask"], batch["patch_embeds"])
    else:
        def loss_fn(params, batch):
            return model.loss(params, batch["tokens"], batch["targets"],
                              batch["mask"])
    return loss_fn


def _build(arch, shape_name: str, mesh, seq_len: int = None):
    """build_cell at an optional sequence length in place of the cell's."""
    cell = SHAPES[shape_name]
    ins = arch.input_specs(shape_name, seq_len)
    in_spec = arch.input_pspecs(ins, mesh)

    if cell.mode == "train":
        model, p_abs, p_spec, opt, o_abs, o_spec = _train_setup(arch, mesh)
        loss_fn = _loss_fn(arch, model)

        def train_step(params, opt_state, batch):
            loss, grads = value_and_grad(loss_fn, params, batch)
            new_params, new_opt = opt.update(grads, opt_state, params)
            return new_params, new_opt, loss

        return train_step, (p_abs, o_abs, ins), (p_spec, o_spec, in_spec)

    model = arch.build()
    specs = model.specs()
    p_abs = abstract_params(specs)
    p_spec = spec_pspecs(specs, arch.rules, mesh)
    s = cell.seq_len if seq_len is None else seq_len

    if cell.mode == "prefill":
        if arch.kind == "encdec":
            def prefill(params, batch):
                memory = model.encode(params, batch["frames"])
                logits = model.decode_train(params, batch["tokens"], memory)
                return logits[:, -1], memory
        elif getattr(arch.config, "vlm_prefix", 0):
            def prefill(params, batch):
                return model.prefill(params, batch["tokens"], s,
                                     batch["patch_embeds"])
        else:
            def prefill(params, batch):
                return model.prefill(params, batch["tokens"], s)
        return prefill, (p_abs, ins), (p_spec, in_spec)

    # decode: the cache is an input, made on meta by the model's own
    # init_cache (the enc-dec's from a meta encoder memory)
    b, ctx = cell.global_batch, s
    if arch.kind == "encdec":
        mem = torch.empty((b, ctx, arch.config.d_model),
                          dtype=torch.bfloat16, device="meta")
        cache = model.init_cache(b, max(ctx // 4, 8), mem, p_abs)
    else:
        cache = model.init_cache(b, arch.config.cache_len(ctx),
                                 device="meta")
    cache_spec = unflatten(cache, list(cache_pspecs(cache, mesh).values()))

    def decode(params, token, cache, pos):
        return model.decode_step(params, token, cache, pos, donate=True)

    args = (p_abs, ins["token"], cache, ins["pos"])
    return decode, args, (p_spec, in_spec["token"], cache_spec,
                          in_spec["pos"])


def build_cell(arch_name, shape_name: str, mesh):
    """Returns ``(fn, args, shardings)``: the cell's function, its arguments
    as meta tensors (parameters, optimizer state, inputs, cache) and the
    ``PSpec`` of every argument leaf on ``mesh`` in the arguments'
    structure (a decode cache's from ``configs.cache_pspecs``);
    ``dist.sharding.placements(spec, mesh)`` turns a spec into DTensor
    placements.

    ``arch_name`` may be an --arch id or an ArchDef (e.g. one carrying
    config overrides for a perf-iteration run)."""
    arch = get(arch_name) if isinstance(arch_name, str) else arch_name
    return _build(arch, shape_name, mesh)


# ---------------------------------------------------------------------------
# counting a call: FLOPs, storage lifetimes, saved tensors
# ---------------------------------------------------------------------------

def _tensors(tree) -> list:
    return [x for x in leaves(tree) if isinstance(x, torch.Tensor)]


def _storage(t: torch.Tensor):
    st = t.untyped_storage()
    return st._cdata, st.nbytes()


def _storage_bytes(tensors, skip=()) -> int:
    """Bytes of the distinct storages behind ``tensors``, less ``skip``'s."""
    seen = dict(_storage(t) for t in tensors)
    return sum(n for k, n in seen.items() if k not in skip)


class _Lifetimes(TorchDispatchMode):
    """Bytes of storage alive during a call: each storage an op returns
    that was not alive before is added, and taken off when it is freed
    (a weakref finalizer on the storage fires when its last tensor, view or
    saved reference goes, as the card's allocator would free it). With
    ``timeline``, the bytes alive after each op, and a ``None`` wherever
    :meth:`mark` was called."""

    def __init__(self, alive: dict, timeline: bool = False):
        super().__init__()
        self.known = set(alive)
        self.live = sum(alive.values())
        self.peak = self.live
        self.timeline = [] if timeline else None

    def _free(self, key, n):
        self.known.discard(key)
        self.live -= n

    def mark(self):
        self.timeline.append(None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.known:
                continue
            n = st.nbytes()
            self.known.add(key)
            self.live += n
            weakref.finalize(st, self._free, key, n)
        self.peak = max(self.peak, self.live)
        if self.timeline is not None:
            self.timeline.append(self.live)
        return out


@contextlib.contextmanager
def _marking_scan_steps(life: _Lifetimes):
    """Mark the timeline at each mLSTM / sLSTM step while a scan runs (the
    step functions are wrapped for the call's duration)."""
    names = ("_mlstm_cell", "slstm_cell")
    saved = {n: getattr(R, n) for n in names}

    def wrap(f):
        def stepped(*a, **k):
            life.mark()
            return f(*a, **k)
        return stepped

    try:
        for n, f in saved.items():
            setattr(R, n, wrap(f))
        yield
    finally:
        for n, f in saved.items():
            setattr(R, n, f)


def count_call(fn, args, *, scan_steps: int = 0) -> dict:
    """Run ``fn(*args)`` once under the counters, on whatever device the
    arguments live (meta for the dry run; the CPU in the tests): FLOPs,
    peak bytes (arguments included), output bytes (storages the arguments
    do not hold), bytes saved for backward (storages the arguments do not
    hold, each once) and seconds. ``scan_steps`` (the sequence length of an
    xLSTM call) also returns the call's skeleton (:func:`_skeleton`)."""
    alive = dict(_storage(t) for t in _tensors(args))
    saved = {}      # key -> (weak reference to the storage, bytes)

    def pack(t):
        st = t.untyped_storage()
        key = st._cdata
        # a key may come back once its storage is freed (a saved tensor of
        # a branch the loss drops): a dead reference is a new storage
        if key not in alive and (key not in saved or saved[key][0]() is None):
            saved[key] = (weakref.ref(st), st.nbytes())
            total[0] += st.nbytes()
        return t
    total = [0]

    t0 = time.perf_counter()
    life = _Lifetimes(alive, timeline=bool(scan_steps))
    marking = (_marking_scan_steps(life) if scan_steps
               else contextlib.nullcontext())
    with FlopCounterMode(display=False) as flops, life, marking, \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn(*args)
    rec = {"flops": int(flops.get_total_flops()),
           "peak_bytes": int(life.peak),
           "output_bytes": _storage_bytes(_tensors(out), alive),
           "saved_for_backward_bytes": total[0],
           "trace_s": time.perf_counter() - t0}
    if scan_steps:
        rec["skeleton"] = _skeleton(life.timeline, scan_steps)
    return rec


def _skeleton(timeline: list, steps: int) -> list:
    """The bytes alive after each op, with every scan's middle steps left
    out: of each run of ``steps`` marks, the ops after the first, the
    second-to-last and the last mark are kept (the last's run on to the
    next scan). Within a scan an op's bytes are affine in the step index,
    so each scan's largest value lies in its first or its last steps; two
    lengths' skeletons line up op for op."""
    out, n_mark = [], 0
    keep = True
    for v in timeline:
        if v is None:
            i = n_mark % steps
            keep = i in (0, steps - 2, steps - 1)
            n_mark += 1
        elif keep:
            out.append(v)
    if n_mark % steps:
        raise ValueError(f"{n_mark} scan steps marked, not a multiple of "
                         f"the length {steps}")
    return out


def _steps_in_time(arch) -> bool:
    return any(k in ("mlstm", "slstm") for k in
               getattr(arch.config, "pattern", ()))


def _affine(a: int, b: int, s1: int, s2: int, s: int, what: str) -> int:
    slope, rem = divmod(b - a, s2 - s1)
    if rem:
        raise ValueError(f"{what} is not affine in the sequence length ({a} "
                         f"at {s1}, {b} at {s2})")
    return a + slope * (s - s1)


def _trace(arch, shape_name: str, seq_len: int = None,
           short: tuple = None) -> dict:
    """One cell's traced figures (mesh-independent): direct, or for an
    xLSTM train / prefill cell traced at the ``short`` lengths and
    extrapolated to the cell's. FLOPs, output and saved bytes are sums,
    affine in the length; the peak of a prefill is the largest of its
    skeletons' values, each extrapolated; a train cell's backward has no
    marks, so its peak is the line through the two lengths' peaks, a lower
    bound (the peak is a largest value of affine values: convex)."""
    cell = SHAPES[shape_name]
    s = cell.seq_len if seq_len is None else seq_len
    one = make_one_card_mesh()
    if cell.mode == "decode" or not _steps_in_time(arch):
        tr = count_call(*_build(arch, shape_name, one, s)[:2])
        tr.update(count_method="traced", peak_is="exact")
        return tr
    s1, s2 = short or _SHORT_SEQS
    a, b = (count_call(*_build(arch, shape_name, one, seq_len=n)[:2],
                       scan_steps=n) for n in (s1, s2))
    tr = {"trace_s": a["trace_s"] + b["trace_s"],
          "count_method": (f"extrapolated: traced at sequence {s1} and {s2}, "
                           f"affine in the length to {s} (the mLSTM / sLSTM "
                           "scans step through time)")}
    for k in ("flops", "output_bytes", "saved_for_backward_bytes"):
        tr[k] = _affine(a[k], b[k], s1, s2, s, k)
    if cell.mode == "train":
        tr["peak_bytes"] = _affine(a["peak_bytes"], b["peak_bytes"], s1, s2,
                                   s, "the peak")
        tr["peak_is"] = "lower bound"
        return tr
    ka, kb = a["skeleton"], b["skeleton"]
    if len(ka) != len(kb):
        raise ValueError(f"skeletons of {len(ka)} and {len(kb)} ops at "
                         f"sequence {s1} and {s2}")
    tr["peak_bytes"] = max(_affine(x, y, s1, s2, s, "an op's bytes alive")
                           for x, y in zip(ka, kb))
    tr["peak_is"] = "exact"
    return tr


def _trace_key(arch, shape_name: str):
    # moe_shard constrains nothing on one device (ROADMAP C18): variants
    # that differ only there share a trace.
    cfg = arch.config
    if hasattr(cfg, "moe_shard"):
        cfg = dataclasses.replace(cfg, moe_shard=None)
    return (arch.kind, cfg, arch.optimizer_state, shape_name)


def _fits(tr: dict, card: int):
    """The fit rule; a lower-bound peak can only say that a cell does not
    fit (None where it cannot tell)."""
    if tr["peak_is"] == "exact" or tr["peak_bytes"] > card:
        return tr["peak_bytes"] <= card
    return None


def card_bytes() -> tuple:
    """(bytes of one card, where the figure comes from)."""
    if torch.cuda.is_available():
        return (int(torch.cuda.get_device_properties(0).total_memory),
                "torch.cuda.get_device_properties(0).total_memory "
                f"({torch.cuda.get_device_name(0)})")
    return (CARD_BYTES_H100, "total_memory read on an NVIDIA H100 80GB HBM3 "
            "at 700.00 W (no card present)")


# ---------------------------------------------------------------------------
# the dry run itself
# ---------------------------------------------------------------------------

def _local_bytes(t: torch.Tensor, spec, sizes) -> int:
    """Bytes of one device's shard of ``t`` under ``spec``."""
    n = t.element_size()
    for d, entry in zip(t.shape, tuple(spec) + (None,) * t.dim()):
        div = 1
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            div *= sizes[a]
        n *= d // div
    return n


def _arg_parts(shape_name: str, args, shardings) -> dict:
    """Argument leaves and their specs, by part."""
    mode = SHAPES[shape_name].mode
    if mode == "train":
        names = ("params", "optimizer_state", "inputs")
    elif mode == "prefill":
        names = ("params", "inputs")
    else:
        p, tok, cache, pos = args
        ps, ts, cs, qs = shardings
        return {"params": (leaves(p), leaves(ps, _is_pspec)),
                "inputs": ([tok, pos], [ts, qs]),
                "cache": (leaves(cache), leaves(cs, _is_pspec))}
    return {n: (leaves(a), leaves(s, _is_pspec))
            for n, a, s in zip(names, args, shardings)}


def _apply_overrides(arch, kv_chunk, moe_groups, moe_shard, rules_override):
    cfg_over = {}
    if kv_chunk is not None:
        cfg_over["kv_chunk"] = kv_chunk
    if moe_groups is not None and hasattr(arch.config, "moe_groups"):
        cfg_over["moe_groups"] = moe_groups
    if moe_shard is not None and hasattr(arch.config, "moe_shard"):
        cfg_over["moe_shard"] = tuple(moe_shard)
    if os.environ.get("REPRO_TP_BF16"):
        cfg_over["tp_bf16_boundary"] = True
    if cfg_over:
        arch = dataclasses.replace(
            arch, config=dataclasses.replace(arch.config, **cfg_over))
    if rules_override:
        arch = dataclasses.replace(arch, rules={**arch.rules,
                                                **rules_override})
    return arch


def run_cell(arch_name: str, shape_name: str, *, multi_pod: bool = False,
             mesh: str = None, out_dir: str = DEFAULT_OUT,
             kv_chunk: int = None, moe_groups: int = None,
             moe_shard: tuple = None, rules_override: dict = None,
             tag: str = "", traces: dict = None, card: tuple = None) -> dict:
    """One record: ``mesh`` names one of MESHES (default from
    ``multi_pod``, as in the reference). ``traces``, a dict the caller
    keeps, shares each (arch config, shape)'s meta trace between calls
    (the meshes' records of one cell); ``card`` is (bytes, source) of the
    card the fit is judged against (default :func:`card_bytes`)."""
    arch = get(arch_name)
    ok, reason = arch.supports(shape_name)
    mesh_name = mesh or ("pod2x16x16" if multi_pod else "pod16x16")
    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
           "status": "skip", "reason": reason}
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{arch_name}__{shape_name}__{mesh_name}{tag}.json")
    if not ok:
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec

    arch = _apply_overrides(arch, kv_chunk, moe_groups, moe_shard,
                            rules_override)
    mesh_obj = MESHES[mesh_name][1]()
    try:
        fn, args, shardings = build_cell(arch, shape_name, mesh_obj)
        traces = {} if traces is None else traces
        key = _trace_key(arch, shape_name)
        if key not in traces:
            traces[key] = _trace(arch, shape_name)
        tr = traces[key]
        sizes = mesh_axes(mesh_obj)
        parts = _arg_parts(shape_name, args, shardings)
        arg_bytes = {n: _storage_bytes(ts) for n, (ts, _) in parts.items()}
        arg_bytes["total"] = sum(arg_bytes.values())
        per_dev = {n: sum(_local_bytes(t, s, sizes) for t, s in zip(ts, ss))
                   for n, (ts, ss) in parts.items()}
        per_dev["total"] = sum(per_dev.values())
        specs = arch.build().specs()
        train = SHAPES[shape_name].mode == "train"
        card, card_src = card or card_bytes()
        rec.update({
            "status": "ok",
            "trace_s": round(tr["trace_s"], 2),
            "devices": int(mesh_obj.devices.size),
            "params": param_count(specs),
            "param_bytes_global": param_bytes(specs),
            "flops": tr["flops"],
            "count_method": tr["count_method"],
            "argument_bytes": arg_bytes,
            "argument_bytes_per_device": per_dev,
            "output_bytes": tr["output_bytes"],
            "saved_for_backward_bytes": (tr["saved_for_backward_bytes"]
                                         if train else None),
            "gradient_bytes": param_bytes(specs) if train else None,
            "donated": ["cache"] if SHAPES[shape_name].mode == "decode"
            else [],
            "peak_bytes": tr["peak_bytes"],
            "peak_is": tr["peak_is"],
            "fits_one_h100": _fits(tr, card),
            "fit_rule": "peak_bytes <= card_bytes",
            "card_bytes": card,
            "card_bytes_source": card_src,
            "flops_per_device": None,
            "collective_bytes_per_device": None,
            "omitted": _C26,
        })
        if moe_shard is not None:
            rec["moe_shard"] = ("accepted and ignored: one device has no "
                                "dispatch buffers to constrain (ROADMAP C18)")
    except Exception as e:  # noqa: BLE001 - a failed cell is a recorded bug
        rec.update({"status": "fail", "error": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-4000:]})
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


# the allocator's rounding: each block is its request rounded up to 512
# bytes, and a large-pool block keeps up to 1 MiB that is not split off
ALLOC_SLACK = (1 << 20) + 512


def run_on_card(arch_name: str, shape_name: str, rec: dict, *,
                seed: int = 0) -> dict:
    """Run a decode cell the dry run says fits one card, for real, on the
    card (no CPU fallback: raises without one), and hold it to ``rec``:

    * the arguments' bytes (``memory_allocated`` before and after seeded
      random parameters, inputs and a zero cache are made) against
      ``rec["argument_bytes"]["total"]``, within ``ALLOC_SLACK`` a tensor;
    * the step's FLOPs (``FlopCounterMode`` on the real step) equal to
      ``rec["flops"]``;
    * the step's peak (``max_memory_allocated``) beside ``rec["peak_bytes"]``;
    * finite logits of the right shape.

    Returns the readings; raises ``AssertionError`` on a failed check."""
    if not torch.cuda.is_available():
        raise RuntimeError("run_on_card needs a CUDA card")
    arch = get(arch_name)
    cell = SHAPES[shape_name]
    if cell.mode != "decode" or rec.get("fits_one_h100") is not True:
        raise ValueError(f"{arch_name} x {shape_name}: run_on_card takes a "
                         "decode cell the dry run says fits one card")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    gc.collect()        # garbage freed mid-step would hide the step's peak
    torch.cuda.synchronize()
    gc_s = time.perf_counter() - t0
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = arch.build()
    gen = torch.Generator(dev).manual_seed(seed)
    params = init_params(model.specs(), gen, dev)
    b, ctx = cell.global_batch, cell.seq_len
    vocab = arch.config.vocab
    token = torch.randint(0, vocab, (b,), generator=gen, device=dev,
                          dtype=torch.int32)
    pos = torch.full((b,), ctx - 1, dtype=torch.int32, device=dev)
    if arch.kind == "encdec":
        mem = torch.randn((b, ctx, arch.config.d_model), generator=gen,
                          device=dev).to(torch.bfloat16)
        cache = model.init_cache(b, max(ctx // 4, 8), mem, params)
        del mem
    else:
        cache = model.init_cache(b, arch.config.cache_len(ctx), dev)
    args = (params, token, cache, pos)
    n_tensors = len(_tensors(args))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    allocated = torch.cuda.memory_allocated() - base
    want = rec["argument_bytes"]["total"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn = build_cell(arch, shape_name, make_one_card_mesh())[0]
    with FlopCounterMode(display=False) as fc:
        logits, new_cache = fn(*args)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    flops = int(fc.get_total_flops())
    finite = bool(torch.isfinite(logits).all())
    out = {"arch": arch_name, "shape": shape_name,
           "argument_bytes": want, "allocated_bytes": allocated,
           "alloc_bound_bytes": n_tensors * ALLOC_SLACK,
           "tensors": n_tensors, "flops": flops, "flops_want": rec["flops"],
           "peak_bytes": peak, "peak_want": rec["peak_bytes"],
           "peak_ratio": peak / rec["peak_bytes"],
           "logits_shape": list(logits.shape), "finite": finite,
           "gc_s": gc_s, "build_s": build_s, "step_s": step_s}
    del params, token, cache, pos, args, logits, new_cache
    torch.cuda.empty_cache()
    cell_name = f"{arch_name} x {shape_name}"
    if not 0 <= allocated - want <= out["alloc_bound_bytes"]:
        raise AssertionError(f"{cell_name}: {allocated} bytes allocated for "
                             f"{want} predicted (bound "
                             f"{out['alloc_bound_bytes']})")
    if flops != rec["flops"]:
        raise AssertionError(f"{cell_name}: {flops} FLOPs on the card, "
                             f"{rec['flops']} on meta")
    if not finite or out["logits_shape"] != [b, model.cfg.padded_vocab]:
        raise AssertionError(f"{cell_name}: logits {out['logits_shape']}, "
                             f"finite {finite}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--one-card", action="store_true",
                    help="the one-card mesh (card1x1)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every arch x shape on all three meshes")
    ap.add_argument("--kv-chunk", type=int, default=None)
    ap.add_argument("--moe-groups", type=int, default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    archs = list(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    if args.all:
        meshes = list(MESHES)
    elif args.both_meshes:
        meshes = ["pod16x16", "pod2x16x16"]
    else:
        meshes = ["card1x1" if args.one_card else
                  "pod2x16x16" if args.multipod else "pod16x16"]

    n_fail, traces, card = 0, {}, card_bytes()
    for a in archs:
        for s in shapes:
            for m in meshes:
                rec = run_cell(a, s, mesh=m, out_dir=args.out,
                               kv_chunk=args.kv_chunk,
                               moe_groups=args.moe_groups, tag=args.tag,
                               traces=traces, card=card)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    gb = rec["argument_bytes"]["total"] / 1e9
                    dev_gb = rec["argument_bytes_per_device"]["total"] / 1e9
                    extra = (f" trace {rec['trace_s']}s "
                             f"flops {rec['flops']:.3g} args {gb:.2f} GB "
                             f"args/dev {dev_gb:.3f} GB peak "
                             f"{rec['peak_bytes'] / 1e9:.2f} GB "
                             f"fits one H100 {rec['fits_one_h100']}")
                elif status == "fail":
                    n_fail += 1
                    extra = " " + rec["error"][:160]
                print(f"[{status:4s}] {a} x {s} x {MESHES[m][0]}{extra}",
                      flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")
    return 0


if __name__ == "__main__":
    main()
