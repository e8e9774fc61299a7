"""Architecture definitions: config, shapes and shardings (the port of
``repro.configs.common``).

Each architecture is one :class:`ArchDef`: its full config, a small
same-family config (``build_reduced``), its sharding rules, the shape
cells it supports, and the inputs of each cell's function as meta tensors
(``input_specs``: the reference's ShapeDtypeStructs, with no storage).
Shardings are ``torch.distributed.tensor`` placements through
``dist.sharding`` (the reference's ``NamedSharding`` trees); the
``*_pspecs`` functions give the specs they come from.
Modality frontends are stubs, as in the reference: VLM archs take
precomputed patch embeddings, audio archs precomputed frame embeddings.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..dist.sharding import (DEFAULT_RULES, PSpec, Rules, logical_to_pspec,
                             placements, spec_shardings)
from ..models import LM, EncDec, LMConfig

__all__ = ["SHAPES", "ShapeCell", "ArchDef", "lm_arch", "cache_pspecs",
           "cache_shardings"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    mode: str                  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# Cache logical axes -> mesh axes. Decode caches shard the sequence axis
# over 'model' (vLLM-page style): scatter updates stay local and the
# per-step score reduction is small.
_CACHE_RULES: Rules = {
    "batch": "data", "seq": "model", "kv_heads": None, "head_dim": None,
    "state": "model", "heads": "model", "layers": None, "embed": "model",
}

_I32 = torch.int32
_BF16 = torch.bfloat16


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _cache_axes_for(path: str, rank: int) -> Tuple[Optional[str], ...]:
    """Logical axes of one cache leaf, from its tree path and rank."""
    if "memory" in path:
        return ("batch", "seq", "embed")
    if "attn" in path or "self" in path or "cross" in path:  # KVCache k/v
        base = ("batch", "seq", "kv_heads", "head_dim")
        return ("layers",) + base if rank == 5 else base
    if "conv" in path:                               # (.., B, width, D)
        base = ("batch", None, "state")
        return ("layers",) + base if rank == 4 else base
    if rank >= 3 and ("mlstm" in path or "slstm" in path):
        # mlstm c (L,B,H,hd,hd) / n (L,B,H,hd) / m (L,B,H); slstm (L,B,D)
        names = ("layers", "batch", "heads", "head_dim", "head_dim")
        return (names[:rank] if "mlstm" in path
                else ("layers", "batch", "state")[:rank])
    if rank == 2:                                    # rec h (B, D)
        return ("batch", "state")
    if rank == 3:                                    # rec h stacked (L, B, D)
        return ("layers", "batch", "state")
    return tuple([None] * rank)


def _paths(node, prefix: str = ""):
    """(path, leaf) of every tensor of a cache tree: dict keys and
    NamedTuple fields joined by '/'."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _paths(node[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for f in node._fields:
            yield from _paths(getattr(node, f), f"{prefix}/{f}")
    else:
        yield prefix, node


def cache_pspecs(cache, mesh) -> Dict[str, PSpec]:
    """The spec of every cache leaf, by its path."""
    return {p: logical_to_pspec(_cache_axes_for(p, len(x.shape)),
                                tuple(x.shape), _CACHE_RULES, mesh)
            for p, x in _paths(cache)}


def cache_shardings(cache, mesh) -> Dict[str, list]:
    """DTensor placements of every cache leaf, by its path."""
    return {p: placements(s, mesh) for p, s in cache_pspecs(cache,
                                                            mesh).items()}


@dataclasses.dataclass(frozen=True)
class ArchDef:
    name: str
    kind: str                               # "lm" | "encdec"
    config: object                          # LMConfig | EncDecConfig
    rules: Rules
    reduced_config: object                  # small same-family config
    optimizer_state: str = "fp32"           # "int8" for the 1T arch
    notes: str = ""

    def build(self):
        return LM(self.config) if self.kind == "lm" else EncDec(self.config)

    def build_reduced(self):
        return (LM(self.reduced_config) if self.kind == "lm"
                else EncDec(self.reduced_config))

    # -- shape support -------------------------------------------------
    def supports(self, shape_name: str) -> Tuple[bool, str]:
        cell = SHAPES[shape_name]
        if cell.name == "long_500k" and not self.config.sub_quadratic:
            return False, ("full-attention KV at 500k context is "
                           "unbounded; skipped per assignment policy")
        return True, ""

    # -- dry-run inputs ------------------------------------------------
    def input_specs(self, shape_name: str,
                    seq_len: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Meta tensors for the non-(params / state) inputs of the cell;
        ``seq_len`` stands in for the cell's length (the dry run traces
        xLSTM cells at short lengths)."""
        cell = SHAPES[shape_name]
        cfg = self.config
        b = cell.global_batch
        s = cell.seq_len if seq_len is None else seq_len
        if self.kind == "encdec":
            s_dec = max(s // 4, 8)
            if cell.mode == "train":
                return {"frames": _meta((b, s, cfg.d_model), _BF16),
                        "tokens": _meta((b, s_dec), _I32),
                        "targets": _meta((b, s_dec), _I32),
                        "mask": _meta((b, s_dec), torch.float32)}
            if cell.mode == "prefill":
                return {"frames": _meta((b, s, cfg.d_model), _BF16),
                        "tokens": _meta((b, s_dec), _I32)}
            return {"token": _meta((b,), _I32), "pos": _meta((b,), _I32)}
        if cell.mode == "train":
            specs = {"tokens": _meta((b, s), _I32),
                     "targets": _meta((b, s), _I32),
                     "mask": _meta((b, s), torch.float32)}
        elif cell.mode == "prefill":
            specs = {"tokens": _meta((b, s), _I32)}
        else:
            specs = {"token": _meta((b,), _I32), "pos": _meta((b,), _I32)}
        if getattr(cfg, "vlm_prefix", 0) and cell.mode != "decode":
            specs["patch_embeds"] = _meta((b, cfg.vlm_prefix, cfg.d_model),
                                          _BF16)
        return specs

    def input_pspecs(self, specs, mesh) -> Dict[str, PSpec]:
        """Batch-sharded inputs (replicated where the batch does not divide
        the data axes). Token-like inputs carry a logical 'seq' second axis,
        so a per-arch rule can turn on sequence parallelism (None under the
        default rules)."""
        out = {}
        for k, v in specs.items():
            rank = len(v.shape)
            axes = ("batch",) + (None,) * (rank - 1)
            if k in ("tokens", "targets", "mask", "frames") and rank >= 2:
                axes = ("batch", "seq") + (None,) * (rank - 2)
            out[k] = logical_to_pspec(axes, tuple(v.shape), self.rules, mesh)
        return out

    def input_shardings(self, specs, mesh) -> Dict[str, list]:
        """DTensor placements of every input, by name."""
        return {k: placements(s, mesh)
                for k, s in self.input_pspecs(specs, mesh).items()}

    def param_shardings(self, mesh):
        return spec_shardings(self.build().specs(), self.rules, mesh)


def lm_arch(name: str, *, reduced_overrides: Optional[dict] = None,
            rules_overrides: Optional[dict] = None,
            optimizer_state: str = "fp32", notes: str = "",
            **cfg_kw) -> ArchDef:
    cfg = LMConfig(name=name, **cfg_kw)
    red_kw = dict(cfg_kw)
    pattern = cfg_kw.get("pattern", ("attn",))
    red_kw.update({
        "n_layers": max(2 * len(pattern), 2),
        "d_model": 128,
        "n_heads": 4, "n_kv": min(cfg_kw.get("n_kv", 4), 4),
        "d_ff": 256 if cfg_kw.get("d_ff", 0) else 0,
        "vocab": 512,
    })
    if cfg_kw.get("n_experts"):
        red_kw["n_experts"] = 4
        red_kw["top_k"] = min(cfg_kw.get("top_k", 2), 2)
    if cfg_kw.get("window"):
        red_kw["window"] = 16
    if cfg_kw.get("vlm_prefix"):
        red_kw["vlm_prefix"] = 8
    if cfg_kw.get("kv_chunk"):
        red_kw["kv_chunk"] = 0
    if cfg_kw.get("head_dim"):
        red_kw["head_dim"] = 32
    red_kw.update(reduced_overrides or {})
    rules = dict(DEFAULT_RULES)
    rules.update(rules_overrides or {})
    return ArchDef(name=name, kind="lm", config=cfg, rules=rules,
                   reduced_config=LMConfig(name=name + "-reduced", **red_kw),
                   optimizer_state=optimizer_state, notes=notes)
