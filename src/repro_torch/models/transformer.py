"""Decoder LM with composable block patterns (the port of
``repro.models.transformer``).

One model class covers the whole architecture pool:
  dense GQA        pattern ("attn",)                 minicpm/phi3/starcoder2/danube
  MoE              pattern ("attn",) + moe config    mixtral/kimi-k2
  Griffin hybrid   pattern ("rec", "rec", "attn")    recurrentgemma
  xLSTM            pattern ("mlstm", "slstm")        xlstm
  VLM backbone     dense + prefix embeddings          internvl2

Parameters are the reference's dict: one group of blocks per pattern cycle,
stacked on a leading ``n_groups`` axis (``params["blocks"]``), and a tail of
``n_layers % len(pattern)`` blocks applied unstacked. The reference scans
the groups with ``lax.scan``; here a Python loop walks the stacked leaves.
Caches have the reference's structure too (``init_cache``), so a reference
cache carried across with ``tree.from_numpy`` is a valid cache here.

Three modes share the block code: "train" (no cache), "prefill" (returns
the cache), "decode" (one token, consumes the cache). No mode writes into a
cache it was given, unless a decode step is told to (``donate=True``, the
counterpart of donating the cache to a jitted step): then it writes the new
entries and states into the caller's cache and returns that cache, so a
step holds one cache, not two. ``remat`` changes no forward value: it takes
effect with the trainer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..tree import from_numpy, leaves, map_leaves, take, unflatten
from . import layers as L
from . import recurrent as R
from .spec import ParamSpec, _map

_F32 = torch.float32
_BF16 = torch.bfloat16

__all__ = ["LMConfig", "LM", "lm_params_from_jax"]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                      # 0 -> d_model // n_heads
    pattern: Tuple[str, ...] = ("attn",)
    rope_theta: float = 10000.0
    window: int = 0                        # sliding-window size; 0 = full attn
    n_experts: int = 0                     # >0 -> MoE MLP in attn blocks
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_groups: int = 1                    # dispatch groups (part of routing)
    moe_shard: Optional[Tuple[Optional[str], Optional[str]]] = None
    # ^ the reference's GSPMD constraints on the dispatch path; one device
    #   has nothing to constrain (layers.moe, ROADMAP C18)
    tp_bf16_boundary: bool = False
    # ^ block outputs cast to bf16 (the reference adds an XLA optimization
    #   barrier for its tensor-parallel all-reduce; one device has none)
    gated_mlp: bool = True
    tied_embeddings: bool = True
    vlm_prefix: int = 0                    # vision stub: prepended patch embeds
    kv_chunk: int = 0                      # blockwise attention chunk (0 = off)
    remat: bool = True
    norm_eps: float = 1e-6

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256; logits in the pad region
        are -1e30 (never sampled, never targeted)."""
        return -(-self.vocab // 256) * 256

    @property
    def attn_cfg(self) -> L.AttnConfig:
        return L.AttnConfig(self.d_model, self.n_heads, self.n_kv, self.hd,
                            self.rope_theta, self.window, self.kv_chunk)

    @property
    def moe_cfg(self) -> Optional[L.MoEConfig]:
        if self.n_experts == 0:
            return None
        return L.MoEConfig(self.d_model, self.d_ff, self.n_experts,
                           self.top_k, self.capacity_factor)

    @property
    def sub_quadratic(self) -> bool:
        """True when context memory is bounded (SWA or recurrent blocks)."""
        return any(k != "attn" for k in self.pattern) or self.window > 0

    def cache_len(self, context: int) -> int:
        """KV entries needed per attention block for a given context."""
        return min(context, self.window) if self.window > 0 else context


# ---------------------------------------------------------------------------
# Per-block specs / apply / cache
# ---------------------------------------------------------------------------

def _block_specs(kind: str, cfg: LMConfig) -> dict:
    d = cfg.d_model
    if kind == "attn":
        s = {"ln1": L.rms_norm_spec(d), "attn": L.attention_specs(cfg.attn_cfg),
             "ln2": L.rms_norm_spec(d)}
        if cfg.moe_cfg is not None:
            s["moe"] = L.moe_specs(cfg.moe_cfg)
        else:
            s["mlp"] = L.mlp_specs(d, cfg.d_ff, cfg.gated_mlp)
        return s
    if kind == "rec":
        s = {"ln1": L.rms_norm_spec(d),
             "in_main": ParamSpec((d, d), ("embed", "state")),
             "in_gate": ParamSpec((d, d), ("embed", "state")),
             "conv": R.conv1d_specs(d),
             "rglru": R.rglru_specs(d),
             "out": ParamSpec((d, d), ("state", "embed")),
             "ln2": L.rms_norm_spec(d)}
        if cfg.d_ff > 0:
            s["mlp"] = L.mlp_specs(d, cfg.d_ff, cfg.gated_mlp)
        return s
    if kind == "mlstm":
        return {"ln1": L.rms_norm_spec(d), "cell": R.mlstm_specs(d, cfg.n_heads)}
    if kind == "slstm":
        return {"ln1": L.rms_norm_spec(d), "cell": R.slstm_specs(d, cfg.n_heads)}
    raise ValueError(f"unknown block kind {kind!r}")


def _block_cache(kind: str, cfg: LMConfig, b: int, context: int, device):
    d, hd, kv = cfg.d_model, cfg.hd, cfg.n_kv
    if kind == "attn":
        c = cfg.cache_len(context)
        return L.KVCache(
            torch.zeros((b, c, kv, hd), dtype=_BF16, device=device),
            torch.zeros((b, c, kv, hd), dtype=_BF16, device=device))
    if kind == "rec":
        return {"h": torch.zeros((b, d), dtype=_F32, device=device),
                "conv": torch.zeros((b, 3, d), dtype=_BF16, device=device)}
    if kind == "mlstm":
        return R.mlstm_init_state(b, cfg.n_heads, d // cfg.n_heads, device)
    if kind == "slstm":
        return R.slstm_init_state(b, d, device)
    raise ValueError(kind)


def _apply_mlp(params, cfg: LMConfig, x):
    if cfg.moe_cfg is not None and "moe" in params:
        groups = cfg.moe_groups
        # decode steps carry few tokens; fall back to global dispatch
        if x.shape[0] * x.shape[1] % max(groups, 1):
            groups = 1
        return L.moe(params["moe"], x, cfg.moe_cfg, groups=groups,
                     shard=cfg.moe_shard)
    return L.mlp(params["mlp"], x, cfg.gated_mlp), 0.0


def _donated(cache, new):
    """Write a decode step's new cache leaves into the given ones; returns
    the given cache."""
    for old, fresh in zip(leaves(cache), leaves(new)):
        old.copy_(fresh)
    return cache


def _block_apply(kind: str, cfg: LMConfig, params, x, mode: str, cache, pos,
                 donate: bool = False):
    """x (B, S, D) [S=1 in decode]; returns (x, new_cache, aux_loss).
    ``donate``: a decode step writes into ``cache`` (see the module)."""
    aux = 0.0
    if kind == "attn":
        h = L.rms_norm(x, params["ln1"], cfg.norm_eps)
        if mode == "train":
            a = L.attention(params["attn"], h, cfg.attn_cfg)
            new_cache = cache
        elif mode == "prefill":
            a, new_cache = _attention_prefill(params["attn"], h, cfg, cache)
        else:
            a, new_cache = L.attention_decode(
                params["attn"], h, cfg.attn_cfg, cache, pos,
                **({"donate": True} if donate else {}))
        if cfg.tp_bf16_boundary:
            a = a.to(_BF16)
        x = x + a
        h = L.rms_norm(x, params["ln2"], cfg.norm_eps)
        m, aux = _apply_mlp(params, cfg, h)
        if cfg.tp_bf16_boundary:
            m = m.to(_BF16)
        return x + m, new_cache, aux

    if kind == "rec":
        h = L.rms_norm(x, params["ln1"], cfg.norm_eps)
        main = h @ params["in_main"]
        gate = L.gelu((h @ params["in_gate"]).to(_F32)).to(x.dtype)
        if mode == "decode":
            c_out, conv_hist = R.causal_conv1d_step(
                params["conv"], main[:, 0], cache["conv"])
            r_out, rst = R.rglru_step(params["rglru"], c_out,
                                      R.RGLRUState(cache["h"]))
            y = r_out[:, None, :]
            new_cache = {"h": rst.h, "conv": conv_hist}
            if donate:
                new_cache = _donated(cache, new_cache)
        else:
            c_out = R.causal_conv1d(params["conv"], main)
            y = R.rglru_scan(params["rglru"], c_out)
            if mode == "prefill":
                new_cache = {"h": y[:, -1].to(_F32), "conv": main[:, -3:]}
            else:
                new_cache = cache
        y = y * gate
        x = x + y @ params["out"]
        if "mlp" in params:
            h2 = L.rms_norm(x, params["ln2"], cfg.norm_eps)
            m, aux = _apply_mlp(params, cfg, h2)
            x = x + m
        return x, new_cache, aux

    if kind in ("mlstm", "slstm"):
        h = L.rms_norm(x, params["ln1"], cfg.norm_eps)
        cell = params["cell"]
        step, scan = ((R.mlstm_step, R.mlstm_scan_state) if kind == "mlstm"
                      else (R.slstm_step, R.slstm_scan_state))
        if mode == "decode":
            y, new_cache = step(cell, h[:, 0], cache, cfg.n_heads)
            y = y[:, None, :]
            if donate:
                new_cache = _donated(cache, new_cache)
        else:
            y, state = scan(cell, h, cfg.n_heads)
            new_cache = state if mode == "prefill" else cache
        return x + y, new_cache, aux

    raise ValueError(kind)


def _attention_prefill(params, h, cfg: LMConfig, cache: L.KVCache):
    """Full-sequence attention that also fills the (ring) KV cache with the
    last ``min(s, c)`` positions, position ``p`` in slot ``p % c``."""
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device).expand(b, s)
    q, k, v = L._qkv(params, h, cfg.attn_cfg, positions)
    mask = L._mask(positions, positions, cfg.attn_cfg)
    out = L._sdpa(q, k, v, mask, cfg.attn_cfg)
    y = torch.einsum("bsnh,nhd->bsd", out, params["wo"])
    c = cache.k.shape[1]
    keep = min(s, c)
    p_keep = torch.arange(s - keep, s, device=h.device)
    slots = p_keep % c
    nk = cache.k.clone()
    nv = cache.v.clone()
    nk[:, slots] = k[:, p_keep].to(nk.dtype)
    nv[:, slots] = v[:, p_keep].to(nv.dtype)
    return y, L.KVCache(nk, nv)


def _stack(trees):
    """Stack same-structured trees on a new leading axis."""
    cols = zip(*[leaves(t) for t in trees])
    return unflatten(trees[0], [torch.stack(c) for c in cols])


def lm_params_from_jax(params, device: DeviceLike = None):
    """A reference LM or enc-dec parameter tree (or cache), as numpy arrays
    or anything ``np.array`` takes, as the same tree of tensors on
    ``device``, bf16 included (``tree.from_numpy``)."""
    return from_numpy(params, device)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class LM:
    """Functional decoder LM: parameters and caches are passed in."""

    def __init__(self, cfg: LMConfig):
        self.cfg = cfg
        p = len(cfg.pattern)
        self.n_groups = cfg.n_layers // p
        self.tail = tuple(cfg.pattern[:cfg.n_layers % p])

    # -- specs ---------------------------------------------------------
    def specs(self) -> dict:
        cfg = self.cfg
        group = {f"b{i}_{k}": _block_specs(k, cfg)
                 for i, k in enumerate(cfg.pattern)}

        def stack(s: ParamSpec) -> ParamSpec:
            return ParamSpec((self.n_groups,) + s.shape, ("layers",) + s.axes,
                             s.dtype, s.init, s.scale)
        specs = {
            "embed": ParamSpec((cfg.padded_vocab, cfg.d_model),
                               ("vocab", "embed"), init="embed", scale=0.02),
            "blocks": _map(stack, group),
            "ln_f": L.rms_norm_spec(cfg.d_model),
        }
        if self.tail:
            specs["tail"] = {f"t{i}_{k}": _block_specs(k, cfg)
                             for i, k in enumerate(self.tail)}
        if not cfg.tied_embeddings:
            specs["unembed"] = ParamSpec((cfg.d_model, cfg.padded_vocab),
                                         ("embed", "vocab"), scale=0.02)
        if cfg.vlm_prefix:
            # projection for stubbed vision patch embeddings
            specs["vis_proj"] = ParamSpec((cfg.d_model, cfg.d_model),
                                          ("embed", "state"))
        return specs

    # -- caches --------------------------------------------------------
    def init_cache(self, b: int, context: int, device: DeviceLike = None):
        """Zero caches on ``device`` (CUDA unless the caller asks for the
        CPU): each pattern block's cache stacked over the groups (separate
        memory a group: decode never writes in place, but a caller may),
        and the tail's unstacked."""
        cfg = self.cfg
        dev = resolve_device(device)

        def per_group(kind):
            one = _block_cache(kind, cfg, b, context, dev)
            return map_leaves(lambda x: x.expand(self.n_groups, *x.shape)
                              .clone(), one)
        cache = {f"b{i}_{k}": per_group(k) for i, k in enumerate(cfg.pattern)}
        if self.tail:
            cache["tail"] = {f"t{i}_{k}": _block_cache(k, cfg, b, context, dev)
                             for i, k in enumerate(self.tail)}
        return cache

    # -- forward -------------------------------------------------------
    def _embed(self, params, tokens, patch_embeds=None):
        cfg = self.cfg
        x = params["embed"][tokens].to(_BF16)
        if cfg.vlm_prefix:
            if patch_embeds is None:
                raise ValueError("VLM arch needs patch_embeds")
            pe = torch.einsum("bpd,de->bpe", patch_embeds.to(_BF16),
                              params["vis_proj"])
            x = torch.cat([pe, x], dim=1)
        return x

    def _blocks(self, params, x, mode, cache, pos, donate=False):
        cfg = self.cfg
        names = [f"b{i}_{k}" for i, k in enumerate(cfg.pattern)]
        aux_total = torch.zeros((), dtype=_F32, device=x.device)
        group_caches = {n: [] for n in names}
        for g in range(self.n_groups):
            for name, kind in zip(names, cfg.pattern):
                gp = take(params["blocks"][name], g)
                gc = None if mode == "train" else take(cache[name], g)
                x, nc, a = _block_apply(kind, cfg, gp, x, mode, gc, pos,
                                        donate)
                group_caches[name].append(nc)
                aux_total = aux_total + a
        if mode == "train" or donate:   # donated: written in place
            new_cache = cache
        else:
            new_cache = {n: _stack(group_caches[n]) for n in names}

        if self.tail:
            tail_cache = {} if mode == "train" else dict(cache["tail"])
            new_tail = {}
            for i, kind in enumerate(self.tail):
                name = f"t{i}_{kind}"
                x, nc, a = _block_apply(kind, cfg, params["tail"][name], x,
                                        mode, tail_cache.get(name), pos,
                                        donate)
                new_tail[name] = nc
                aux_total = aux_total + a
            if mode != "train" and not donate:
                new_cache["tail"] = new_tail
        return x, new_cache, aux_total

    def _logits(self, params, x):
        cfg = self.cfg
        x = L.rms_norm(x, params["ln_f"], cfg.norm_eps).to(_F32)
        if cfg.tied_embeddings:
            logits = x @ params["embed"].to(_F32).T
        else:
            logits = x @ params["unembed"].to(_F32)
        if cfg.padded_vocab != cfg.vocab:
            pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
            logits = logits.masked_fill(pad, -1e30)
        return logits

    def forward(self, params, tokens: torch.Tensor,
                patch_embeds: Optional[torch.Tensor] = None):
        """Train-mode forward: tokens (B, S) -> (logits (B, S[+prefix], V),
        MoE aux loss)."""
        x = self._embed(params, tokens, patch_embeds)
        x, _, aux = self._blocks(params, x, "train", None, None)
        return self._logits(params, x), aux

    def loss(self, params, tokens, targets, mask,
             patch_embeds: Optional[torch.Tensor] = None):
        """Mean masked cross-entropy (float32), plus 0.01 x the MoE aux
        loss."""
        logits, aux = self.forward(params, tokens, patch_embeds)
        if self.cfg.vlm_prefix:
            logits = logits[:, self.cfg.vlm_prefix:]
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, targets[..., None].long(),
                                    dim=-1)[..., 0]
        nll = (lse - gold) * mask
        loss = nll.sum() / torch.clamp(mask.sum(), min=1.0)
        return loss + 0.01 * aux

    def prefill(self, params, tokens, context: int,
                patch_embeds: Optional[torch.Tensor] = None):
        """Run the prompt, return (last-position logits, cache)."""
        cache = self.init_cache(tokens.shape[0], context, tokens.device)
        x = self._embed(params, tokens, patch_embeds)
        x, cache, _ = self._blocks(params, x, "prefill", cache, None)
        return self._logits(params, x[:, -1:])[:, 0], cache

    def decode_step(self, params, token: torch.Tensor, cache,
                    pos: torch.Tensor, donate: bool = False):
        """token (B,), pos (B,) -> (logits (B, V), new cache). ``donate``:
        the step writes into ``cache`` and returns it (same values)."""
        x = params["embed"][token[:, None]].to(_BF16)
        x, cache, _ = self._blocks(params, x, "decode", cache, pos, donate)
        return self._logits(params, x)[:, 0], cache
