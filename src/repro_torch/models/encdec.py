"""Whisper-style encoder-decoder backbone (the port of
``repro.models.encdec``).

The audio conv frontend is a stub, as in the reference: callers pass
precomputed frame embeddings (B, S_enc, D). The transformer backbone is
whole: bidirectional encoder, causal decoder with learned positions and
cross-attention (k / v from the encoder memory, recomputed a layer or
cached by ``init_cache``), cached decode. Layers are stacked on a leading
``n_layers`` axis as in the reference; a Python loop walks them.
"""
from __future__ import annotations

import dataclasses

import torch

from ..tree import take
from . import layers as L
from .spec import ParamSpec, _map

_F32 = torch.float32
_BF16 = torch.bfloat16

__all__ = ["EncDecConfig", "EncDec"]


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_layers: int            # per stack (24 enc + 24 dec for whisper-medium)
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    remat: bool = True
    norm_eps: float = 1e-6

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // 256) * 256

    def attn_cfg(self, causal: bool) -> L.AttnConfig:
        # Whisper uses learned absolute positions, not RoPE.
        return L.AttnConfig(self.d_model, self.n_heads, self.n_kv, self.hd,
                            use_rope=False, causal=causal)

    @property
    def sub_quadratic(self) -> bool:
        return False

    def cache_len(self, context: int) -> int:
        return context


def _enc_block_specs(cfg: EncDecConfig) -> dict:
    return {"ln1": L.rms_norm_spec(cfg.d_model),
            "attn": L.attention_specs(cfg.attn_cfg(False)),
            "ln2": L.rms_norm_spec(cfg.d_model),
            "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff, gated=False)}


def _dec_block_specs(cfg: EncDecConfig) -> dict:
    return {"ln1": L.rms_norm_spec(cfg.d_model),
            "self_attn": L.attention_specs(cfg.attn_cfg(True)),
            "ln_x": L.rms_norm_spec(cfg.d_model),
            "cross_attn": L.attention_specs(cfg.attn_cfg(False)),
            "ln2": L.rms_norm_spec(cfg.d_model),
            "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff, gated=False)}


def _cross_kv(memory, p):
    return (torch.einsum("bsd,dnh->bsnh", memory, p["wk"]),
            torch.einsum("bsd,dnh->bsnh", memory, p["wv"]))


class EncDec:
    def __init__(self, cfg: EncDecConfig):
        self.cfg = cfg

    def specs(self) -> dict:
        cfg = self.cfg

        def stack(s: ParamSpec) -> ParamSpec:
            return ParamSpec((cfg.n_layers,) + s.shape, ("layers",) + s.axes,
                             s.dtype, s.init, s.scale)

        return {
            "embed": ParamSpec((cfg.padded_vocab, cfg.d_model),
                               ("vocab", "embed"), init="embed", scale=0.02),
            "pos_dec": ParamSpec((8192, cfg.d_model), (None, "embed"),
                                 init="embed", scale=0.01),
            "enc": _map(stack, _enc_block_specs(cfg)),
            "dec": _map(stack, _dec_block_specs(cfg)),
            "ln_enc": L.rms_norm_spec(cfg.d_model),
            "ln_f": L.rms_norm_spec(cfg.d_model),
        }

    # -- encoder --------------------------------------------------------
    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, S_enc, D) stubbed frame embeddings -> memory."""
        cfg = self.cfg
        acfg = cfg.attn_cfg(False)
        x = frames.to(_BF16)
        for i in range(cfg.n_layers):
            p = take(params["enc"], i)
            h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
            x = x + L.attention(p["attn"], h, acfg)
            h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
            x = x + L.mlp(p["mlp"], h, gated=False)
        return L.rms_norm(x, params["ln_enc"], cfg.norm_eps)

    # -- decoder --------------------------------------------------------
    def _dec_embed(self, params, tokens, pos0=0):
        s = tokens.shape[1]
        pos = pos0 + torch.arange(s, device=tokens.device)
        return (params["embed"][tokens] + params["pos_dec"][pos][None]
                ).to(_BF16)

    def decode_train(self, params, tokens, memory):
        """Teacher-forced decoding: tokens (B, S_dec), memory (B, S_enc, D)."""
        cfg = self.cfg
        self_cfg, cross_cfg = cfg.attn_cfg(True), cfg.attn_cfg(False)
        b, s_enc, _ = memory.shape
        mem_pos = torch.arange(s_enc, device=memory.device).expand(b, s_enc)
        x = self._dec_embed(params, tokens)
        for i in range(cfg.n_layers):
            p = take(params["dec"], i)
            h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
            x = x + L.attention(p["self_attn"], h, self_cfg)
            h = L.rms_norm(x, p["ln_x"], cfg.norm_eps)
            mk, mv = _cross_kv(memory, p["cross_attn"])
            x = x + L.attention(p["cross_attn"], h, cross_cfg,
                                kv_override=(mk, mv, mem_pos))
            h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
            x = x + L.mlp(p["mlp"], h, gated=False)
        return self._logits(params, x)

    def _logits(self, params, x):
        cfg = self.cfg
        x = L.rms_norm(x, params["ln_f"], cfg.norm_eps).to(_F32)
        logits = x @ params["embed"].to(_F32).T
        if cfg.padded_vocab != cfg.vocab:
            pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
            logits = logits.masked_fill(pad, -1e30)
        return logits

    def forward(self, params, frames, tokens):
        return self.decode_train(params, tokens, self.encode(params, frames))

    def loss(self, params, frames, tokens, targets, mask):
        logits = self.forward(params, frames, tokens)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, targets[..., None].long(),
                                    dim=-1)[..., 0]
        nll = (lse - gold) * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)

    # -- cached decode ---------------------------------------------------
    def init_cache(self, b: int, context: int, memory: torch.Tensor,
                   params=None):
        """Self-attention KV cache (a layer each) and the cross-attention
        k / v, computed once a layer from the encoder memory when ``params``
        is given (the serving path); with ``params=None`` the cache holds
        the memory and every decode step recomputes them."""
        cfg = self.cfg
        kv, hd, nl = cfg.n_kv, cfg.hd, cfg.n_layers
        self_k = torch.zeros((nl, b, context, kv, hd), dtype=_BF16,
                             device=memory.device)
        cache = {"self": L.KVCache(self_k, torch.zeros_like(self_k))}
        if params is not None:
            cw = params["dec"]["cross_attn"]
            mk = torch.einsum("bsd,ldnh->lbsnh", memory, cw["wk"])
            mv = torch.einsum("bsd,ldnh->lbsnh", memory, cw["wv"])
            cache["cross"] = L.KVCache(mk.to(_BF16), mv.to(_BF16))
        else:
            cache["memory"] = memory
        return cache

    def decode_step(self, params, token, cache, pos, donate: bool = False):
        """token (B,), pos (B,). Cross-attends the cached (or recomputed)
        k / v; returns (logits (B, V), new cache). ``donate``: the step
        writes its self-attention entries into ``cache`` and returns it."""
        cfg = self.cfg
        self_cfg, cross_cfg = cfg.attn_cfg(True), cfg.attn_cfg(False)
        precomputed = "cross" in cache
        if precomputed:
            b, s_enc = cache["cross"].k.shape[1], cache["cross"].k.shape[2]
        else:
            b, s_enc, _ = cache["memory"].shape
        mem_pos = torch.arange(s_enc, device=token.device).expand(b, s_enc)
        x = (params["embed"][token[:, None]]
             + params["pos_dec"][pos][:, None]).to(_BF16)
        new_k, new_v = [], []
        for i in range(cfg.n_layers):
            p = take(params["dec"], i)
            h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
            a, kv = L.attention_decode(
                p["self_attn"], h, self_cfg,
                L.KVCache(cache["self"].k[i], cache["self"].v[i]), pos,
                **({"donate": True} if donate else {}))
            new_k.append(kv.k)
            new_v.append(kv.v)
            x = x + a
            h = L.rms_norm(x, p["ln_x"], cfg.norm_eps)
            if precomputed:
                mk, mv = cache["cross"].k[i], cache["cross"].v[i]
            else:
                mk, mv = _cross_kv(cache["memory"], p["cross_attn"])
            x = x + L.attention(p["cross_attn"], h, cross_cfg,
                                kv_override=(mk, mv, mem_pos))
            h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
            x = x + L.mlp(p["mlp"], h, gated=False)
        logits = self._logits(params, x)[:, 0]
        if donate:
            return logits, cache
        new_cache = dict(cache)
        new_cache["self"] = L.KVCache(torch.stack(new_k), torch.stack(new_v))
        return logits, new_cache
