"""Transformer building blocks: RMSNorm, RoPE, GQA attention, MLPs, MoE (the
port of ``repro.models.layers``).

Every block comes as a ``specs()`` / apply pair: ``specs()`` returns the
:class:`ParamSpec` dict (shapes and logical sharding axes), the apply
function takes the materialised dict of tensors. The layouts are the
reference's (``wq (d, h, hd)``, ``wo (h, hd, d)``, experts leading), so a
reference parameter tree carried across with ``tree.from_numpy`` drops in.

Numerics follow the reference: bf16 weights and activations; float32 norm
statistics, RoPE angles, attention scores and softmax; where the reference
asks for ``preferred_element_type=float32`` the operands are widened to
float32 first (a bf16 product is exact in float32, so this is float32
accumulation). Plain bf16 products round their float32 sums to bf16, as
XLA's do, but in another summation order: outputs agree to a tolerance,
not bit for bit. Attention is written out as the reference writes it, not
through ``F.scaled_dot_product_attention``, whose fused kernels sum in
another order and mask differently.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .spec import ParamSpec

__all__ = [
    "rms_norm_spec", "rms_norm",
    "rope",
    "AttnConfig", "attention_specs", "attention", "attention_decode",
    "KVCache",
    "mlp_specs", "mlp", "MoEConfig", "moe_specs", "moe",
    "gelu", "softplus",
]

_F32 = torch.float32
_NEG = -1e30


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation (``F.gelu``'s
    default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no threshold, unlike
    ``F.softplus``)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rms_norm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), dtype=torch.bfloat16, init="ones")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.to(_F32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.to(_F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
         ) -> torch.Tensor:
    """x (..., S, n, hd), positions (..., S) -> same shape, rotated pairs.
    The frequencies are the reference's ``exp(-log(theta) * arange / half)``
    in float32."""
    half = x.shape[-1] // 2
    # log(theta) in float32 on the host: a 0-dim CPU tensor joins a CUDA
    # product as a scalar, with no copy to the card and no sync
    log_theta = torch.tensor(theta, dtype=_F32).log()
    freq = torch.exp(-log_theta * torch.arange(half, dtype=_F32,
                                               device=x.device) / half)
    ang = positions[..., None].to(_F32) * freq              # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(_F32), x[..., half:].to(_F32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (optional sliding window), train + cached decode paths
# ---------------------------------------------------------------------------

class AttnConfig(NamedTuple):
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float = 10000.0
    window: int = 0           # 0 = full causal; >0 = sliding-window attention
    kv_chunk: int = 0         # >0: blockwise scores over key chunks (memory)
    use_rope: bool = True
    causal: bool = True


class KVCache(NamedTuple):
    k: torch.Tensor    # (B, S_cache, n_kv, hd)
    v: torch.Tensor


def attention_specs(cfg: AttnConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    return {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (d, n, h) -> (..., n, h)."""
    return torch.einsum("...d,dnh->...nh", x, w)


def _qkv(params, x, cfg: AttnConfig, positions):
    q, k, v = (_proj(x, params[n]) for n in ("wq", "wk", "wv"))
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask(q_pos, k_pos, cfg: AttnConfig) -> torch.Tensor:
    """(..., Sq, Sk) additive mask in float32 (-1e30 where masked)."""
    dif = q_pos[..., :, None] - k_pos[..., None, :]
    ok = dif >= 0 if cfg.causal else torch.ones_like(dif, dtype=torch.bool)
    if cfg.window > 0:
        ok = ok & (dif < cfg.window)
    return _additive(ok)


def _additive(ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, 0.0, _NEG).to(_F32)


def _sdpa(q, k, v, mask, cfg: AttnConfig):
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd), mask (B|1, Sq, Sk) additive."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    q = q.reshape(b, sq, kvh, h // kvh, hd)
    scale = hd ** -0.5
    if cfg.kv_chunk and k.shape[1] > cfg.kv_chunk:
        return _sdpa_chunked(q, k, v, mask, scale, cfg)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q.to(_F32), k.to(_F32)) * scale
    scores = scores + mask[:, None, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(b, sq, h, hd)


def _sdpa_chunked(q, k, v, mask, scale, cfg: AttnConfig):
    """Blockwise attention over key chunks with an online softmax (running
    max, sum and accumulator a query); never forms the (Sq, Sk) scores."""
    b, sq, kvh, g, hd = q.shape
    sk = k.shape[1]
    c = cfg.kv_chunk
    if sk % c:
        raise ValueError(f"kv_chunk {c} must divide the key length {sk}")
    qf = q.to(_F32)
    m_run = torch.full((b, kvh, g, sq), -math.inf, dtype=_F32, device=q.device)
    l_run = torch.zeros((b, kvh, g, sq), dtype=_F32, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, hd), dtype=_F32, device=q.device)
    for j in range(sk // c):
        kb, vb = k[:, j * c:(j + 1) * c], v[:, j * c:(j + 1) * c]
        mb = mask[..., j * c:(j + 1) * c]
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, kb.to(_F32)) * scale
        s = s + mb[:, None, None, :, :]
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskh->bkgqh", p.to(q.dtype).to(_F32), vb.to(_F32))
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, kvh * g, hd).to(q.dtype)


def attention(params, x: torch.Tensor, cfg: AttnConfig,
              positions: Optional[torch.Tensor] = None,
              kv_override: Optional[tuple] = None) -> torch.Tensor:
    """Training / prefill path: full-sequence self-attention.

    kv_override: (k, v, k_positions) for cross-attention (enc-dec).
    """
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _qkv(params, x, cfg, positions)
    if kv_override is not None:
        k, v, k_pos = kv_override
    else:
        k_pos = positions
    out = _sdpa(q, k, v, _mask(positions, k_pos, cfg), cfg)
    return torch.einsum("bsnh,nhd->bsd", out, params["wo"])


def attention_decode(params, x: torch.Tensor, cfg: AttnConfig,
                     cache: KVCache, pos: torch.Tensor, donate: bool = False):
    """One-token decode: x (B, 1, D), pos (B,) absolute position.

    Returns (out (B, 1, D), new cache). The cache is a ring of length
    ``s_cache`` (``min(window, context)`` for SWA archs): position ``p``
    lives in slot ``p % s_cache``. The caller's cache is left as it was,
    unless ``donate``: then the new entries are written into it (views
    included) and it is returned as the new cache.
    """
    b = x.shape[0]
    s_cache = cache.k.shape[1]
    q, k, v = (_proj(x, params[n]) for n in ("wq", "wk", "wv"))
    if cfg.use_rope:
        q = rope(q, pos[:, None], cfg.rope_theta)
        k = rope(k, pos[:, None], cfg.rope_theta)
    slot = (pos % s_cache)[:, None]
    bidx = torch.arange(b, device=x.device)[:, None]
    put = "index_put_" if donate else "index_put"
    new_k = getattr(cache.k, put)((bidx, slot), k.to(cache.k.dtype))
    new_v = getattr(cache.v, put)((bidx, slot), v.to(cache.v.dtype))
    # positions currently held by each cache slot (ring semantics)
    slots = torch.arange(s_cache, device=x.device)[None, :]
    wraps = torch.div(pos[:, None], s_cache, rounding_mode="floor")
    slot_pos = slots + wraps * s_cache
    slot_pos = torch.where(slots > slot, slot_pos - s_cache, slot_pos)
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    k_pos = torch.where(valid, slot_pos, -1)
    dif = pos[:, None, None] - k_pos[:, None, :]
    ok = (dif >= 0) & valid[:, None, :]
    if cfg.window > 0:
        ok = ok & (dif < cfg.window)
    out = _sdpa(q, new_k, new_v, _additive(ok), cfg._replace(kv_chunk=0))
    out = torch.einsum("bsnh,nhd->bsd", out, params["wo"])
    return out, KVCache(new_k, new_v)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_specs(d: int, f: int, gated: bool = True) -> dict:
    s = {
        "wu": ParamSpec((d, f), ("embed", "mlp")),
        "wd": ParamSpec((f, d), ("mlp", "embed")),
    }
    if gated:
        s["wg"] = ParamSpec((d, f), ("embed", "mlp"))
    return s


def mlp(params, x: torch.Tensor, gated: bool = True) -> torch.Tensor:
    up = x @ params["wu"]
    if gated:
        gate = x @ params["wg"]
        h = F.silu(gate.to(_F32)).to(x.dtype) * up
    else:
        h = gelu(up.to(_F32)).to(x.dtype)
    return h @ params["wd"]


# ---------------------------------------------------------------------------
# Mixture of Experts (GShard-style capacity dispatch)
# ---------------------------------------------------------------------------

class MoEConfig(NamedTuple):
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


def moe_specs(cfg: MoEConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, e), ("embed", None), dtype=torch.float32),
        "wg": ParamSpec((e, d, f), ("experts", "embed", "mlp")),
        "wu": ParamSpec((e, d, f), ("experts", "embed", "mlp")),
        "wd": ParamSpec((e, f, d), ("experts", "mlp", "embed")),
    }


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, descending, ties to the lower
    index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe(params, x: torch.Tensor, cfg: MoEConfig, groups: int = 1,
        shard: Optional[tuple] = None):
    """Top-k routed MoE with per-expert capacity buffers.

    x (B, S, D) -> (y (B, S, D), aux_loss scalar). ``groups`` splits the
    tokens into independent dispatch groups, each with its own capacity
    ``max(int(capacity_factor * tokens_per_group * k / E), 1)``: it is part
    of the result (which tokens are dropped). A token's choice past its
    expert's capacity goes to the drop bucket ``E`` and contributes zero.
    The gates are the top-k router probabilities renormalised to sum to one;
    the aux loss is Switch's load-balancing term.

    ``shard`` is the reference's GSPMD sharding constraint on the dispatch
    buffers; on one device it constrains nothing, and it is accepted and
    ignored here (ROADMAP C18).
    """
    del shard
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    g = groups
    if t % g:
        raise ValueError(f"token count {t} not divisible by groups {g}")
    tl = t // g
    cap = max(int(cfg.capacity_factor * tl * k / e), 1)
    xt = x.reshape(g, tl, d)
    dev = x.device

    logits = torch.einsum("gtd,de->gte", xt.to(_F32), params["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, k)                    # (G, TL, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # position of each (token, choice) within its group-local expert queue
    onehot = F.one_hot(gate_idx, e).to(torch.int32)           # (G, TL, k, E)
    flat = onehot.reshape(g, tl * k, e)
    pie = torch.cumsum(flat, dim=1, dtype=torch.int32) * flat  # 1-based
    pos = pie.reshape(g, tl, k, e).amax(dim=-1) - 1           # (G, TL, k)
    keep = (pos >= 0) & (pos < cap)
    eidx = torch.where(keep, gate_idx, e).reshape(-1)         # e: drop bucket
    pidx = torch.where(keep, pos, 0).reshape(-1).long()

    # dispatch: scatter tokens into (G, E+1, cap, D); the drop bucket absorbs
    gi = torch.arange(g, device=dev)[:, None].expand(g, tl * k).reshape(-1)
    tok_rep = torch.arange(tl, device=dev)[:, None].expand(tl, k).reshape(-1)
    src = xt[:, tok_rep].reshape(-1, d)                       # (G*TL*k, D)
    buf = torch.zeros((g, e + 1, cap, d), dtype=x.dtype, device=dev)
    buf = buf.index_put((gi, eidx, pidx), src)[:, :e]

    # expert FFN, batched over (group, expert)
    gate = torch.einsum("gecd,edf->gecf", buf, params["wg"])
    up = torch.einsum("gecd,edf->gecf", buf, params["wu"])
    h = F.silu(gate.to(_F32)).to(x.dtype) * up
    out = torch.einsum("gecf,efd->gecd", h, params["wd"])     # (G, E, cap, D)

    # combine: gather each token's expert outputs, weight by gates
    out_pad = torch.cat([out, torch.zeros((g, 1, cap, d), dtype=out.dtype,
                                          device=dev)], dim=1)
    gathered = out_pad[gi, eidx, pidx].reshape(g, tl, k, d)
    y = torch.einsum("gtkd,gtk->gtd", gathered.to(_F32),
                     gate_vals * keep.to(_F32))
    y = y.to(x.dtype).reshape(b, s, d)

    # load-balancing aux loss (Switch-style)
    density = F.one_hot(gate_idx[..., 0], e).to(_F32).mean(dim=(0, 1))
    router_prob = probs.mean(dim=(0, 1))
    aux = (density * router_prob).sum() * e
    return y, aux
