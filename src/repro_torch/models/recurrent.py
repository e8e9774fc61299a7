"""Recurrent blocks: RG-LRU (RecurrentGemma / Griffin) and xLSTM (mLSTM /
sLSTM), the port of ``repro.models.recurrent``.

The reference runs RG-LRU's linear recurrence as ``jax.lax.associative_scan``
and the exponentially gated cells as ``lax.scan``. Torch has no associative
scan: :func:`rglru_scan` runs a log-step doubling scan (Hillis-Steele,
ceil(log2 S) rounds of the same combine), which sums in another order than
XLA's tree, so the two agree to a float32 tolerance, not bit for bit. The
cells step through time in a Python loop. Decode paths are single-step
state updates: the state is O(1) in the context.

The time axis of these recurrences is not order-invariant, so the paper's
transmission ordering applies to their weight streams only.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .layers import softplus
from .spec import ParamSpec

_F32 = torch.float32

__all__ = [
    "rglru_specs", "rglru_scan", "rglru_step", "RGLRUState",
    "conv1d_specs", "causal_conv1d", "causal_conv1d_step",
    "mlstm_specs", "mlstm_scan", "mlstm_scan_state", "mlstm_step",
    "MLSTMState", "mlstm_init_state",
    "slstm_specs", "slstm_scan", "slstm_scan_state", "slstm_step",
    "SLSTMState", "slstm_init_state",
]


# ---------------------------------------------------------------------------
# RG-LRU: h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
# ---------------------------------------------------------------------------

class RGLRUState(NamedTuple):
    h: torch.Tensor      # (B, D)


def rglru_specs(d: int) -> dict:
    return {
        "wa": ParamSpec((d, d), ("embed", "state")),
        "ba": ParamSpec((d,), ("state",), init="zeros", dtype=torch.float32),
        "wx": ParamSpec((d, d), ("embed", "state")),
        "bx": ParamSpec((d,), ("state",), init="zeros", dtype=torch.float32),
        # log-space decay parameter Lambda
        "lam": ParamSpec((d,), ("state",), init="ones", dtype=torch.float32),
    }


_C = 8.0  # Griffin's fixed exponent scale


def _rglru_gates(params, x):
    xf = x.to(_F32)
    r = torch.sigmoid(xf @ params["wa"].to(_F32) + params["ba"])
    i = torch.sigmoid(xf @ params["wx"].to(_F32) + params["bx"])
    # a_t = a^(c r_t) with log a = log sigmoid(Lambda) < 0 (Griffin Eq. 4)
    log_a = _C * r * (-softplus(-params["lam"]))
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-9)) * (i * xf)
    return a, b


def rglru_scan(params, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D): the recurrence over time as a doubling
    scan of the combine (a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)."""
    a, b = _rglru_gates(params, x)
    s = x.shape[1]
    shift = 1
    while shift < s:
        a_prev = torch.cat([torch.ones_like(a[:, :shift]), a[:, :-shift]], 1)
        b_prev = torch.cat([torch.zeros_like(b[:, :shift]), b[:, :-shift]], 1)
        b = a * b_prev + b
        a = a * a_prev
        shift *= 2
    return b.to(x.dtype)


def rglru_step(params, x: torch.Tensor, state: RGLRUState):
    """x (B, D) one step."""
    a, b = _rglru_gates(params, x)
    h = a * state.h + b
    return h.to(x.dtype), RGLRUState(h)


# ---------------------------------------------------------------------------
# Causal temporal conv (width w), used in Griffin blocks
# ---------------------------------------------------------------------------

def conv1d_specs(d: int, width: int = 4) -> dict:
    return {
        "w": ParamSpec((width, d), (None, "state"), dtype=torch.bfloat16),
        "b": ParamSpec((d,), ("state",), init="zeros", dtype=torch.bfloat16),
    }


def causal_conv1d(params, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time: x (B, S, D)."""
    w = params["w"]
    width, s = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, width - 1, 0))
    out = sum(xp[:, i:i + s, :] * w[i] for i in range(width))
    return out + params["b"]


def causal_conv1d_step(params, x: torch.Tensor, history: torch.Tensor):
    """x (B, D), history (B, width-1, D) -> (out (B, D), new history)."""
    window = torch.cat([history, x[:, None, :]], dim=1)      # (B, width, D)
    out = torch.einsum("bwd,wd->bd", window, params["w"]) + params["b"]
    return out, window[:, 1:, :]


# ---------------------------------------------------------------------------
# mLSTM: matrix memory C_t = f C_{t-1} + i v k^T (exponential gating)
# ---------------------------------------------------------------------------

class MLSTMState(NamedTuple):
    c: torch.Tensor     # (B, H, hd, hd)  memory matrix (value x key)
    n: torch.Tensor     # (B, H, hd)      normalizer
    m: torch.Tensor     # (B, H)          gate stabilizer (log space)


def mlstm_specs(d: int, n_heads: int) -> dict:
    hd = d // n_heads
    return {
        "wq": ParamSpec((d, n_heads, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, n_heads, hd), ("embed", "heads", "head_dim")),
        "wv": ParamSpec((d, n_heads, hd), ("embed", "heads", "head_dim")),
        "wi": ParamSpec((d, n_heads), ("embed", "heads"), dtype=torch.float32),
        "wf": ParamSpec((d, n_heads), ("embed", "heads"), dtype=torch.float32),
        "wo_gate": ParamSpec((d, d), ("embed", "state")),
    }


def _mlstm_qkv(params, x):
    q, k, v = (torch.einsum("...d,dnh->...nh", x, params[n])
               for n in ("wq", "wk", "wv"))
    xf = x.to(_F32)
    return q, k, v, xf @ params["wi"], xf @ params["wf"]


def _mlstm_cell(state: MLSTMState, q, k, v, i_pre, f_pre, hd):
    """One stabilised mLSTM step; all (B, H, ...) float32."""
    log_f = -softplus(-f_pre)                          # log sigmoid(f)
    m_new = torch.maximum(log_f + state.m, i_pre)
    f_st = torch.exp(log_f + state.m - m_new)
    i_st = torch.exp(i_pre - m_new)
    kn = k * (hd ** -0.5)
    c_new = f_st[..., None, None] * state.c + i_st[..., None, None] * (
        v[..., :, None] * kn[..., None, :])
    n_new = f_st[..., None] * state.n + i_st[..., None] * kn
    num = torch.einsum("bhvk,bhk->bhv", c_new, q)
    den = torch.einsum("bhk,bhk->bh", n_new, q).abs()
    h = num / torch.clamp(den, min=1.0)[..., None]
    return h, MLSTMState(c_new, n_new, m_new)


def mlstm_init_state(b: int, h: int, hd: int, device=None) -> MLSTMState:
    return MLSTMState(torch.zeros((b, h, hd, hd), dtype=_F32, device=device),
                      torch.zeros((b, h, hd), dtype=_F32, device=device),
                      torch.full((b, h), -1e30, dtype=_F32, device=device))


def _out_gate(params, x):
    return torch.sigmoid(x.to(_F32) @ params["wo_gate"].to(_F32))


def mlstm_scan_state(params, x: torch.Tensor, n_heads: int):
    """x (B, S, D) -> (y (B, S, D), the state after the last step: what a
    prefill caches), stepping through time."""
    b, s, d = x.shape
    hd = d // n_heads
    q, k, v, i_pre, f_pre = _mlstm_qkv(params, x)
    state = mlstm_init_state(b, n_heads, hd, x.device)
    hs = []
    for t in range(s):
        h, state = _mlstm_cell(state, q[:, t].to(_F32), k[:, t].to(_F32),
                               v[:, t].to(_F32), i_pre[:, t], f_pre[:, t], hd)
        hs.append(h)
    y = _out_gate(params, x) * torch.stack(hs, dim=1).reshape(b, s, d)
    return y.to(x.dtype), state


def mlstm_scan(params, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D)."""
    return mlstm_scan_state(params, x, n_heads)[0]


def mlstm_step(params, x: torch.Tensor, state: MLSTMState, n_heads: int):
    """x (B, D) one decode step."""
    b, d = x.shape
    hd = d // n_heads
    q, k, v, i_pre, f_pre = _mlstm_qkv(params, x)
    h, state = _mlstm_cell(state, q.to(_F32), k.to(_F32), v.to(_F32),
                           i_pre, f_pre, hd)
    return (_out_gate(params, x) * h.reshape(b, d)).to(x.dtype), state


# ---------------------------------------------------------------------------
# sLSTM: scalar memory with exponential gating + recurrent h feedback
# ---------------------------------------------------------------------------

class SLSTMState(NamedTuple):
    c: torch.Tensor     # (B, D)
    n: torch.Tensor     # (B, D)
    m: torch.Tensor     # (B, D)
    h: torch.Tensor     # (B, D)


def slstm_specs(d: int, n_heads: int) -> dict:
    hd = d // n_heads
    # recurrent R matrices are head-wise block diagonal: (H, hd, hd)
    f32 = torch.float32
    return {
        "wz": ParamSpec((d, d), ("embed", "state")),
        "wi": ParamSpec((d, d), ("embed", "state"), dtype=f32),
        "wf": ParamSpec((d, d), ("embed", "state"), dtype=f32),
        "wo": ParamSpec((d, d), ("embed", "state")),
        "rz": ParamSpec((n_heads, hd, hd), ("heads", None, None)),
        "ri": ParamSpec((n_heads, hd, hd), ("heads", None, None), dtype=f32),
        "rf": ParamSpec((n_heads, hd, hd), ("heads", None, None), dtype=f32),
        "ro": ParamSpec((n_heads, hd, hd), ("heads", None, None)),
    }


def _headwise(r, h, n_heads):
    """h (B, D) through the block-diagonal (H, hd, hd) ``r``, in h's dtype
    (the reference casts ``r`` to it)."""
    b, d = h.shape
    hh = h.reshape(b, n_heads, d // n_heads)
    return torch.einsum("bnh,nhk->bnk", hh, r.to(h.dtype)).reshape(b, d)


def slstm_cell(params, x, state: SLSTMState, n_heads: int):
    """x (B, D) preactivations; returns (h, new state), float32."""
    xf = x.to(_F32)
    hprev = state.h
    z_pre = xf @ params["wz"].to(_F32) + _headwise(params["rz"], hprev,
                                                   n_heads).to(_F32)
    i_pre = xf @ params["wi"] + _headwise(params["ri"], hprev, n_heads)
    f_pre = xf @ params["wf"] + _headwise(params["rf"], hprev, n_heads)
    o_pre = xf @ params["wo"].to(_F32) + _headwise(params["ro"], hprev,
                                                   n_heads).to(_F32)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    log_f = -softplus(-f_pre)
    m_new = torch.maximum(log_f + state.m, i_pre)
    i_st = torch.exp(i_pre - m_new)
    f_st = torch.exp(log_f + state.m - m_new)
    c_new = f_st * state.c + i_st * z
    n_new = f_st * state.n + i_st
    h_new = o * (c_new / torch.clamp(n_new, min=1e-6))
    return h_new, SLSTMState(c_new, n_new, m_new, h_new)


def slstm_init_state(b: int, d: int, device=None) -> SLSTMState:
    """Zero c, n and h, m at -1e30; each its own tensor, so a donated
    decode step (``LM.decode_step(donate=True)``) can write each."""
    def z():
        return torch.zeros((b, d), dtype=_F32, device=device)
    return SLSTMState(z(), z(), torch.full((b, d), -1e30, dtype=_F32,
                                           device=device), z())


def slstm_scan_state(params, x: torch.Tensor, n_heads: int):
    """x (B, S, D) -> (y (B, S, D), the state after the last step)."""
    b, s, d = x.shape
    state = slstm_init_state(b, d, x.device)
    hs = []
    for t in range(s):
        h, state = slstm_cell(params, x[:, t], state, n_heads)
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), state


def slstm_scan(params, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    return slstm_scan_state(params, x, n_heads)[0]


def slstm_step(params, x: torch.Tensor, state: SLSTMState, n_heads: int):
    h, state = slstm_cell(params, x, state, n_heads)
    return h.to(x.dtype), state
