"""Functional AdamW with optional block-wise int8 first and second moments
(the port of ``repro.optim.adamw``).

The int8 state path (``state_dtype="int8"``) is the one kimi-k2's config
uses: m and v are stored as uint8 codes with one float32 scale a block of
256 values along the parameter's last axis (bnb-style), decoded on the fly
inside the update.

The arithmetic is the reference's, not ``torch.optim.AdamW``'s: float32
bias corrections ``1 - b ** step``, ``delta = mhat / (sqrt(vhat) + eps)``,
weight decay on leaves of two or more dimensions only (on the stacked tree,
so a stacked norm weight of shape (L, d) is decayed, as in the reference),
and the new parameter computed in float32 and cast back to its dtype (a
bf16 parameter keeps no float32 master copy).

The two code tables are the reference's float32 values, carried as
constants: the reference builds them with ``jnp.logspace``, and no torch or
numpy formula reproduces its float32 rounding (one ulp off moves decoded
moments and some codes).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..tree import leaves, map_leaves, unflatten

__all__ = ["AdamW", "AdamWState", "Q8"]

_BLOCK = 256
_F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    m: object               # tree matching params (float32 or Q8)
    v: object


class Q8(NamedTuple):
    """Block-quantized moment tensor.

    Blocks run along the LAST axis of the parameter: q has shape
    param.shape[:-1] + (ceil(last/256), 256) and scale drops the final 256,
    so every leading axis is the parameter's.
    """

    q: torch.Tensor         # uint8 codes
    scale: torch.Tensor     # float32 per-block absmax scales


# The positive halves of the reference's tables as float32 bit patterns:
# jnp.logspace(-6, 0, 127) (signed) and jnp.logspace(-7, 0, 255)
# (unsigned), in float32.
_POS_SIGNED_BITS = (
    "358637bd 3595c582 35a720a8 35ba7ebf 35d01b58 35e83914 36019120 "
    "361094eb 3621561b 36340864 3648e547 36602d15 367a2788 368b925e "
    "369bbeee 36adcb5d 36c1ef2e 36d86888 36f17c8a 3706bc4c 37165963 "
    "3727c5ac 373b36d5 3750e8d2 37691e5e 37821117 379123ad 37a1f568 "
    "37b4ba19 37c9aba2 37e10a6d 37fb1e99 380c1c2d 381c58c0 382e7703 "
    "3842aeb8 38593e34 38726af9 38874155 3896edd6 38a86b5f 38bbefbc "
    "38d1b71f 38ea0493 39029183 3911b2fb 3922955d 39356c98 394a72d0 "
    "3961e8b0 397c1694 398ca689 399cf31f 39af2339 39c36ef1 39da14b4 "
    "39f35a65 3a07c6e1 3a1782e1 3a2911a4 3a3ca94c 3a528628 3a6aebab "
    "3a831273 3a9242e1 3aa335e4 3ab61fc0 3acb3ab4 3ae2c7be 3afd0f7b "
    "3b0d316e 3b1d8e1c 3b2fd032 3b442fe7 3b5aec0f 3b744aad 3b884cf0 "
    "3b98187a 3ba9b899 3bbd6399 3bd35614 3bebd3a7 3c0393e2 3c12d34b "
    "3c23d710 3c36d399 3c4c0365 3c63a7b4 3c7e0961 3c8dbcdc 3c9e29b3 "
    "3cb07dcd 3cc4f1a4 3cdbc43e 3cf53bea 3d08d38c 3d18aeac 3d2a6032 "
    "3d3e1e9f 3d5426c3 3d6cbc80 3d8415cd 3d936448 3da478d8 3db7881d "
    "3dccccd8 3de48880 3dff043e 3e0e48d1 3e1ec5e0 3e312c13 3e45b41f "
    "3e5c9d40 3e762e11 3e895aa7 3e994572 3eab086f 3ebeda5a 3ed4f841 "
    "3eeda647 3f04983b 3f13f5d3 3f251b42 3f383d5b 3f4d9711 3f656a2b "
    "3f800000")
_POS_UNSIGNED_BITS = (
    "33d6bf95 33e4d145 33f3ced9 3401e3eb 340a6665 34137798 341d20d1 "
    "34276c12 34326405 343e13ed 344a87ca 3457cc80 3465efce 3475003a "
    "3482869d 348b13b5 34943043 349de5a1 34a83dd2 34b34376 34bf0202 "
    "34cb8578 34d8dadc 34e70fd0 34f6331a 35032a1a 350bc1f2 3514e9df "
    "351eab66 35291081 353423ff 353ff133 354c8463 3559ea6b 35683139 "
    "35776768 3583ce64 358c70f6 3595a464 359f7218 35a9e443 35b50594 "
    "35c0e19d 35cd847f 35dafb5d 35e953fd 35f89d4a 36047372 360d20e8 "
    "36165fd3 362039da 362ab90f 3635e85d 3641d334 364e85f9 365c0da6 "
    "366a784f 3679d4b0 36851962 368dd1a3 36971c2d 36a1027f 36ab8ee5 "
    "36b6cc29 36c2c5fa 36cf8897 36dd2146 36eb9ded 36fb0d9c 3705c00e "
    "370e8345 3717d967 3721cc2b 372c65bb 3737b11f 3743b9e2 37508c89 "
    "375e362f 376cc50b 377c47fe 37866795 378f35c6 379897a5 37a296d3 "
    "37ad3db7 37b89734 37c4af18 37d191c0 37df4c94 37eded9b 37fd840e "
    "38070fee 380fe926 381956ba 38236279 382e16a8 38397e69 3845a564 "
    "3852983f 38606434 386f179f 387ec186 3887b91a 38909d5d 389a16ca "
    "38a42f13 38aef0b5 38ba66b2 38c69cf4 38d39ff7 38e17d3b 38f04307 "
    "39000053 3908631a 39115285 391ad7cb 3924fcbe 392fcbd4 393b5032 "
    "394795b9 3954a910 396297b3 39716fff 3980a0a2 39890de9 39920885 "
    "399b99b8 39a5cb5f 39b0a7ff 39bc3ac9 39c88faf 39d5b366 39e3b37b "
    "39f29e5f 3a0141ba 3a09b98f 3a12bf69 3a1c5c9d 3a269b09 3a318544 "
    "3a3d268d 3a498ae5 3a56bf11 3a64d0b0 3a73ce43 3a81e3a0 3a8a6610 "
    "3a937738 3a9d2071 3aa76bb1 3ab26397 3abe1372 3aca8755 3ad7cc0b "
    "3ae5ef49 3af4ffa3 3b028651 3b0b136a 3b142fed 3b1de53f 3b283d65 "
    "3b334308 3b3f0185 3b4b84fb 3b58da4f 3b670f41 3b763279 3b8329c9 "
    "3b8bc197 3b94e989 3b9eab05 3ba9101f 3bb42390 3bbff0c3 3bcc83e5 "
    "3bd9e9ed 3be830ab 3bf766d8 3c03ce13 3c0c70a4 3c15a408 3c1f71bc "
    "3c29e3d8 3c350528 3c40e12a 3c4d840b 3c5afadb 3c69537a 3c789cb5 "
    "3c847328 3c8d208a 3c965f74 3ca0396f 3caab8a3 3cb5e7e4 3cc1d2ba "
    "3cce856e 3cdc0d1f 3cea77b6 3cf9d416 3d05190b 3d0dd14c 3d171bca "
    "3d21021c 3d2b8e79 3d36cbbc 3d42c57f 3d4f881b 3d5d20ba 3d6b9d60 "
    "3d7b0cfd 3d85bfbf 3d8e82eb 3d97d90f 3da1cbc7 3dac6557 3db7b0ae "
    "3dc3b971 3dd08c07 3dde35ad 3decc47c 3dfc476e 3e066744 3e0f356a "
    "3e18973d 3e22966b 3e2d3d41 3e3896bf 3e44ae94 3e51913c 3e5f4c00 "
    "3e6ded07 3e7d8367 3e870f9a 3e8fe8c7 3e99565c 3ea3620e 3eae163c "
    "3eb97df1 3ec5a4ec 3ed297b6 3ee063ab 3eef1705 3efec0ed 3f07b8c3 "
    "3f109d06 3f1a1668 3f242eb1 3f2ef047 3f3a6643 3f469c77 3f539f7a "
    "3f617cb7 3f70427a 3f800000")


def _bits(words: str) -> torch.Tensor:
    return torch.from_numpy(np.array([int(w, 16) for w in words.split()],
                                     np.uint32).view(np.float32))


def _dynamic_table(signed: bool) -> torch.Tensor:
    """bnb-style dynamic 8-bit code: log-spaced magnitudes, so values many
    orders below the block max still quantize to nonzero."""
    if signed:
        pos = _bits(_POS_SIGNED_BITS)
        return torch.cat([-pos.flip(0), torch.zeros(1), pos])
    return torch.cat([torch.zeros(1), _bits(_POS_UNSIGNED_BITS)])


_TABLE_SIGNED = _dynamic_table(True)       # 255 entries
_TABLE_UNSIGNED = _dynamic_table(False)    # 256 entries


_DEVICE_TABLES = {}


def _table(signed: bool, device: torch.device) -> torch.Tensor:
    """The code table on ``device``, copied there once (an update inside a
    captured CUDA graph then makes no host copy)."""
    key = (signed, str(device))
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = (_TABLE_SIGNED if signed
                               else _TABLE_UNSIGNED).to(device)
    return _DEVICE_TABLES[key]


def _q8_shape(shape):
    shape = tuple(shape)
    last = shape[-1] if shape else 1
    nb = -(-last // _BLOCK)
    lead = shape[:-1] if shape else ()
    return lead + (nb, _BLOCK), lead + (nb,)


def _q8_encode(x: torch.Tensor, signed: bool) -> Q8:
    table = _table(signed, x.device)
    qshape, _ = _q8_shape(x.shape)
    last = x.shape[-1] if x.dim() else 1
    pad = qshape[-2] * _BLOCK - last
    xb = x.reshape(tuple(x.shape) or (1,))
    if pad:
        xb = F.pad(xb, (0, pad))
    blocks = xb.reshape(qshape)
    scale = torch.clamp(blocks.abs().amax(dim=-1), min=1e-12)
    y = blocks / scale[..., None]
    # nearest-entry code via midpoint boundaries
    mids = (table[1:] + table[:-1]) * 0.5
    q = torch.searchsorted(mids, y.contiguous(), side="left").to(torch.uint8)
    return Q8(q, scale.to(_F32))


def _q8_decode(s: Q8, shape, signed: bool) -> torch.Tensor:
    table = _table(signed, s.q.device)
    vals = table[s.q.long()] * s.scale[..., None]
    shape = tuple(shape)
    lead = shape[:-1] if shape else ()
    last = shape[-1] if shape else 1
    return vals.reshape(lead + (-1,))[..., :last].reshape(shape)


def _is_q8(x) -> bool:
    return isinstance(x, Q8)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr_fn: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "fp32"      # "fp32" | "int8"

    def init(self, params) -> AdamWState:
        """Zero moments on each parameter's device; the step a 0-d int32 on
        the first parameter's."""
        if self.state_dtype == "int8":
            def zero(code):
                def make(p):
                    qs, ss = _q8_shape(p.shape)
                    return Q8(torch.full(qs, code, dtype=torch.uint8,
                                         device=p.device),
                              torch.full(ss, 1e-12, dtype=_F32,
                                         device=p.device))
                return make
            # code 127 = 0.0 in the signed table, code 0 in the unsigned
            m = map_leaves(zero(127), params)
            v = map_leaves(zero(0), params)
        else:
            def zero_f(p):
                return torch.zeros(p.shape, dtype=_F32, device=p.device)
            m = map_leaves(zero_f, params)
            v = map_leaves(zero_f, params)
        first = leaves(params)
        device = first[0].device if first else None
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          m, v)

    def update(self, grads, state: AdamWState, params):
        step = state.step + 1
        lr = self.lr_fn(step)
        b1, b2 = self.b1, self.b2
        stepf = step.to(_F32)
        c1 = 1 - torch.pow(b1, stepf)       # float32: b1 enters as float32
        c2 = 1 - torch.pow(b2, stepf)
        q8 = self.state_dtype == "int8"

        def upd(p, g, m, v):
            g = g.to(_F32)
            mf = _q8_decode(m, p.shape, signed=True) if q8 else m
            vf = _q8_decode(v, p.shape, signed=False) if q8 else v
            mf = b1 * mf + (1 - b1) * g
            vf = b2 * vf + (1 - b2) * torch.square(g)
            mhat = mf / c1
            vhat = vf / c2
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            if p.dim() >= 2:  # decay matrices only, standard practice
                delta = delta + self.weight_decay * p.to(_F32)
            new_p = (p.to(_F32) - lr * delta).to(p.dtype)
            if q8:
                return (new_p, _q8_encode(mf, signed=True),
                        _q8_encode(vf, signed=False))
            return new_p, mf, vf

        out = [upd(p, g, m, v) for p, g, m, v in zip(
            leaves(params), leaves(grads), leaves(state.m, _is_q8),
            leaves(state.v, _is_q8))]
        new_p = unflatten(params, [o[0] for o in out])
        new_m = unflatten(params, [o[1] for o in out])
        new_v = unflatten(params, [o[2] for o in out])
        return new_p, AdamWState(step, new_m, new_v)
