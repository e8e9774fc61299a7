"""LeNet and the DarkNet-like CNN as PyTorch modules - the paper's two
evaluated DNN workloads.

The port of ``repro.models.convnets``. Public methods keep the JAX layouts
so the tests compare like with like: activations are NHWC (one image is
(H, W, C)), conv weights HWIO, linear weights (in, out), and the parameter
names are the reference's (``c1w`` ... ``f3b``; ``c0w`` ... ``fb``), their
shapes given by each model's ``specs()``. Convolutions and matrix products
go to ``F.conv2d`` / ``torch.matmul`` in full float32 (TF32 is off on the
card, see ``_device``).

``layer_traffic`` turns one inference into the (input, weight) operand
streams the NoC injects; LeNet's ``weight_stream`` is the no-NoC (Tab. I)
stream (the reference's DarkNet has none). :func:`trained_model` loads
either model with the trained weights the repository carries.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..noc.traffic import (LayerTraffic, conv_layer_traffic,
                           linear_layer_traffic)
from .spec import ParamSpec

__all__ = ["LeNet", "DarkNetLike", "params_from_jax", "load_checkpoint",
           "Checkpoint", "TrainedModel", "trained_model"]

# The trained checkpoints the repository carries, one directory a model.
WEIGHTS = Path(__file__).resolve().parents[3] / "experiments" / "weights"
_F32 = torch.float32
_CONV_AXES = (None, None, "conv_in", "conv_out")


def params_from_jax(np_params: Dict[str, np.ndarray],
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Reference parameters (a dict of numpy arrays, JAX layouts) ->
    float32 tensors on ``device``, same names and layouts."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=dev)
            for k, v in np_params.items()}


class Checkpoint(NamedTuple):
    step: int
    params: Dict[str, torch.Tensor]
    acc: Optional[float]


def load_checkpoint(path: str, device: DeviceLike = None) -> Checkpoint:
    """Read a reference checkpoint (``manifest.json`` + ``hostNNNN.npz``,
    the ``repro.train.checkpoint`` layout) with numpy alone.

    ``path`` is one ``step_NNNNNNNNN`` directory, or the directory holding
    them (the newest is read). Leaves under ``params/`` become the
    parameter dict; a scalar ``acc`` leaf, when present, is returned too.
    """
    if not os.path.exists(os.path.join(path, "manifest.json")):
        steps = sorted(d for d in os.listdir(path) if d.startswith("step_")
                       and os.path.exists(os.path.join(path, d,
                                                       "manifest.json")))
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {path}")
        path = os.path.join(path, steps[-1])
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = {}
    for host in range(manifest["num_hosts"]):
        with np.load(os.path.join(path, f"host{host:04d}.npz")) as z:
            for k in z.files:
                data[k] = z[k]
    if sorted(data) != sorted(manifest["keys"]):
        raise ValueError(f"checkpoint {path} is incomplete: arrays "
                         f"{sorted(data)} != manifest {manifest['keys']}")
    params = {k[len("params/"):]: v for k, v in data.items()
              if k.startswith("params/")}
    acc = float(data["acc"]) if "acc" in data else None
    return Checkpoint(int(manifest["step"]), params_from_jax(params, device),
                      acc)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """VALID conv on NHWC with an HWIO kernel -> NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b)
    return y.permute(0, 2, 3, 1)


def _pool(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """k x k max pool, stride k, VALID (an odd edge dropped), on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)


def _set_params(module: nn.Module, params: Dict[str, torch.Tensor],
                device: DeviceLike):
    """Register ``params`` on ``module`` as frozen parameters, each checked
    against its spec's shape."""
    dev = resolve_device(device)
    for name, spec in module.specs().items():
        t = params[name].to(device=dev, dtype=spec.dtype)
        if tuple(t.shape) != spec.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{spec.shape}")
        setattr(module, name, nn.Parameter(t.clone(), requires_grad=False))


def _xent(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of ``-log_softmax(logits)[y]``."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, y.long()[:, None]).mean()


class _Classifier(nn.Module):
    """What LeNet and DarkNet share: the reference's loss, and its
    gradients by autograd."""

    def loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The reference's ``loss``: the batch mean of
        ``-log_softmax(logits)[y]``."""
        return _xent(self(x), y)

    def grads(self, x: torch.Tensor,
              y: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The loss's gradient with respect to every parameter, by name
        (``torch.func.grad`` over the module's own parameters)."""
        params = {n: p.detach() for n, p in self.named_parameters()}
        return torch.func.grad(lambda p: _xent(
            torch.func.functional_call(self, p, (x,)), y))(params)


class LeNet(_Classifier):
    """Classic LeNet-5: 32x32x1 -> conv6@5 -> pool -> conv16@5 -> pool
    -> fc120 -> fc84 -> fc10 (tanh), ~61.7k parameters.

    ``params``: a dict of tensors in the reference layouts, for example
    from :func:`params_from_jax` or :func:`load_checkpoint`.
    """

    input_shape = (32, 32, 1)
    n_classes = 10

    def __init__(self, params: Dict[str, torch.Tensor],
                 device: DeviceLike = None):
        super().__init__()
        _set_params(self, params, device)

    @staticmethod
    def specs() -> Dict[str, ParamSpec]:
        lin = ("mlp", "embed")
        return {
            "c1w": ParamSpec((5, 5, 1, 6), _CONV_AXES, dtype=_F32),
            "c1b": ParamSpec((6,), ("conv_out",), init="zeros", dtype=_F32),
            "c2w": ParamSpec((5, 5, 6, 16), _CONV_AXES, dtype=_F32),
            "c2b": ParamSpec((16,), ("conv_out",), init="zeros", dtype=_F32),
            "f1w": ParamSpec((400, 120), lin, dtype=_F32),
            "f1b": ParamSpec((120,), ("embed",), init="zeros", dtype=_F32),
            "f2w": ParamSpec((120, 84), lin, dtype=_F32),
            "f2b": ParamSpec((84,), ("embed",), init="zeros", dtype=_F32),
            "f3w": ParamSpec((84, 10), lin, dtype=_F32),
            "f3b": ParamSpec((10,), ("embed",), init="zeros", dtype=_F32),
        }

    def _trunk(self, x: torch.Tensor):
        """NHWC batch -> the per-layer input activations of every image."""
        h1 = _pool(torch.tanh(_conv(x, self.c1w, self.c1b)))
        h2 = _pool(torch.tanh(_conv(h1, self.c2w, self.c2b)))
        flat = h2.reshape(h2.shape[0], -1)          # HWC order, like JAX
        a3 = torch.tanh(flat @ self.f1w + self.f1b)
        a4 = torch.tanh(a3 @ self.f2w + self.f2b)
        return h1, flat, a3, a4

    def activations(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Per-layer INPUT activations for one image (H, W, C)."""
        h1, flat, a3, a4 = self._trunk(x[None])
        return [x, h1[0], flat[0], a3[0], a4[0]]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Batched forward: x (B, 32, 32, 1) -> logits (B, 10)."""
        _, _, _, a4 = self._trunk(x)
        return a4 @ self.f3w + self.f3b

    def layer_traffic(self, x: torch.Tensor) -> List[LayerTraffic]:
        """The operand streams one inference (image (H, W, C)) injects."""
        a = self.activations(x)
        return [
            conv_layer_traffic(a[0], self.c1w),
            conv_layer_traffic(a[1], self.c2w),
            linear_layer_traffic(a[2], self.f1w.T),
            linear_layer_traffic(a[3], self.f2w.T),
            linear_layer_traffic(a[4], self.f3w.T),
        ]

    def weight_stream(self) -> torch.Tensor:
        """All weights as one flat stream, kernels zero-padded to flit-lane
        multiples (the paper's Sec. V-A protocol for the no-NoC study)."""
        ker1 = self.c1w.permute(3, 0, 1, 2).reshape(6, 25)
        ker2 = self.c2w.permute(3, 2, 0, 1).reshape(96, 25)
        parts = [
            F.pad(ker1, (0, 7)).reshape(-1),
            F.pad(ker2, (0, 7)).reshape(-1),
            self.f1w.T.reshape(-1),
            self.f2w.T.reshape(-1),
            F.pad(self.f3w.T, (0, 4)).reshape(-1),
        ]
        return torch.cat(parts).detach()


class DarkNetLike(_Classifier):
    """DarkNet-reference-style CNN on 64x64x3 (the paper's Sec. V-B input,
    reduced 'to speed up the simulation'): 3x3 VALID convs doubling the
    channels (16, 32, 64, 128), each followed by leaky-ReLU 0.1 and a 2x2
    max pool (spatial 62 -> 31, 29 -> 14, 12 -> 6, 4 -> 2), then a linear
    head on the 512 features, flattened in NHWC order.

    ``params``: reference-layout tensors (``c0w`` ... ``c3b``, ``fw``,
    ``fb``).
    """

    input_shape = (64, 64, 3)
    channels = (16, 32, 64, 128)
    n_classes = 10
    head_dim = 2 * 2 * 128              # the last block's (2, 2, 128) output

    def __init__(self, params: Dict[str, torch.Tensor],
                 device: DeviceLike = None):
        super().__init__()
        _set_params(self, params, device)

    @classmethod
    def specs(cls) -> Dict[str, ParamSpec]:
        s = {}
        cin = cls.input_shape[-1]
        for i, cout in enumerate(cls.channels):
            s[f"c{i}w"] = ParamSpec((3, 3, cin, cout), _CONV_AXES,
                                    dtype=_F32)
            s[f"c{i}b"] = ParamSpec((cout,), ("conv_out",), init="zeros",
                                    dtype=_F32)
            cin = cout
        s["fw"] = ParamSpec((cls.head_dim, cls.n_classes), ("mlp", "embed"),
                            dtype=_F32)
        s["fb"] = ParamSpec((cls.n_classes,), ("embed",), init="zeros",
                            dtype=_F32)
        return s

    def _trunk(self, x: torch.Tensor) -> List[torch.Tensor]:
        """NHWC batch -> each conv block's pooled output, NHWC."""
        out = []
        for i in range(len(self.channels)):
            x = _pool(F.leaky_relu(_conv(x, getattr(self, f"c{i}w"),
                                         getattr(self, f"c{i}b")), 0.1))
            out.append(x)
        return out

    def activations(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Per-layer INPUT activations for one image (H, W, C): the image,
        the first three blocks' outputs (H, W, C), the last one's flattened
        in HWC order."""
        hs = self._trunk(x[None])
        return [x, *(h[0] for h in hs[:-1]), hs[-1][0].reshape(-1)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Batched forward: x (B, 64, 64, 3) -> logits (B, 10)."""
        h = self._trunk(x)[-1]
        return h.reshape(h.shape[0], -1) @ self.fw + self.fb

    def layer_traffic(self, x: torch.Tensor) -> List[LayerTraffic]:
        """The operand streams one inference (image (H, W, C)) injects: one
        a conv (27, 144, 288 and 576 values a packet), then the head's
        (512)."""
        a = self.activations(x)
        return [*(conv_layer_traffic(a[i], getattr(self, f"c{i}w"))
                  for i in range(len(self.channels))),
                linear_layer_traffic(a[-1], self.fw.T)]


_MODELS = {"lenet": LeNet, "darknet": DarkNetLike}


class TrainedModel(NamedTuple):
    model: nn.Module
    params: Dict[str, torch.Tensor]
    input_shape: Tuple[int, int, int]


def trained_model(name: str, device: DeviceLike = None) -> TrainedModel:
    """``"lenet"`` or ``"darknet"`` with the trained weights under
    ``experiments/weights/<name>`` (the newest step): the module, its
    checkpoint parameters and its input shape (H, W, C)."""
    if name not in _MODELS:
        raise ValueError(f"unknown model {name!r}; known: {sorted(_MODELS)}")
    ck = load_checkpoint(str(WEIGHTS / name), device)
    cls = _MODELS[name]
    return TrainedModel(cls(ck.params, device), ck.params, cls.input_shape)
