"""LeNet as a PyTorch module - the paper's evaluated DNN workload.

The port of ``repro.models.convnets.LeNet``. Public methods keep the JAX
layouts so the tests compare like with like: activations are NHWC (one
image is (H, W, C)), conv weights HWIO, linear weights (in, out), and the
parameter names are the reference's (``c1w``, ``c1b``, ... ``f3b``).
Convolutions and matrix products go to ``F.conv2d`` / ``torch.matmul`` in
full float32 (TF32 is off on the card, see ``_device``).

``layer_traffic`` turns one inference into the (input, weight) operand
streams the NoC injects; ``weight_stream`` is the no-NoC (Tab. I) stream.
``DarkNetLike`` arrives with a later slice (ROADMAP queue A, item 4).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..noc.traffic import (LayerTraffic, conv_layer_traffic,
                           linear_layer_traffic)

__all__ = ["LeNet", "params_from_jax", "load_checkpoint", "Checkpoint",
           "LENET_SHAPES"]

LENET_SHAPES = {
    "c1w": (5, 5, 1, 6), "c1b": (6,),
    "c2w": (5, 5, 6, 16), "c2b": (16,),
    "f1w": (400, 120), "f1b": (120,),
    "f2w": (120, 84), "f2b": (84,),
    "f3w": (84, 10), "f3b": (10,),
}


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
    """k x k max pool, stride k, VALID, on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)


class LeNet(nn.Module):
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
        dev = resolve_device(device)
        for name, shape in LENET_SHAPES.items():
            t = params[name].to(device=dev, dtype=torch.float32)
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
            setattr(self, name, nn.Parameter(t.clone(), requires_grad=False))

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
