"""Plain reference of a configuration's forward pass and of the operand
rows each layer streams.

A configuration file names its layer stack (``layers``: conv, flatten and
linear entries, each with its parameter names, activation and pooling) and
the directory of its trained weights; this module reads the weights with
numpy, runs the stack in float64 (or, for the control, in float32 with each
matrix product's operands rounded to TF32) and lays out each conv or
linear layer's (inputs, weights) rows: one row a neuron, conv patches in
(Cin, kh, kw) order against the kernel reshaped in (kh, kw, Cin) order,
neurons channel-major. Nothing here imports the program.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Layer = Tuple[torch.Tensor, torch.Tensor]


def load_weights(root: str, rel: str) -> Dict[str, np.ndarray]:
    """The newest ``step_*`` checkpoint under ``root/rel``: every array
    under ``params/`` by name (float32, the stored layouts: conv HWIO,
    linear (in, out))."""
    path = os.path.join(root, rel)
    steps = sorted(d for d in os.listdir(path) if d.startswith("step_"))
    path = os.path.join(path, steps[-1])
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for host in range(manifest["num_hosts"]):
        with np.load(os.path.join(path, f"host{host:04d}.npz")) as z:
            for k in z.files:
                if k.startswith("params/"):
                    out[k[len("params/"):]] = np.asarray(z[k], np.float32)
    return out


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away
    from zero): what a TF32 matrix unit reads of each operand."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


_ACT = {"tanh": torch.tanh, "leaky_relu_0.1": lambda x: F.leaky_relu(x, 0.1),
        None: lambda x: x}


def forward_traffic(config: dict, weights: Dict[str, np.ndarray],
                    image: torch.Tensor, mode: str = "float64"
                    ) -> List[Layer]:
    """Per-layer (inputs, weights) operand rows of one image (H, W, C).

    ``mode``: ``float64`` (the reference: activations in float64, the
    operand rows returned in float64 inputs and float32 weights) or
    ``tf32`` (the control: float32, each conv and matmul on TF32-rounded
    operands with float32 accumulation)."""
    dev = image.device
    dt = torch.float64 if mode == "float64" else torch.float32
    rnd = tf32 if mode == "tf32" else (lambda t: t)
    x = image.to(dt).permute(2, 0, 1)[None]                # NCHW
    out: List[Layer] = []
    for spec in config["layers"]:
        kind = spec["kind"]
        if kind == "flatten":
            x = x.permute(0, 2, 3, 1).reshape(1, -1)           # HWC order
            continue
        w32 = torch.as_tensor(weights[spec["w"]], device=dev)
        b = torch.as_tensor(weights[spec["b"]], device=dev).to(dt)
        w = w32.to(dt)
        if kind == "conv":
            kh, kw, cin, cout = w32.shape
            patches = F.unfold(x, (kh, kw))[0].T               # (npos, k)
            npos, k = patches.shape
            wcol = w32.reshape(k, cout).T                      # (cout, k)
            out.append((patches.repeat(cout, 1),
                        wcol.repeat_interleave(npos, dim=0)))
            y = F.conv2d(rnd(x), rnd(w.permute(3, 2, 0, 1).contiguous()), b)
        elif kind == "linear":
            out.append((x[0][None, :].expand(w32.shape[1], -1),
                        w32.T))
            y = rnd(x) @ rnd(w) + b
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
        y = _ACT[spec.get("act")](y)
        if spec.get("pool"):
            y = F.max_pool2d(y, spec["pool"])
        x = y
    return out


def forward_error(got: List[Layer], want: List[Layer]) -> float:
    """The largest gap of any operand, over its layer's largest reference
    magnitude, across layers; weights must match exactly (an infinite
    error otherwise), as must every layer's shape."""
    if len(got) != len(want):
        return float("inf")
    worst = 0.0
    for (gi, gw), (wi, ww) in zip(got, want):
        if gi.shape != wi.shape or gw.shape != ww.shape:
            return float("inf")
        if not torch.equal(gw.to(ww.device, torch.float32), ww):
            return float("inf")
        ref = wi.to(torch.float64)
        scale = float(ref.abs().max()) or 1.0
        gap = float((gi.to(ref.device, torch.float64) - ref).abs().max())
        worst = max(worst, gap / scale)
    return worst
