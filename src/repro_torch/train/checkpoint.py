"""Fault-tolerant checkpointing: atomic, manifest-driven (the port of
``repro.train.checkpoint``, in its on-disk format).

Layout of one checkpoint:
    <dir>/step_000000123.tmp/...   (written first)
    <dir>/step_000000123/          (atomic rename once complete)
        manifest.json              step, leaf keys, shapes/dtypes, host count
        host0000.npz               flat leaf arrays owned by this host

Leaf keys are the reference's (``tree.leaves_with_path``: ``.params/b/w``,
``.opt/.step``, ``.opt/.m/b/w/.q``). bf16 leaves are stored as raw 2-byte
void (``|V2``), as numpy stores the reference's bfloat16 arrays, and the
manifest records ``bfloat16``: a checkpoint written by either package
restores in the other (ROADMAP C23).

Restore picks the newest directory whose manifest is complete and whose
arrays all load - a torn write (killed mid-save) is skipped - and rebuilds
the tree on the devices of ``tree_like``'s leaves.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..tree import leaves_with_path, unflatten

__all__ = ["save", "restore", "latest_step"]

_STEP_RE = re.compile(r"^step_(\d{9})$")


def _to_numpy(x: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor as the array the reference would save, and its dtype name."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
    a = x.numpy()
    return a, str(a.dtype)


def _flatten(tree) -> Tuple[dict, dict]:
    """({key: array}, {key: dtype name}) of every leaf."""
    flat, dtypes = {}, {}
    for key, leaf in leaves_with_path(tree):
        flat[key], dtypes[key] = _to_numpy(torch.as_tensor(leaf))
    return flat, dtypes


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3,
         host_id: int = 0, num_hosts: int = 1) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:09d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat, dtypes = _flatten(tree)
    np.savez(os.path.join(tmp, f"host{host_id:04d}.npz"), **flat)
    manifest = {
        "step": step,
        "num_hosts": num_hosts,
        "keys": sorted(flat.keys()),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": dtypes,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(tmp)
    else:
        os.replace(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if _STEP_RE.match(d))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := _STEP_RE.match(d))]
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if arr.dtype.kind == "V":
        # raw void: bf16 is the one such dtype the manifest may name
        if dtype_name != "bfloat16":
            raise ValueError(f"cannot restore a {dtype_name} leaf")
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _try_load(path: str) -> Optional[dict]:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        data = {}
        for host in range(manifest["num_hosts"]):
            with np.load(os.path.join(path, f"host{host:04d}.npz")) as z:
                for k in z.files:
                    data[k] = _tensor(z[k], manifest["dtypes"][k])
        if sorted(data.keys()) != manifest["keys"]:
            return None
        return {"step": manifest["step"], "data": data}
    except Exception:
        return None


def restore(ckpt_dir: str, tree_like) -> Optional[Tuple[int, Any]]:
    """Load the newest intact checkpoint into the structure of ``tree_like``,
    each leaf in its ``tree_like`` leaf's dtype and on its device.

    Returns (step, tree) or None. Corrupt/torn checkpoints are skipped in
    favor of the next-newest intact one (crash consistency).
    """
    if not os.path.isdir(ckpt_dir):
        return None
    candidates = sorted((d for d in os.listdir(ckpt_dir) if _STEP_RE.match(d)),
                        reverse=True)
    paths = leaves_with_path(tree_like)
    for cand in candidates:
        loaded = _try_load(os.path.join(ckpt_dir, cand))
        if loaded is None:
            continue
        if sorted(k for k, _ in paths) != sorted(loaded["data"].keys()):
            continue
        new_leaves = []
        for key, ref in paths:
            arr = loaded["data"][key]
            ref = torch.as_tensor(ref)
            new_leaves.append(arr.to(device=ref.device, dtype=ref.dtype))
        return loaded["step"], unflatten(tree_like, new_leaves)
    return None
