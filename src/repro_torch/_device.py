"""Device resolution for the port's entry points.

Every entry point takes ``device=None`` and runs on CUDA unless the caller
asks for the CPU. With no device given and no CUDA card present the call
fails loudly: the port never carries on quietly on the CPU, so a number
measured through an entry point is always a number from the card.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "DeviceLike"]

DeviceLike = Optional[Union[str, torch.device]]


def _full_fp32() -> None:
    """Keep float32 convolutions and matmuls in full float32 on the card.

    cuDNN runs float32 convolutions in TF32 by default (about three decimal
    digits); the LeNet forward must match the reference to 1e-5, so TF32 is
    switched off for both cuDNN and cuBLAS.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raising when no card is present); anything else
    is taken as given. CUDA devices also switch TF32 off."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch entry points run on a CUDA device by default and "
                "none is available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        _full_fp32()
    return dev
