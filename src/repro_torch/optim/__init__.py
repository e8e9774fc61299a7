"""Optimizer: AdamW with optional int8 moments, global-norm clipping and LR
schedules (the port of ``repro.optim``)."""
from .adamw import AdamW, AdamWState, Q8
from .clip import clip_by_global_norm, global_norm
from .schedules import constant, cosine, wsd

__all__ = ["AdamW", "AdamWState", "Q8", "wsd", "cosine", "constant",
           "clip_by_global_norm", "global_norm"]
