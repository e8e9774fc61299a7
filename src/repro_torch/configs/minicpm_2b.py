"""minicpm-2b [dense]: 40L d2304 36H (kv=36, full MHA) ff5760 vocab=122753.

WSD schedule, llama-like, tied embeddings [arXiv:2404.06395; hf]. 36 heads
do not divide the 16-way model axis, so TP lands on mlp/vocab and the heads
stay replicated (the sharding rules' divisibility fallback).
"""
from .common import lm_arch

ARCH = lm_arch(
    "minicpm-2b",
    n_layers=40, d_model=2304, n_heads=36, n_kv=36, d_ff=5760, vocab=122753,
    tied_embeddings=True,
    notes="WSD schedule (repro.optim.schedules.wsd); llama-like dense",
)
