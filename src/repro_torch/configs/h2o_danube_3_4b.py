"""h2o-danube-3-4b [dense]: 24L d3840 32H (GQA kv=8) ff10240 vocab=32000.

llama+mistral mix with sliding-window attention [arXiv:2401.16818].
SWA (window 4096) bounds the KV cache -> long_500k runs for this arch.
"""
from .common import lm_arch

ARCH = lm_arch(
    "h2o-danube-3-4b",
    n_layers=24, d_model=3840, n_heads=32, n_kv=8, d_ff=10240, vocab=32000,
    window=4096, tied_embeddings=False,
)
