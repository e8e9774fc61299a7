"""starcoder2-15b [dense]: 40L d6144 48H (GQA kv=4) ff24576 vocab=49152.

GQA + RoPE, ungated (GELU) MLP [arXiv:2402.19173; hf]. 48 heads / 16 = 3.
"""
from .common import lm_arch

ARCH = lm_arch(
    "starcoder2-15b",
    n_layers=40, d_model=6144, n_heads=48, n_kv=4, d_ff=24576, vocab=49152,
    gated_mlp=False, tied_embeddings=False,
)
