"""mixtral-8x7b [moe]: 32L d4096 32H (GQA kv=8) ff14336, 8 experts top-2,
SWA window 4096 [arXiv:2401.04088; hf].

8 experts < 16-way model axis -> experts replicate and TP shards the expert
ff dim instead (14336/16 = 896), the standard small-expert-count layout.
"""
from .common import lm_arch

ARCH = lm_arch(
    "mixtral-8x7b",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336, vocab=32000,
    n_experts=8, top_k=2, window=4096, tied_embeddings=False,
    rules_overrides={"experts": None},
)
