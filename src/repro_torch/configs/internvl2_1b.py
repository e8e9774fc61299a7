"""internvl2-1b [vlm]: 24L d896 14H (GQA kv=2) ff4864 vocab=151655.

InternViT + InternLM2 backbone [arXiv:2404.16821; hf]. The ViT frontend is
a STUB: callers supply 256 precomputed patch embeddings which the
backbone projects and prepends. 14 heads/d896 are too narrow for 16-way TP
-> only mlp (4864) and vocab shard; everything else replicates (a 1B model
needs no more).
"""
from .common import lm_arch

ARCH = lm_arch(
    "internvl2-1b",
    n_layers=24, d_model=896, n_heads=14, n_kv=2, d_ff=4864, vocab=151655,
    vlm_prefix=256, tied_embeddings=True,
)
