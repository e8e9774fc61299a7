"""recurrentgemma-9b [hybrid]: 38L d4096 16H (MQA kv=1) ff12288 vocab 256000.

RG-LRU + local attention at 1:2 ratio [arXiv:2402.19427]: pattern
(rec, rec, attn) x 12 groups + 2 tail recurrent blocks = 38. Local window
2048 + O(1) recurrent state -> long_500k runs. The RG-LRU time axis is NOT
order-invariant (DESIGN.md SSArch-applicability).
"""
from .common import lm_arch

ARCH = lm_arch(
    "recurrentgemma-9b",
    n_layers=38, d_model=4096, n_heads=16, n_kv=1, d_ff=12288, vocab=256000,
    pattern=("rec", "rec", "attn"), window=2048, tied_embeddings=True,
    reduced_overrides={"n_layers": 8},
)
