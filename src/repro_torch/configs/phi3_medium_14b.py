"""phi3-medium-14b [dense]: 40L d5120 40H (GQA kv=10) ff17920 vocab=100352.

RoPE + SwiGLU + GQA [arXiv:2404.14219]. kv=10 not divisible by 16 ->
kv replicated, q-heads 40 also not divisible -> head_dim (128) carries TP
for attention; mlp/vocab shard over model.
"""
from .common import lm_arch

ARCH = lm_arch(
    "phi3-medium-14b",
    n_layers=40, d_model=5120, n_heads=40, n_kv=10, d_ff=17920, vocab=100352,
    tied_embeddings=False,
    rules_overrides={"head_dim": "model"},
)
