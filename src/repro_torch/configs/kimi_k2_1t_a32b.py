"""kimi-k2-1t-a32b [moe]: 61L d7168 64H (GQA kv=8) expert-ff 2048,
384 experts top-8, vocab 163840 - trillion-parameter MoE (paper-table)
[arXiv:2501.kimi2].

The reference's sharding plan: experts shard over 'model', every other
large dim FSDP-shards over 'data' via the 'embed'->data rule (ZeRO-3
style), and optimizer moments are block-wise int8. The port runs only the
reduced config of this arch (2.06 TB of bf16 parameters fit no one card).
"""
from .common import lm_arch

ARCH = lm_arch(
    "kimi-k2-1t-a32b",
    n_layers=61, d_model=7168, n_heads=64, n_kv=8, d_ff=2048, vocab=163840,
    n_experts=384, top_k=8, tied_embeddings=False, capacity_factor=1.0,
    rules_overrides={"embed": "data", "mlp": None, "kv_heads": None,
                     "head_dim": None},
    optimizer_state="int8",
    notes="1T MoE; EP over model axis, FSDP over data axis, int8 Adam moments",
)
