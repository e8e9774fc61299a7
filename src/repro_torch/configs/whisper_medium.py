"""whisper-medium [audio]: enc-dec, 24+24L d1024 16H (kv=16) ff4096 vocab=51865.

Conv frontend is a STUB: callers pass precomputed frame embeddings
(B, S, 1024) [arXiv:2212.04356]. GELU MLP, learned positions, full (not
causal) encoder attention, causal decoder with cross-attention.
"""
from ..dist.sharding import DEFAULT_RULES
from ..models import EncDecConfig
from .common import ArchDef

_CFG = EncDecConfig("whisper-medium", n_layers=24, d_model=1024, n_heads=16,
                    n_kv=16, d_ff=4096, vocab=51865)
_REDUCED = EncDecConfig("whisper-medium-reduced", n_layers=2, d_model=128,
                        n_heads=4, n_kv=4, d_ff=256, vocab=512)

ARCH = ArchDef(name="whisper-medium", kind="encdec", config=_CFG,
               rules=dict(DEFAULT_RULES), reduced_config=_REDUCED,
               notes="enc-dec; audio frontend stubbed as frame embeddings")
