"""xlstm-125m [ssm]: 12L d768 4H ff0 vocab 50304 - alternating
sLSTM/mLSTM blocks [arXiv:2405.04517]. d_ff=0: blocks carry their own
projections, no separate MLP. Recurrent state is O(1) in context ->
long_500k runs.
"""
from .common import lm_arch

ARCH = lm_arch(
    "xlstm-125m",
    n_layers=12, d_model=768, n_heads=4, n_kv=4, d_ff=0, vocab=50304,
    pattern=("mlstm", "slstm"), tied_embeddings=True,
    reduced_overrides={"n_layers": 4},
)
