"""Zamba2-2.7B — Mamba2 backbone + shared attention block [arXiv:2411.15242; hf].

54 Mamba2 layers, d_model 2560, ssm_state 64; a SHARED full transformer block
(32 heads, d_ff 10240) is interleaved every 6 Mamba2 layers (same weights at
every insertion — Zamba's parameter-sharing trick).  vocab 32000.  The
shared attention runs with a sliding window of 4096.
"""

from .base import ModelConfig, SSMConfig, smoke_variant

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4),
    attn_every=6,
    subquadratic=True,
    sliding_window=4096,
)

SMOKE = smoke_variant(CONFIG)
