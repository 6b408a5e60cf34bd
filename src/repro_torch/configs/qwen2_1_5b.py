"""Qwen2-1.5B — dense decoder, GQA + QKV bias [arXiv:2407.10671; hf].

28L, d_model 1536, 12 heads (GQA kv=2), d_ff 8960, vocab 151936.
"""

from .base import ModelConfig, smoke_variant

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="decoder",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
)

SMOKE = smoke_variant(CONFIG, n_kv_heads=2)
