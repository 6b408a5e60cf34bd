"""Model config of the port: its own copy of ``repro.configs.base``.

Only what the serving path of the dense decoder reads is kept: the
``ModelConfig`` fields, ``resolved_head_dim``, ``padded_vocab`` and
``smoke_variant``.  The fields and defaults are those of the reference, so
a config built here equals the reference's field for field (the CPU tests
check it).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Literal


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["decoder", "encdec", "xlstm", "hybrid", "moe", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None      # default d_model // n_heads
    act: str = "silu"                # "silu"(swiglu) | "geglu" | "gelu"(plain)
    qkv_bias: bool = False           # qwen-style attention bias
    norm: str = "rmsnorm"            # "rmsnorm" | "layernorm"
    pos_embed: str = "rope"          # "rope" | "learned" | "none"
    norm_eps: float = 1e-6
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    sliding_window: int | None = None
    # fields of the reference that select parts the port does not have yet;
    # kept so that the model can refuse them
    frontend: Literal[None, "patch_embed", "audio_frames"] = None
    first_k_dense: int = 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows, rounded up to 256 as in the reference (the
        pad logits are masked to -1e9 in ``unembed_apply``)."""
        return -(-self.vocab_size // 256) * 256


def smoke_variant(cfg: ModelConfig, **over) -> ModelConfig:
    """Reduced same-family config: tiny dims, same structural features."""
    kw = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, min(4, cfg.n_kv_heads * 4 // max(cfg.n_heads, 1)) or 1),
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=64 if cfg.head_dim else None,
        first_k_dense=min(cfg.first_k_dense, 1),
    )
    kw.update(over)
    return replace(cfg, name=cfg.name + "-smoke", **kw)
