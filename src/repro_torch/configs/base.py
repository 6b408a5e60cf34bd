"""Model config of the port: its own copy of ``repro.configs.base``.

What the dense decoder's serving and training paths read is kept: the
``ModelConfig`` fields, ``resolved_head_dim``, ``padded_vocab``,
``smoke_variant`` and ``TrainConfig``.  The fields and defaults are those of
the reference, so a config built here equals the reference's field for
field (the CPU tests check it).
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



@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    seed: int = 0
    microbatches: int = 1            # gradient accumulation splits
    param_dtype: str = "float32"     # master copy
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    grad_accum_dtype: str = "float32"  # microbatch accumulator (bf16 at 100B+)
    remat: str = "full"              # "none" | "full" | "dots"
    fsdp: bool = False               # shard params/opt over the data axis
    # --- the paper's technique, first-class ---
    sync_algorithm: str = "auto"     # auto|psum|ring|rd|bt|wrht|hier_faithful|
                                     # hier_scatter|planned|planned_sharded|
                                     # planned_pipelined|planned_compressed|
                                     # planned_sharded_compressed
    # planned_pipelined only: buckets in flight between their RS and AG
    # phases — bucket k+1's reduce-scatter is issued before bucket k's
    # all-gather so the two ride one composed ring schedule (DESIGN.md §13)
    pipeline_depth: int = 2
    # wire dtype for explicit gradient sync: f32 default (the XLA *CPU*
    # backend aborts on some bf16 collectives — see EXPERIMENTS §Perf-10);
    # set "bfloat16" on TPU for 2x fewer wire bytes
    sync_dtype: str = "float32"
    sync_m: int = 17                 # WRHT branching (2w+1 analogue)
    bucket_bytes: int = 32 * 2**20
    compress_pod_axis: bool = False  # int8+EF on the pod axis
    # planned_compressed / planned_sharded_compressed only: the per-bucket
    # wire-width sweep the planner runs at setup (DESIGN.md §15).  Each
    # bucket independently picks the cheapest width — small latency-bound
    # buckets decline compression (stay 32) because the quantize/dequant
    # overhead exceeds the β saving; the chosen widths are then frozen for
    # the run so an online re-plan never retraces.
    compress_bits: tuple[int, ...] = (32, 8, 4)
    compress_block: int = 1024       # per-block scale granularity (EF quant)
    compress_fused_kernel: bool = False  # fused CUDA quantize+bucketize (csrc/quant.cu)


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
