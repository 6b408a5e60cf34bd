"""Dense decoder-only transformer: the port of ``repro/models/transformer.py``
for dense decoders (qwen2-1.5b).

The reference stacks the layers' params with a leading [L] axis and runs a
``lax.scan``; here ``params["layers"]`` is a list of per-layer dicts and the
forward pass is a Python loop.  ``remat="full"`` recomputes each layer in
the backward pass (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` of the scan body).  The KV cache keeps the reference's
[L, B, Smax, K, hd] layout and is updated in place.  MoE, MLA,
``first_k_dense`` and frontend stubs are not ported yet and are refused.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from . import layers as L


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a config that needs a part of the reference the port lacks."""
    missing = []
    if cfg.family != "decoder":
        missing.append(f"family {cfg.family!r}")
    if cfg.first_k_dense:
        missing.append("first_k_dense layers")
    if cfg.frontend is not None:
        missing.append(f"frontend {cfg.frontend!r}")
    if cfg.act != "silu":
        missing.append(f"act {cfg.act!r}")
    if cfg.pos_embed != "rope":
        missing.append(f"pos_embed {cfg.pos_embed!r}")
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported to repro_torch yet: "
                                  + ", ".join(missing))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(cfg: ModelConfig, generator, device, dtype) -> dict:
    return {
        "ln1": L.init_norm(cfg, device, dtype),
        "ln2": L.init_norm(cfg, device, dtype),
        "attn": L.init_attention(cfg, generator, device, dtype),
        "mlp": L.init_mlp(cfg, generator, device, dtype),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator, *, device,
                dtype=torch.float32) -> dict:
    """Random params from ``generator`` (which must live on ``device``)."""
    check_supported(cfg)
    return {
        "embed": L.init_embed(cfg, generator, device, dtype),
        "layers": [init_layer(cfg, generator, device, dtype) for _ in range(cfg.n_layers)],
        "final_norm": L.init_norm(cfg, device, dtype),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer_fwd(p, x, cfg, positions, *, cache=None, cache_index=None, window=None):
    h = L.norm_apply(p["ln1"], x, cfg)
    a, _ = L.attention_apply(p["attn"], h, cfg, positions, causal=True, window=window,
                             cache=cache, cache_index=cache_index)
    x = x + a
    h = L.norm_apply(p["ln2"], x, cfg)
    return x + L.mlp_apply(p["mlp"], h, cfg)


def forward(
    params: dict,
    tokens: torch.Tensor,            # [B, S]
    cfg: ModelConfig,
    *,
    compute_dtype=torch.bfloat16,
    cache: dict | None = None,       # {"k": [L,B,Smax,K,hd], "v": ...}, updated in place
    cache_index: int | None = None,
    window: int | None = None,
    remat: str = "none",
) -> tuple[torch.Tensor, dict | None]:
    """Returns (hidden [B,S,d], cache).  Dense layers only, so the
    reference's third output (the MoE aux loss) is always zero and dropped."""
    if remat not in ("none", "full"):
        raise NotImplementedError(f"remat {remat!r}: the port has 'none' and 'full'")
    b, s = tokens.shape
    base_pos = 0 if cache_index is None else cache_index
    x = L.embed_apply(params["embed"], tokens, cfg, compute_dtype)
    positions = (base_pos + torch.arange(s, device=tokens.device, dtype=torch.int32))
    positions = positions[None, :].expand(b, s)
    for i, lp in enumerate(params["layers"]):
        if remat == "full" and cache is None and torch.is_grad_enabled():
            x = checkpoint(_layer_fwd, lp, x, cfg, positions, window=window,
                           use_reentrant=False)
            continue
        lcache = None if cache is None else {"k": cache["k"][i], "v": cache["v"][i]}
        x = _layer_fwd(lp, x, cfg, positions, cache=lcache, cache_index=cache_index,
                       window=window)
    return L.norm_apply(params["final_norm"], x, cfg), cache


def logits_fn(params, hidden, cfg):
    return L.unembed_apply(params["embed"], hidden, cfg)


# ---------------------------------------------------------------------------
# task heads: loss / prefill / decode
# ---------------------------------------------------------------------------

def loss_fn(params, batch: dict, cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
            remat: str = "full"):
    """Causal LM loss.  batch: tokens [B,S], labels [B,S] (-100 = masked)."""
    hidden, _ = forward(params, batch["tokens"], cfg, compute_dtype=compute_dtype,
                        remat=remat)
    loss = L.masked_xent(logits_fn(params, hidden, cfg), batch["labels"])
    return loss, {"nll": loss}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *, device,
               dtype=torch.bfloat16) -> dict:
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, device=device, dtype=dtype),
            "v": torch.zeros(shape, device=device, dtype=dtype)}


def prefill(params, tokens, cfg: ModelConfig, cache, *, compute_dtype=torch.bfloat16,
            window=None):
    """Fill the cache from position 0; returns (last-token logits, cache)."""
    hidden, cache = forward(params, tokens, cfg, compute_dtype=compute_dtype,
                            cache=cache, cache_index=0, window=window)
    return logits_fn(params, hidden[:, -1:], cfg)[:, 0], cache


def decode_step(params, token, pos: int, cfg: ModelConfig, cache, *,
                compute_dtype=torch.bfloat16, window=None):
    """One decode step.  token [B], pos int (same for the batch — the serving
    engine aligns sequences); returns (logits [B,V], cache)."""
    hidden, cache = forward(params, token[:, None], cfg, compute_dtype=compute_dtype,
                            cache=cache, cache_index=pos, window=window)
    return logits_fn(params, hidden, cfg)[:, 0], cache
