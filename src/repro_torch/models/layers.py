"""Dense decoder layers: the port of the dense subset of ``repro/models/layers.py``.

Conventions kept from the reference:
  * ``init_*`` returns a dict of tensors; ``*_apply`` consumes it, with the
    reference's parameter names (``wq``, ``bq``, ``scale``, ``tok`` ...).
  * Activations flow in the compute dtype; matrices are cast to it at use
    (``_proj``).  A cast to the dtype a tensor already has is free, so the
    serving engine casts matrices and biases ONCE (bit-identical values) and
    this code is unchanged.  Norm scales stay f32: ``norm_apply`` reads them
    in f32, as the reference does.
  * f32 matmuls run in full f32: torch's default
    (``torch.backends.cuda.matmul.allow_tf32 = False``), which
    ``chip_smoke.py`` also sets for its f32 references.
  * Attention tensors are [B, S, H, D] at rest; KV caches [B, Smax, K, hd]
    per layer.  The cache is updated in place (the reference returns a new
    one), which keeps one copy of it in device memory.

Where the reference runs the jnp twins of its Pallas kernels
(``norm_apply`` → ``kernels/rmsnorm.py``, ``blocked_attention`` and
``decode_attention`` → ``kernels/flash_attention.py``), this module calls the
port's kernel wrappers, which launch the CUDA kernels on the card and run
their plain versions on the CPU.  The hybrid's shared attention block, with
its ring-buffer decode cache (``repro/models/ssm.py``), is here too:
``ring_attention_apply``.  MoE, MLA, learned positions and the non-swiglu
MLPs are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops


def _dense_init(shape, generator, device, dtype, scale=0.02) -> torch.Tensor:
    return (torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
            * scale).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device, dtype) -> dict:
    p = {"scale": torch.ones(cfg.d_model, device=device, dtype=dtype)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(cfg.d_model, device=device, dtype=dtype)
    return p


def norm_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm == "layernorm":
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)
    return ops.rmsnorm(x, p["scale"], eps=cfg.norm_eps)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (int).  Rotate-half, angles in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # [D/2]
    ang = positions[..., None].float() * freqs              # [B, S, D/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer (with optional cache)
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, generator, device, dtype) -> dict:
    hd = cfg.resolved_head_dim
    p = {
        "wq": _dense_init((cfg.d_model, cfg.n_heads * hd), generator, device, dtype),
        "wk": _dense_init((cfg.d_model, cfg.n_kv_heads * hd), generator, device, dtype),
        "wv": _dense_init((cfg.d_model, cfg.n_kv_heads * hd), generator, device, dtype),
        "wo": _dense_init((cfg.n_heads * hd, cfg.d_model), generator, device, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(cfg.n_heads * hd, device=device, dtype=dtype)
        p["bk"] = torch.zeros(cfg.n_kv_heads * hd, device=device, dtype=dtype)
        p["bv"] = torch.zeros(cfg.n_kv_heads * hd, device=device, dtype=dtype)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def attention_apply(
    p: dict,
    x: torch.Tensor,                 # [B, S, d]
    cfg: ModelConfig,
    positions: torch.Tensor,         # [B, S]
    *,
    causal: bool = True,
    window: int | None = None,
    cache: dict | None = None,       # {"k","v"} [B, S_max, K, hd], written in place
    cache_index: int | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """GQA attention with QKV bias and RoPE.  With a cache, K/V are written at
    ``cache_index`` and the queries attend to the first ``cache_index + S``
    cache rows (prefill for S > 1, decode for S = 1) through the attention
    kernel; without one, to this call's own K/V."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = _proj(x, p["wq"], p.get("bq")).reshape(b, s, cfg.n_heads, hd)
    k = _proj(x, p["wk"], p.get("bk")).reshape(b, s, cfg.n_kv_heads, hd)
    v = _proj(x, p["wv"], p.get("bv")).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if cache is not None:
        kc, vc = cache["k"], cache["v"]
        kc[:, cache_index:cache_index + s] = k
        vc[:, cache_index:cache_index + s] = v
        out = ops.flash_attention(q, kc, vc, causal=causal, q_offset=cache_index,
                                  window=window, kv_len=cache_index + s)
    else:
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
    y = out.reshape(b, s, cfg.n_heads * hd) @ p["wo"].to(x.dtype)
    return y, cache


def ring_attention_apply(
    p: dict,
    x: torch.Tensor,                 # [B, S, d]
    cfg: ModelConfig,
    positions: torch.Tensor,         # [B, S]
    *,
    window: int | None = None,
    cache: dict | None = None,       # {"k","v"} [B, clen, K, hd], written in place
    cache_index: int | None = None,
) -> torch.Tensor:
    """Causal GQA attention of the hybrid's shared block, whose decode cache
    is a ring of ``clen`` slots (``repro/models/ssm.py:247-296``): position
    ``t`` lives in slot ``t % clen`` with its key stored rotated, so the
    decode mask is "slot filled" (``kv_len = min(t + 1, clen)``, no causal
    mask).  Prefill attends over its own keys (causal, ``window``) and seeds
    the ring with the last ``clen`` keys and values from slot 0, as the
    reference does; decode (S = 1 with a cache) writes slot ``t % clen``.
    The reference projects q/k/v without the QKV bias on this block, so the
    hybrid refuses ``qkv_bias`` (``ssm.check_supported``)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = apply_rope(_proj(x, p["wq"]).reshape(b, s, cfg.n_heads, hd), positions, cfg.rope_theta)
    k = apply_rope(_proj(x, p["wk"]).reshape(b, s, cfg.n_kv_heads, hd), positions,
                   cfg.rope_theta)
    v = _proj(x, p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    if cache is not None and s == 1:
        kc, vc = cache["k"], cache["v"]
        clen = kc.shape[1]
        widx = cache_index % clen
        kc[:, widx:widx + 1] = k
        vc[:, widx:widx + 1] = v
        out = ops.flash_attention(q, kc, vc, causal=False, kv_len=min(cache_index + 1, clen))
    else:
        out = ops.flash_attention(q, k, v, causal=True, window=window)
        if cache is not None:
            clen = cache["k"].shape[1]
            if s >= clen:
                # the reference's slot alignment holds only when clen | s
                # (ROADMAP C); the port copies it
                cache["k"].copy_(k[:, -clen:])
                cache["v"].copy_(v[:, -clen:])
            else:
                cache["k"][:, :s] = k
                cache["v"][:, :s] = v
    return out.reshape(b, s, cfg.n_heads * hd) @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (swiglu)
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, generator, device, dtype) -> dict:
    return {
        "w_gate": _dense_init((cfg.d_model, cfg.d_ff), generator, device, dtype),
        "w_up": _dense_init((cfg.d_model, cfg.d_ff), generator, device, dtype),
        "w_down": _dense_init((cfg.d_ff, cfg.d_model), generator, device, dtype),
    }


def mlp_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    gate = F.silu(_proj(x, p["w_gate"]))
    return _proj(gate * _proj(x, p["w_up"]), p["w_down"])


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def init_embed(cfg: ModelConfig, generator, device, dtype) -> dict:
    p = {"tok": _dense_init((cfg.padded_vocab, cfg.d_model), generator, device, dtype,
                            scale=1.0)}
    if not cfg.tie_embeddings:
        p["unembed"] = _dense_init((cfg.d_model, cfg.padded_vocab), generator, device, dtype)
    return p


def embed_apply(p: dict, tokens: torch.Tensor, cfg: ModelConfig, dtype) -> torch.Tensor:
    return p["tok"][tokens].to(dtype)


def unembed_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ p["tok"].T.to(x.dtype)
    else:
        logits = x @ p["unembed"].to(x.dtype)
    logits[..., cfg.vocab_size:] = -1e9   # mask the padded vocab rows out of softmax
    return logits


def masked_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over labels >= 0."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - ll) * mask).sum() / mask.sum().clamp_min(1.0)
