"""Mamba2 (SSD) blocks and the Zamba2 hybrid: the port of ``repro/models/ssm.py``.

Zamba2 is 54 Mamba2 layers with ONE shared transformer block (attention +
MLP) inserted after every ``attn_every`` of them, with the same weights at
every insertion.  As in the reference:
  * a Mamba2 block runs its prefill through the chunked SSD scan (here
    ``ops.ssd_scan``: the CUDA kernel on the card, ``ssd_chunked_ref`` on the
    CPU) and its decode through the single-step recurrence in plain torch;
  * the Mamba block reads ``ln``, ``gate_norm``, ``A_log``, ``D`` and
    ``dt_bias`` in f32 and casts its matrices and conv weights to the
    activation dtype at use;
  * the cache is ``{"mamba": {"ssm": [G,E,B,H,N,P], "conv": [G,E,B,W-1,C]},
    "attn": {"k"/"v": [G,B,clen,K,hd]}}``, bf16 by default.  The SSM state
    is read in f32 and stored back in the cache's dtype at every step; the
    conv state takes the promoted dtype of the cache and the activations
    (f32 under an f32 model, as the reference's concatenation gives); the
    shared block's cache is a ring of ``clen = min(max_seq, sliding_window)``
    slots (``layers.ring_attention_apply``).
The port keeps ``params["mamba"]`` as a list of per-layer dicts (the
reference stacks them [G, E, ...]) and updates the cache in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import ops
from . import layers as L


def _dims(cfg: ModelConfig):
    s: SSMConfig = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.state_dim
    return s, d_inner, nheads, conv_dim


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a hybrid config that needs a part the port lacks."""
    if cfg.family != "hybrid" or cfg.ssm is None or not cfg.attn_every \
            or cfg.n_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: the hybrid needs family 'hybrid', an ssm config and "
                         f"n_layers a multiple of attn_every")
    missing = []
    if cfg.act != "silu":
        missing.append(f"act {cfg.act!r}")
    if cfg.pos_embed != "rope":
        missing.append(f"pos_embed {cfg.pos_embed!r}")
    if cfg.qkv_bias:
        missing.append("qkv_bias on the shared block")
    if cfg.frontend is not None:
        missing.append(f"frontend {cfg.frontend!r}")
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported to repro_torch yet: "
                                  + ", ".join(missing))


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def init_mamba_block(cfg: ModelConfig, generator, device, dtype) -> dict:
    s, d_inner, nheads, conv_dim = _dims(cfg)
    in_cols = 2 * d_inner + 2 * s.state_dim + nheads  # z, x, B, C, dt
    return {
        "ln": L.init_norm(cfg, device, dtype),
        "in_proj": L._dense_init((cfg.d_model, in_cols), generator, device, dtype),
        "conv_w": L._dense_init((conv_dim, s.conv_width), generator, device, dtype, scale=0.1),
        "conv_b": torch.zeros(conv_dim, device=device, dtype=dtype),
        "A_log": torch.zeros(nheads, device=device, dtype=dtype),     # A = -exp(A_log)
        "D": torch.ones(nheads, device=device, dtype=dtype),
        "dt_bias": torch.zeros(nheads, device=device, dtype=dtype),
        "gate_norm": torch.ones(d_inner, device=device, dtype=dtype),
        "out_proj": L._dense_init((d_inner, cfg.d_model), generator, device, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv, width W, then SiLU.  x [B,S,C]; w [C,W];
    optional carried state [B,W-1,C].  Returns (y [B,S,C], new_state), in
    the promoted dtype of x and the state; the taps are summed in the
    reference's order."""
    width = w.shape[1]
    s = x.shape[1]
    if state is None:
        state = x.new_zeros(x.shape[0], width - 1, x.shape[2])
    dtype = torch.promote_types(state.dtype, x.dtype)
    xx = torch.cat([state.to(dtype), x.to(dtype)], dim=1)       # [B, S+W-1, C]
    wc = w.to(x.dtype)
    y = xx[:, :s] * wc[:, 0]
    for i in range(1, width):
        y = y + xx[:, i:i + s] * wc[:, i]
    y = y + b.to(x.dtype)
    return F.silu(y), xx[:, -(width - 1):]


def mamba_block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *, state: dict | None = None):
    """x [B,S,d].  state (with a cache): {"ssm": [B,H,N,P], "conv": [B,W-1,C]}.
    Returns (y, new_state): new_state is None without a state, else
    {"ssm": f32 [B,H,N,P], "conv": [B,W-1,C]} for the caller to store."""
    s_cfg, d_inner, nheads, conv_dim = _dims(cfg)
    n = s_cfg.state_dim
    res = x
    xn = L.norm_apply(p["ln"], x, cfg)
    proj = xn @ p["in_proj"].to(x.dtype)
    z, xb = proj[..., :d_inner], proj[..., d_inner:d_inner + conv_dim]
    dt_raw = proj[..., d_inner + conv_dim:]
    xb, new_conv = _causal_conv(xb, p["conv_w"], p["conv_b"],
                                None if state is None else state["conv"])
    xm = xb[..., :d_inner]
    bm = xb[..., d_inner:d_inner + n]
    cm = xb[..., d_inner + n:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())

    b, s, _ = x.shape
    xh = xm.reshape(b, s, nheads, s_cfg.head_dim)     # a view of the conv output
    if state is None or s > 1:
        y, hlast = ops.ssd_scan(xh, dt, a, bm, cm, chunk=s_cfg.chunk)
    else:
        # single-step recurrence (decode), outside any kernel as in the reference
        hprev = state["ssm"].float()                                  # [B,H,N,P]
        dt1 = dt[:, 0]                                                # [B,H]
        dec = torch.exp(dt1 * a)
        upd = (bm[:, 0].float()[:, None, :, None]
               * (dt1[..., None] * xh[:, 0].float())[:, :, None, :])
        hlast = hprev * dec[..., None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", cm[:, 0].float(), hlast)[:, None]
    y = y + xh.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(b, s, d_inner).to(x.dtype)
    # the reference's ``layers._rms``: a bare scale vector read in f32
    y = ops.rmsnorm(y * F.silu(z), p["gate_norm"], eps=cfg.norm_eps)
    out = res + y @ p["out_proj"].to(x.dtype)
    new_state = None if state is None else {"ssm": hlast, "conv": new_conv}
    return out, new_state


# ---------------------------------------------------------------------------
# Zamba2 hybrid model
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator, *, device,
                dtype=torch.float32) -> dict:
    """Random params from ``generator`` (which must live on ``device``)."""
    check_supported(cfg)
    return {
        "embed": L.init_embed(cfg, generator, device, dtype),
        "mamba": [init_mamba_block(cfg, generator, device, dtype) for _ in range(cfg.n_layers)],
        "shared_attn": {
            "ln1": L.init_norm(cfg, device, dtype),
            "attn": L.init_attention(cfg, generator, device, dtype),
            "ln2": L.init_norm(cfg, device, dtype),
            "mlp": L.init_mlp(cfg, generator, device, dtype),
        },
        "final_norm": L.init_norm(cfg, device, dtype),
    }


def _attn_cache_len(cfg: ModelConfig, max_seq: int) -> int:
    return min(max_seq, cfg.sliding_window or max_seq)


def _group_fwd(blocks, shared, x, cfg, positions, *, cache=None, g=0, cache_index=None):
    """``attn_every`` Mamba blocks, then the shared block; the cache's
    group ``g`` is read and written in place."""
    for e, lp in enumerate(blocks):
        state = None
        if cache is not None:
            m = cache["mamba"]
            state = {"ssm": m["ssm"][g, e], "conv": m["conv"][g, e]}
        x, new = mamba_block_apply(lp, x, cfg, state=state)
        if cache is not None:
            m["ssm"][g, e].copy_(new["ssm"])              # rounds to the cache dtype
            if m["conv"].dtype != new["conv"].dtype:       # f32 activations, bf16 cache
                m["conv"] = m["conv"].to(new["conv"].dtype)
            m["conv"][g, e].copy_(new["conv"])
    h = L.norm_apply(shared["ln1"], x, cfg)
    acache = None if cache is None else {"k": cache["attn"]["k"][g], "v": cache["attn"]["v"][g]}
    x = x + L.ring_attention_apply(shared["attn"], h, cfg, positions, window=cfg.sliding_window,
                                   cache=acache, cache_index=cache_index)
    h = L.norm_apply(shared["ln2"], x, cfg)
    return x + L.mlp_apply(shared["mlp"], h, cfg)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            compute_dtype=torch.bfloat16, cache: dict | None = None,
            cache_index: int | None = None, remat: str = "none"):
    """Returns (hidden [B,S,d], cache).  ``remat="full"`` recomputes each
    group (6 Mamba blocks and the shared block) in the backward pass."""
    if remat not in ("none", "full"):
        raise NotImplementedError(f"remat {remat!r}: the port has 'none' and 'full'")
    b, s = tokens.shape
    x = L.embed_apply(params["embed"], tokens, cfg, compute_dtype)
    base_pos = 0 if cache_index is None else cache_index
    positions = (base_pos + torch.arange(s, device=tokens.device, dtype=torch.int32))
    positions = positions[None, :].expand(b, s)
    e = cfg.attn_every
    for g in range(cfg.n_layers // e):
        blocks = params["mamba"][g * e:(g + 1) * e]
        if remat == "full" and cache is None and torch.is_grad_enabled():
            x = checkpoint(_group_fwd, blocks, params["shared_attn"], x, cfg, positions,
                           use_reentrant=False)
        else:
            x = _group_fwd(blocks, params["shared_attn"], x, cfg, positions, cache=cache, g=g,
                           cache_index=cache_index)
    return L.norm_apply(params["final_norm"], x, cfg), cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *, device,
               dtype=torch.bfloat16) -> dict:
    s_cfg, d_inner, nheads, conv_dim = _dims(cfg)
    groups, e = cfg.n_layers // cfg.attn_every, cfg.attn_every
    clen = _attn_cache_len(cfg, max_seq)
    hd = cfg.resolved_head_dim
    zeros = lambda *shape: torch.zeros(shape, device=device, dtype=dtype)  # noqa: E731
    return {
        "mamba": {"ssm": zeros(groups, e, batch, nheads, s_cfg.state_dim, s_cfg.head_dim),
                  "conv": zeros(groups, e, batch, s_cfg.conv_width - 1, conv_dim)},
        "attn": {"k": zeros(groups, batch, clen, cfg.n_kv_heads, hd),
                 "v": zeros(groups, batch, clen, cfg.n_kv_heads, hd)},
    }


def logits_fn(params, hidden, cfg):
    return L.unembed_apply(params["embed"], hidden, cfg)


def loss_fn(params, batch: dict, cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
            remat: str = "full"):
    hidden, _ = forward(params, batch["tokens"], cfg, compute_dtype=compute_dtype, remat=remat)
    loss = L.masked_xent(logits_fn(params, hidden, cfg), batch["labels"])
    return loss, {"nll": loss}


def _check_window(cfg: ModelConfig, window) -> None:
    # the shared block's window sizes its ring cache, so it is cfg's own
    if window not in (None, cfg.sliding_window):
        raise ValueError(f"{cfg.name}: window {window}; the hybrid's is "
                         f"cfg.sliding_window = {cfg.sliding_window}")


def prefill(params, tokens, cfg: ModelConfig, cache, *, compute_dtype=torch.bfloat16,
            window=None):
    """Fill the cache from position 0; returns (last-token logits, cache)."""
    _check_window(cfg, window)
    hidden, cache = forward(params, tokens, cfg, compute_dtype=compute_dtype, cache=cache,
                            cache_index=0)
    return logits_fn(params, hidden[:, -1:], cfg)[:, 0], cache


def decode_step(params, token, pos: int, cfg: ModelConfig, cache, *,
                compute_dtype=torch.bfloat16, window=None):
    """One decode step at position ``pos`` (the same for the batch)."""
    _check_window(cfg, window)
    hidden, cache = forward(params, token[:, None], cfg, compute_dtype=compute_dtype,
                            cache=cache, cache_index=pos)
    return logits_fn(params, hidden, cfg)[:, 0], cache
