"""Plain PyTorch versions of the kernels (the allclose targets).

Counterparts of ``repro/kernels/ref.py``: ``rmsnorm_ref`` and
``flash_attention_ref``.  The attention version is extended to what the
model needs and the Pallas kernel lacks: GQA (``H = K·g``, K/V read per
KV head), ``q_offset`` (query ``i`` sits at position ``q_offset + i``),
``window`` and a valid KV length ``kv_len``.  The wrappers take these on
CPU tensors; on the card ``chip_smoke.py`` holds each kernel against them.
"""

from __future__ import annotations

import math

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, sm_scale: float | None = None,
                        q_offset: int = 0, window: int | None = None,
                        kv_len: int | None = None) -> torch.Tensor:
    """q [B, Sq, H, D]; k/v [B, Skv, K, D] with K | H.  Returns [B, Sq, H, D]
    in q's dtype.

    Key ``n`` is seen by query ``i`` (position ``p = q_offset + i``) when
    ``n < kv_len``, ``n <= p`` if causal, and ``p - n < window`` if a window
    is given.  Math in f32; a query that sees no key gets 0, as in the
    reference's ``blocked_attention``.
    """
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    kv_len = skv if kv_len is None else kv_len
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    kf = k[:, :kv_len].float().permute(0, 2, 1, 3)             # [B, K, S, D]
    vf = v[:, :kv_len].float().permute(0, 2, 1, 3)
    qf = q.float().reshape(b, sq, kh, g, d).permute(0, 2, 3, 1, 4)  # [B,K,g,Sq,D]
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * sm_scale
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(kv_len, device=q.device)[None, :]
    mask = torch.ones(sq, kv_len, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = s.masked_fill(~mask, -math.inf)
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, vf) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
