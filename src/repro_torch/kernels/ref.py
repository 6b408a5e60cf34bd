"""Plain PyTorch versions of the kernels (the allclose targets).

Counterparts of ``repro/kernels/ref.py``: ``rmsnorm_ref``,
``flash_attention_ref`` and the three quantization oracles
``quantize_blocks_ref``, ``ef_quantize_bucketize_ref`` and
``dequant_add_ref``.  The attention version is extended to what the
model needs and the Pallas kernel lacks: GQA (``H = K·g``, K/V read per
KV head), ``q_offset`` (query ``i`` sits at position ``q_offset + i``),
``window`` and a valid KV length ``kv_len``.  The wrappers take these on
CPU tensors; on the card ``chip_smoke.py`` holds each kernel against them.
``plain_vjp`` gives the kernels' autograd Functions their backward: the
vector-Jacobian product of the plain version, recomputed.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def plain_vjp(fn, inputs, needs_grad, grad_out):
    """Gradients of ``fn(*inputs)`` against ``grad_out`` for the inputs whose
    ``needs_grad`` is set (None for the others), by autograd through ``fn``
    recomputed on detached copies of the inputs.  The reference has no
    backward kernel either: JAX differentiates the jnp twins of its kernels."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(bool(n)) for t, n in zip(inputs, needs_grad)]
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(fn(*leaves), wanted, grad_out) if wanted else ())
    return tuple(next(grads) if t.requires_grad else None for t in leaves)


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


def _qmax(bits: int) -> float:
    if not 2 <= bits <= 8:
        raise ValueError(f"bits {bits}: the int8 codes hold 2..8 bits")
    return float(2 ** (bits - 1) - 1)


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """x [n] as f32 [n_pad / block, block], zero-padded to a block multiple."""
    pad = (-x.shape[0]) % block
    xf = x.float()
    if pad:
        xf = torch.cat([xf, xf.new_zeros(pad)])
    return xf.reshape(-1, block)


def quantize_blocks_ref(x: torch.Tensor, *, block: int = 1024, bits: int = 8):
    """x [n] -> (q int8 [n_pad], scales f32 [n_pad / block], n).  One scale
    per block, ``max(max|x|, 1e-30) / qmax`` (a true division)."""
    qmax = _qmax(bits)
    xb = _blocks(x, block)
    amax = xb.abs().amax(dim=1).clamp_min(1e-30)
    # divide by a tensor, not a Python scalar: on CUDA torch turns division
    # by a host scalar into a reciprocal multiply, which is not the kernel's
    # IEEE division
    scales = amax / torch.full_like(amax, qmax)
    q = torch.round(xb / scales[:, None]).clamp(-qmax, qmax).to(torch.int8)
    return q.reshape(-1), scales, x.shape[0]


def ef_quantize_bucketize_ref(grad: torch.Tensor, residual: torch.Tensor, *,
                              block: int = 1024, bits: int = 8):
    """Oracle of the fused EF quantize+bucketize kernel: grad/residual [n] ->
    (q int8 [n_pad], scales f32 [n_pad / block], deq f32 [n_pad],
    new_residual f32 [n_pad], n).

    t = grad + residual; scale = max(max|t|, 1e-30) * (1/qmax), with 1/qmax
    rounded to f32 once (the reference's weakly typed constant); q =
    clip(round_half_even(t / scale)); deq = q * scale; new residual = t - deq.
    """
    qmax = _qmax(bits)
    tb = _blocks(grad.float() + residual.float(), block)
    scales = tb.abs().amax(dim=1).clamp_min(1e-30) * float(np.float32(1.0 / qmax))
    qb = torch.round(tb / scales[:, None]).clamp(-qmax, qmax)
    deq = qb * scales[:, None]
    resid = tb - deq
    return (qb.to(torch.int8).reshape(-1), scales, deq.reshape(-1), resid.reshape(-1),
            grad.shape[0])


def dequant_add_ref(q: torch.Tensor, scales: torch.Tensor, acc: torch.Tensor, *,
                    block: int = 1024) -> torch.Tensor:
    """acc [n_pad] + q [n_pad] * scales[block of each element], in acc's dtype
    (the product rounded to f32 before the sum)."""
    deq = (q.reshape(-1, block).float() * scales[:, None]).reshape(-1)
    return (acc.float() + deq).to(acc.dtype)
