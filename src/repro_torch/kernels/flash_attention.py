"""GQA attention: the port of ``repro/kernels/flash_attention.py:flash_attention``
with the GQA fold of ``repro/kernels/ops.py:flash_attention``.

On CUDA tensors the wrapper launches the hand-written kernel in
``csrc/attention.cu``, which reads K/V per KV head (no broadcast across the
group in device memory); on CPU tensors it runs the plain version
``ref.flash_attention_ref``.  ``flash_attention.launches`` counts kernel
launches.

Where autograd needs a gradient, the launch goes through ``FlashAttentionFn``:
forward is the kernel, backward the vector-Jacobian product of the plain
version, recomputed (``ref.plain_vjp``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .ref import flash_attention_ref, plain_vjp

HEAD_DIMS = (32, 64, 128)
# (q dtype, kv dtype) pairs the kernel is instantiated for; the KV cache may
# be bf16 under an f32 model, as in the reference's serving engine
_DTYPE_PAIRS = {(torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
                (torch.float32, torch.float32)}


@functools.cache
def _kernel():
    fn = _build.library("attention").repro_gqa_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float | None = None,
                    q_offset: int = 0, window: int | None = None,
                    kv_len: int | None = None) -> torch.Tensor:
    """q [B, Sq, H, D]; k/v [B, Skv, K, D] with K | H.  Returns [B, Sq, H, D].

    Query ``i`` sits at position ``q_offset + i`` and sees key ``n`` when
    ``n < kv_len`` (default Skv), ``n <= q_offset + i`` if causal, and
    ``q_offset + i - n < window`` if a window is given.  Prefill passes the
    whole KV cache with ``kv_len = cache_index + Sq``; decode is ``Sq = 1``.
    """
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; expected [B,Sq,H,D] and equal [B,Skv,K,D]")
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kh == 0 or h % kh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on batch/head_dim, or K does not divide H")
    kv_len = skv if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= skv:
        raise ValueError(f"flash_attention: kv_len {kv_len} outside [1, {skv}]")
    if q_offset < 0 or (window is not None and window < 1):
        raise ValueError(f"flash_attention: q_offset {q_offset}, window {window}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, sm_scale=sm_scale,
                                   q_offset=q_offset, window=window, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must be on one device")
    if (q.dtype, k.dtype) not in _DTYPE_PAIRS or v.dtype != k.dtype:
        raise TypeError(f"flash_attention: q {q.dtype}, k {k.dtype}, v {v.dtype}; "
                        f"the kernel takes (q, kv) in {sorted(map(str, _DTYPE_PAIRS))}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    opts = (causal, sm_scale, q_offset, window, kv_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, *opts)
    return _launch(q, k, v, *opts)


def _launch(q, k, v, causal, sm_scale, q_offset, window, kv_len) -> torch.Tensor:
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    if b * sq == 0:
        return o
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    b, sq, h, kh, skv, d, kv_len, q_offset,
                    0 if window is None else window, int(causal), sm_scale,
                    int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
                    q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"attention kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    return o


class FlashAttentionFn(torch.autograd.Function):
    """The kernel with a gradient (the plain version on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, q_offset, window, kv_len):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, sm_scale=sm_scale, q_offset=q_offset,
                        window=window, kv_len=kv_len)
        if q.device.type == "cpu":
            return flash_attention_ref(q, k, v, **ctx.opts)
        return _launch(q, k, v, causal, sm_scale, q_offset, window, kv_len)

    @staticmethod
    def backward(ctx, do):
        grads = plain_vjp(lambda q, k, v: flash_attention_ref(q, k, v, **ctx.opts),
                          ctx.saved_tensors, ctx.needs_input_grad[:3], do)
        return (*grads, None, None, None, None, None)


flash_attention.launches = 0
