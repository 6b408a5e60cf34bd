"""Fused RMSNorm: the port of ``repro/kernels/rmsnorm.py:rmsnorm``.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/rmsnorm.cu``; on a CPU tensor it runs the plain version
``ref.rmsnorm_ref``.  ``rmsnorm.launches`` counts kernel launches.

Where autograd needs a gradient, the launch goes through ``RMSNormFn``:
forward is the kernel, backward the vector-Jacobian product of the plain
version, recomputed (``ref.plain_vjp``).  Without it the kernel's output
would carry no ``grad_fn`` and training would give no gradient upstream of
the first norm.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import plain_vjp, rmsnorm_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _kernel():
    fn = _build.library("rmsnorm").repro_rmsnorm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x [..., d] (f32 or bf16); w [d] (f32 or bf16).  Returns
    ``x * rsqrt(mean(x²) + eps) * w`` in x's dtype, computed in f32."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    d = x.shape[-1]
    if w.device != x.device:
        raise ValueError(f"rmsnorm: w on {w.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise TypeError(f"rmsnorm: x {x.dtype}, w {w.dtype}; the kernel takes float32 or bfloat16")
    if w.shape != (d,):
        raise ValueError(f"rmsnorm: w shape {tuple(w.shape)}, expected ({d},)")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return RMSNormFn.apply(x, w, eps)
    return _launch(x, w, eps)


def _launch(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    d = x.shape[-1]
    y = torch.empty_like(x)
    n = x.numel() // d if d else 0
    if n == 0:
        return y
    err = _kernel()(x.data_ptr(), w.data_ptr(), y.data_ptr(), n, d, eps,
                    _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], x.device.index,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"rmsnorm kernel launch failed with CUDA error {err}")
    rmsnorm.launches += 1
    return y


class RMSNormFn(torch.autograd.Function):
    """The kernel with a gradient (the plain version on CPU tensors)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        if x.device.type == "cpu":
            return rmsnorm_ref(x, w, eps=eps)
        return _launch(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        dx, dw = plain_vjp(lambda x, w: rmsnorm_ref(x, w, eps=ctx.eps), ctx.saved_tensors,
                           ctx.needs_input_grad[:2], dy)
        return dx, dw, None


rmsnorm.launches = 0
