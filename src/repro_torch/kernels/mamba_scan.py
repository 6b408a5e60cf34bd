"""Mamba2 SSD chunked scan: the port of ``repro/kernels/mamba_scan.py:ssd_scan``
with the head fold of ``repro/kernels/ops.py:ssd_scan``.

On CUDA tensors the wrapper launches the hand-written kernel in
``csrc/ssd.cu``, which reads B and C once per batch row (no broadcast across
the heads in device memory) and returns the final state beside ``y``, as
the model's ``ssd_chunked`` does: bf16 inputs go to the tensor cores
(64-step tiles, the f32 factor of each product split into two bf16
parts), f32 inputs to the f32 FMA kernel.  On CPU tensors it runs the plain
version ``ref.ssd_chunked_ref``.  ``ssd_scan.launches`` counts kernel
launches.

Where autograd needs a gradient, the launch goes through ``SSDScanFn``:
forward is the kernel, backward the vector-Jacobian product of the plain
version, recomputed (``ref.plain_vjp``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import plain_vjp, ssd_chunked_ref

DIMS = (16, 32, 64)      # state and head dims the kernel takes
MAX_CHUNK = 128
_IN_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _kernel():
    fn = _build.library("ssd").repro_ssd_scan
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 10
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bm: torch.Tensor,
             cm: torch.Tensor, *, chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P]; dt [B,S,H] (f32, positive); a [H] (f32, negative);
    bm/cm [B,S,N] (shared by the heads).  Returns (y [B,S,H,P], final state
    [B,H,N,P]), both f32, over chunks of ``min(chunk, S)`` steps.

    x, bm and cm may be f32 or bf16 (read in f32) and strided views with a
    unit last stride, such as slices of the Mamba block's conv output.
    """
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or bm.dim() != 3 or bm.shape != cm.shape:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, a {tuple(a.shape)}, "
                         f"bm {tuple(bm.shape)}, cm {tuple(cm.shape)}; expected [B,S,H,P], "
                         f"[B,S,H], [H] and equal [B,S,N]")
    b, s, h, p = x.shape
    n = bm.shape[-1]
    if dt.shape != (b, s, h) or a.shape != (h,) or bm.shape[:2] != (b, s):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, a {tuple(a.shape)} "
                         f"and bm {tuple(bm.shape)} disagree on batch, length or heads")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk {chunk}")
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, a, bm, cm, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    if any(t.device != x.device for t in (dt, a, bm, cm)):
        raise ValueError("ssd_scan: x, dt, a, bm, cm must be on one device")
    if x.dtype not in _IN_DTYPES or bm.dtype != x.dtype or cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x {x.dtype}, bm {bm.dtype}, cm {cm.dtype}; the kernel "
                        f"takes them all float32 or all bfloat16")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt {dt.dtype}, a {a.dtype}; the kernel takes float32")
    if p not in DIMS or n not in DIMS:
        raise ValueError(f"ssd_scan: head_dim {p} and state_dim {n} must be in {DIMS}")
    if min(chunk, s) > MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {min(chunk, s)} over {MAX_CHUNK}")
    if x.stride(-1) != 1 or bm.stride(-1) != 1 or cm.stride(-1) != 1 or not a.is_contiguous():
        raise ValueError("ssd_scan: x, bm and cm need a unit last stride, a a contiguous vector")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a, bm, cm)):
        return SSDScanFn.apply(x, dt, a, bm, cm, chunk)
    return _launch(x, dt, a, bm, cm, chunk)


def _rows_aligned(t: torch.Tensor) -> bool:
    """Whether every row of ``t`` (its last dimension) starts on 16 bytes."""
    return t.data_ptr() % 16 == 0 and all(st * t.element_size() % 16 == 0
                                          for st in t.stride()[:-1])


def _launch(x, dt, a, bm, cm, chunk):
    if x.dtype == torch.bfloat16:
        # the tensor-core kernel copies rows as 16-byte vectors: a view whose
        # rows are not aligned so (not the Mamba block's) is copied first
        x, bm, cm = (t if _rows_aligned(t) else t.clone(memory_format=torch.contiguous_format)
                     for t in (x, bm, cm))
    b, s, h, p = x.shape
    n = bm.shape[-1]
    y = torch.empty(b, s, h, p, device=x.device, dtype=torch.float32)
    hlast = torch.empty(b, h, n, p, device=x.device, dtype=torch.float32)
    if b * s * h == 0:
        return y, hlast.zero_()
    err = _kernel()(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                    y.data_ptr(), hlast.data_ptr(), b, s, h, p, n, min(chunk, s),
                    *x.stride()[:3], *dt.stride(), *bm.stride()[:2], *cm.stride()[:2],
                    int(x.dtype == torch.bfloat16), x.device.index,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed with CUDA error {err}")
    ssd_scan.launches += 1
    return y, hlast


class SSDScanFn(torch.autograd.Function):
    """The kernel with a gradient (the plain version on CPU tensors)."""

    @staticmethod
    def forward(ctx, x, dt, a, bm, cm, chunk):
        ctx.save_for_backward(x, dt, a, bm, cm)
        ctx.chunk = chunk
        if x.device.type == "cpu":
            return ssd_chunked_ref(x, dt, a, bm, cm, chunk=chunk)
        return _launch(x, dt, a, bm, cm, chunk)

    @staticmethod
    def backward(ctx, dy, dh):
        grads = plain_vjp(lambda *t: ssd_chunked_ref(*t, chunk=ctx.chunk), ctx.saved_tensors,
                          ctx.needs_input_grad[:5], (dy, dh))
        return (*grads, None)


ssd_scan.launches = 0
