"""Blockwise int quantization: the port of ``repro/kernels/quant.py``.

Three wrappers, each with its own launch counter:

* ``ef_quantize_bucketize`` (replaces ``_ef_quant_kernel``) — the fused
  error-feedback step of the compressed gradient sync, launched once per
  compressed bucket and step;
* ``quantize_blocks`` (replaces ``_quant_kernel``) and ``dequant_add``
  (replaces ``_dequant_add_kernel``) — the standalone quantize and fused
  dequantize-accumulate, which only the tests and ``chip_smoke.py`` reach.

On CUDA tensors each wrapper launches its kernel in ``csrc/quant.cu``; on
CPU tensors it runs its plain version in ``ref.py``.  The contract is the
reference's: q, scales and deq bit-equal to the oracle, the residual too
here (the kernel rounds ``q * scale`` before the subtraction, as the oracle
does).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .ref import _qmax, dequant_add_ref, ef_quantize_bucketize_ref, quantize_blocks_ref

# the scale floor as the reference's f32 constant
_TINY = float(np.float32(1e-30))


@functools.cache
def _lib():
    lib = _build.library("quant")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.repro_ef_quantize_bucketize.argtypes = [p] * 6 + [ll, i, f, f, f, i, p]
    lib.repro_quantize_blocks.argtypes = [p] * 3 + [ll, i, f, f, i, p]
    lib.repro_dequant_add.argtypes = [p] * 4 + [ll, i, i, i, p]
    for fn in (lib.repro_ef_quantize_bucketize, lib.repro_quantize_blocks,
               lib.repro_dequant_add):
        fn.restype = ctypes.c_int
    return lib


def _check_flat(name: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device} and {dev}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be 1-D and contiguous, got "
                             f"{tuple(t.shape)} (contiguous {t.is_contiguous()})")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


# csrc/quant.cu keeps a block in registers: 4 float4 per thread, 256 threads
_MAX_BLOCK = 4096


def _kernel_inputs(name: str, block: int, *tensors: torch.Tensor) -> list[torch.Tensor]:
    """The quantize kernels' inputs: ``block`` a multiple of 4 up to 4096,
    each tensor 16-byte aligned (a view that is not is copied)."""
    if block % 4 or block > _MAX_BLOCK:
        raise ValueError(f"{name}: the kernel takes a block that is a multiple of 4 up to "
                         f"{_MAX_BLOCK}, got {block}")
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors]


def ef_quantize_bucketize(grad: torch.Tensor, residual: torch.Tensor, *,
                          block: int = 1024, bits: int = 8):
    """Fused EF quantize+bucketize: grad/residual [n] f32 ->
    (q int8 [n_pad], scales f32 [n_pad / block], deq f32 [n_pad],
    new_residual f32 [n_pad], n), n_pad the next multiple of ``block``."""
    dev = _check_flat("ef_quantize_bucketize", grad, residual)
    if grad.shape != residual.shape or block < 1:
        raise ValueError(f"ef_quantize_bucketize: grad {tuple(grad.shape)}, residual "
                         f"{tuple(residual.shape)}, block {block}")
    qmax = _qmax(bits)
    if dev.type == "cpu":
        return ef_quantize_bucketize_ref(grad, residual, block=block, bits=bits)
    if grad.dtype != torch.float32 or residual.dtype != torch.float32:
        raise TypeError(f"ef_quantize_bucketize: grad {grad.dtype}, residual "
                        f"{residual.dtype}; the kernel takes float32")
    grad, residual = _kernel_inputs("ef_quantize_bucketize", block, grad, residual)
    n = grad.shape[0]
    nb = -(-n // block)
    q = torch.empty(nb * block, dtype=torch.int8, device=dev)
    scales = torch.empty(nb, dtype=torch.float32, device=dev)
    deq = torch.empty(nb * block, dtype=torch.float32, device=dev)
    new_r = torch.empty(nb * block, dtype=torch.float32, device=dev)
    if n:
        _raise_on(_lib().repro_ef_quantize_bucketize(
            grad.data_ptr(), residual.data_ptr(), q.data_ptr(), scales.data_ptr(),
            deq.data_ptr(), new_r.data_ptr(), n, block, qmax,
            float(np.float32(1.0 / qmax)), _TINY, dev.index, _stream(dev)),
            "ef_quantize_bucketize")
        ef_quantize_bucketize.launches += 1
    return q, scales, deq, new_r, n


def quantize_blocks(x: torch.Tensor, *, block: int = 1024, bits: int = 8):
    """x [n] f32 -> (q int8 [n_pad], scales f32 [n_pad / block], n); scale =
    max(max|x|, 1e-30) / qmax per block (a true division)."""
    dev = _check_flat("quantize_blocks", x)
    if block < 1:
        raise ValueError(f"quantize_blocks: block {block}")
    qmax = _qmax(bits)
    if dev.type == "cpu":
        return quantize_blocks_ref(x, block=block, bits=bits)
    if x.dtype != torch.float32:
        raise TypeError(f"quantize_blocks: x {x.dtype}; the kernel takes float32")
    x, = _kernel_inputs("quantize_blocks", block, x)
    n = x.shape[0]
    nb = -(-n // block)
    q = torch.empty(nb * block, dtype=torch.int8, device=dev)
    scales = torch.empty(nb, dtype=torch.float32, device=dev)
    if n:
        _raise_on(_lib().repro_quantize_blocks(
            x.data_ptr(), q.data_ptr(), scales.data_ptr(), n, block, qmax, _TINY,
            dev.index, _stream(dev)), "quantize_blocks")
        quantize_blocks.launches += 1
    return q, scales, n


_ACC_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def dequant_add(q: torch.Tensor, scales: torch.Tensor, acc: torch.Tensor, *,
                block: int = 1024) -> torch.Tensor:
    """acc [n_pad] + q [n_pad] * scales[i // block], returned in acc's dtype
    (a new tensor, like the reference's)."""
    dev = _check_flat("dequant_add", q, scales, acc)
    if q.shape != acc.shape or scales.shape[0] * block != acc.shape[0]:
        raise ValueError(f"dequant_add: q {tuple(q.shape)}, scales {tuple(scales.shape)}, "
                         f"acc {tuple(acc.shape)}, block {block}")
    if dev.type == "cpu":
        return dequant_add_ref(q, scales, acc, block=block)
    if q.dtype != torch.int8 or scales.dtype != torch.float32 or acc.dtype not in _ACC_DTYPES:
        raise TypeError(f"dequant_add: q {q.dtype}, scales {scales.dtype}, acc {acc.dtype}; "
                        f"the kernel takes int8, float32 and float32 or bfloat16")
    out = torch.empty_like(acc)
    if acc.numel():
        _raise_on(_lib().repro_dequant_add(
            q.data_ptr(), scales.data_ptr(), acc.data_ptr(), out.data_ptr(), acc.numel(),
            block, _ACC_DTYPES[acc.dtype], dev.index, _stream(dev)), "dequant_add")
        dequant_add.launches += 1
    return out


ef_quantize_bucketize.launches = 0
quantize_blocks.launches = 0
dequant_add.launches = 0
