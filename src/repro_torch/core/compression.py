"""Gradient compression: the port of ``repro/core/compression.py``.

Symmetric linear quantization with error feedback (EF-SGD): the residual of
each step's quantization is added back before the next step's compression,
and rides in the train state (``state["ef"]``, a tree mirroring the params).

``ef_compress_blocks`` is the per-bucket, per-block-scale EF step behind
``sync_algorithm="planned_sharded_compressed"``; ``fused=True`` routes it
through the hand-written CUDA kernel (``kernels.quant.ef_quantize_bucketize``,
the plain version on CPU tensors).  The planned collective reduces the
dequantized f32 values, as in the reference: nothing narrower goes on the
wire.

The ``compress_pod_axis`` path (``compressed_allreduce_rd``,
``compressed_allreduce``, ``ef_allreduce_tree``) is not ported yet: it
comes with the all-reduce modes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ops as kops
from ..tree import map_tensors


class QuantChunk(NamedTuple):
    q: torch.Tensor       # int8 payload
    scale: torch.Tensor   # f32 scalar scale


def quantize(x: torch.Tensor, bits: int = 8) -> QuantChunk:
    """Symmetric linear quantization with a per-tensor scale."""
    qmax = float(2 ** (bits - 1) - 1)
    if x.numel() == 0:  # zero-size leaves
        return QuantChunk(x.to(torch.int8), torch.ones((), dtype=torch.float32, device=x.device))
    amax = x.abs().amax().clamp_min(1e-30)
    scale = amax / torch.full_like(amax, qmax)
    q = torch.round(x / scale).clamp(-qmax, qmax).to(torch.int8)
    return QuantChunk(q, scale.float())


def dequantize(c: QuantChunk, dtype=torch.float32) -> torch.Tensor:
    return c.q.to(dtype) * c.scale.to(dtype)


def ef_compress(grad: torch.Tensor, residual: torch.Tensor, bits: int = 8):
    """Error-feedback step: compress (grad + residual), return the quantized
    value to transmit and the new residual."""
    target = grad + residual
    c = quantize(target, bits)
    return c, target - dequantize(c, target.dtype)


def init_ef_state(grads):
    return map_tensors(torch.zeros_like, grads)


def ef_compress_blocks(flat: torch.Tensor, residual: torch.Tensor, *, bits: int = 8,
                       block: int = 1024, fused: bool = False):
    """Per-block-scale error-feedback compression of one flat bucket.

    Compresses ``flat + residual`` with one symmetric scale per ``block``
    elements and returns ``(deq, new_residual)``: ``deq`` is the dequantized
    wire value the planned collective reduces, ``new_residual = target -
    deq`` feeds the next step.  ``fused=True`` runs the CUDA kernel (on CPU
    tensors its plain version); the tensor path below gives the same bits.
    ``bits >= 32`` is the identity (no compression, residual zero).
    """
    if bits >= 32 or flat.numel() == 0:
        return flat, torch.zeros_like(residual)
    if fused:
        # the kernel reads f32, as the reference's casts its inputs to f32
        _q, _s, deq, new_r, n = kops.ef_quantize_bucketize(flat.float(), residual.float(),
                                                           block=block, bits=bits)
        return deq[:n].to(flat.dtype), new_r[:n].to(residual.dtype)
    qmax = float(2 ** (bits - 1) - 1)
    n = flat.shape[0]
    pad = (-n) % block
    target = flat.float() + residual.float()
    tp = torch.cat([target, target.new_zeros(pad)]) if pad else target
    tb = tp.reshape(-1, block)
    # reciprocal multiply, matching the fused kernel bit for bit
    scales = tb.abs().amax(dim=1).clamp_min(1e-30) * float(np.float32(1.0 / qmax))
    q = torch.round(tb / scales[:, None]).clamp(-qmax, qmax)
    deq = (q * scales[:, None]).reshape(-1)[:n]
    return deq.to(flat.dtype), (target - deq).to(residual.dtype)
