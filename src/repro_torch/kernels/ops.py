"""Public kernel wrappers of the port (counterpart of ``repro/kernels/ops.py``)
and their launch counters.

The GQA fold of the reference's ``ops.flash_attention`` lives inside the
CUDA kernel here: the wrapper takes ``[B, S, H, D]`` / ``[B, S, K, D]``
directly.
"""

from __future__ import annotations

from .flash_attention import flash_attention
from .quant import dequant_add, ef_quantize_bucketize, quantize_blocks
from .rmsnorm import rmsnorm

KERNELS = {"rmsnorm": rmsnorm, "gqa_attention": flash_attention,
           "ef_quantize_bucketize": ef_quantize_bucketize,
           "quantize_blocks": quantize_blocks, "dequant_add": dequant_add}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
