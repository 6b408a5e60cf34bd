"""Public kernel wrappers of the port (counterpart of ``repro/kernels/ops.py``)
and their launch counters.

The GQA fold of the reference's ``ops.flash_attention`` and the head fold
of its ``ops.ssd_scan`` live inside the CUDA kernels here: the wrappers
take the model's ``[B, S, H, D]`` / ``[B, S, K, D]`` and ``[B, S, H, P]`` /
``[B, S, N]`` layouts directly.
"""

from __future__ import annotations

from .flash_attention import flash_attention
from .mamba_scan import ssd_scan
from .quant import dequant_add, ef_quantize_bucketize, quantize_blocks
from .rmsnorm import rmsnorm

KERNELS = {"rmsnorm": rmsnorm, "gqa_attention": flash_attention,
           "ef_quantize_bucketize": ef_quantize_bucketize,
           "quantize_blocks": quantize_blocks, "dequant_add": dequant_add,
           "ssd_scan": ssd_scan}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
