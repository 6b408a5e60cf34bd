"""PyTorch/CUDA port of the JAX package ``repro`` (the reference).

The port imports ``torch`` and nothing of ``jax`` or ``repro``: where it
needs a module of the reference (configs, for example) it keeps its own
copy.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
version, on the card it launches the hand-written CUDA kernel.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on; raises rather than fall back to
    the CPU when the card was asked for and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev
