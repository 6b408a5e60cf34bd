"""Unified model API of the port: the counterpart of ``repro/models/api.py``
for the ``decoder`` family (``transformer``) and the ``hybrid`` family
(``ssm``, zamba2); the other families are refused.

``get_api(cfg)`` returns a ``ModelAPI`` with the reference's five
functions; ``remat`` ("none" or "full") applies to ``loss``, as in the
reference.  ``init`` takes a seed or a ``torch.Generator`` in place of a
``jax.random`` key, and every function works on ``device`` (``cuda`` unless
the caller asks for the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from . import ssm, transformer


@dataclass(frozen=True)
class ModelAPI:
    init: Callable[..., Any]            # (seed | generator, dtype) -> params
    loss: Callable[..., Any]            # (params, batch) -> (loss, metrics)
    prefill: Callable[..., Any]         # (params, batch, cache) -> (logits, cache)
    decode: Callable[..., Any]          # (params, token, pos, cache) -> (logits, cache)
    init_cache: Callable[..., Any]      # (batch, max_seq, dtype) -> cache


def get_api(cfg: ModelConfig, compute_dtype=torch.bfloat16, device="cuda",
            remat: str = "full") -> ModelAPI:
    # the hybrid goes to ssm; every other family to transformer, which
    # refuses all but the dense decoder
    mod = ssm if cfg.family == "hybrid" else transformer
    mod.check_supported(cfg)
    dev = resolve_device(device)
    window = cfg.sliding_window

    def init(seed, dtype=torch.float32):
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(seed))
        return mod.init_params(cfg, gen, device=dev, dtype=dtype)

    def loss(params, batch):
        return mod.loss_fn(params, batch, cfg, compute_dtype=compute_dtype, remat=remat)

    def prefill(params, batch, cache):
        return mod.prefill(params, batch["tokens"], cfg, cache, compute_dtype=compute_dtype,
                           window=window)

    def decode(params, token, pos, cache):
        return mod.decode_step(params, token, pos, cfg, cache, compute_dtype=compute_dtype,
                               window=window)

    def init_cache(b, s, dtype=torch.bfloat16):
        return mod.init_cache(cfg, b, s, device=dev, dtype=dtype)

    return ModelAPI(init=init, loss=loss, prefill=prefill, decode=decode,
                    init_cache=init_cache)
