"""Learning-rate schedules (warmup + cosine / linear decay): the port of
``repro/optim/schedule.py``, in f32 like the reference."""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig


def make_lr_schedule(tc: TrainConfig, kind: str = "cosine"):
    warm = max(tc.warmup_steps, 1)
    total = max(tc.total_steps, warm + 1)

    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        warm_lr = tc.lr * step / warm
        t = torch.clamp((step - warm) / (total - warm), 0.0, 1.0)
        if kind == "cosine":
            decay = 0.5 * (1.0 + torch.cos(math.pi * t)) * tc.lr
        else:
            decay = (1.0 - t) * tc.lr
        return torch.where(step < warm, warm_lr, decay)

    return lr
