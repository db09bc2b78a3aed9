"""LR schedules (the twin of ``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, base_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``base_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_ratio * base_lr`` at ``total_steps``, held there after.
    ``step``: an int or a 0-d tensor. Returns a 0-d f32 tensor (on
    ``step``'s device), computed in f32 as the reference computes it."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = base_lr * step / max(warmup_steps, 1)
    progress = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                           0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                     (1.0 + torch.cos(math.pi * progress)))
    return torch.where(step < warmup_steps, warm, cos)
