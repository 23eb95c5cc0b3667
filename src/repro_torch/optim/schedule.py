"""Learning-rate schedules: the port's copy of ``repro/optim/schedule.py``.
A schedule takes the optimizer's step (an int32 tensor, or an int) and
returns the rate as a float32 tensor on the step's device."""
from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def lr(step):
        frac = torch.clamp(torch.as_tensor(step) / max(1, total_steps),
                           0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return base_lr * (min_frac + (1 - min_frac) * cos)
    return lr


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         min_frac: float = 0.1):
    """Linear from 0 over ``warmup`` steps, then cosine down to
    ``min_frac`` of ``base_lr``. Step 0 has rate 0 (the train step reads
    the schedule before it counts the step, as the reference does)."""
    cos = cosine_schedule(base_lr, max(1, total_steps - warmup), min_frac)

    def lr(step):
        step = torch.as_tensor(step)
        w = torch.clamp(step / max(1, warmup), 0.0, 1.0)
        return torch.where(step < warmup, base_lr * w, cos(step - warmup))
    return lr
