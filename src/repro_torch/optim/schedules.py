"""LR schedules: functions of the int32 step counter (PyTorch port of
`repro.optim.schedules`).  The arithmetic is the reference's in float32,
as jnp promotes an int32 step against Python scalars: `step / n` is a
float32 division, and every Python constant enters as a float32."""

from __future__ import annotations

import math

import torch


def linear_warmup(base_lr: float, warmup_steps: int):
    def f(step: torch.Tensor) -> torch.Tensor:
        frac = torch.clamp(step / max(warmup_steps, 1), max=1.0)
        return base_lr * frac
    return f


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_frac: float = 0.1):
    def f(step: torch.Tensor) -> torch.Tensor:
        warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi
                                                               * prog))
        return base_lr * warm * cos
    return f
