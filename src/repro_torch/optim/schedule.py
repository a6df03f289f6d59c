"""Learning-rate schedules: pure functions of the step.

A port of ``repro.optim.schedule``.  Each schedule takes the step as an
integer tensor (on the card in a train step) and returns a float32 tensor
on the same device, so a step reads its learning rate without a host sync.
"""
from __future__ import annotations

import math

import torch


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def constant_schedule(lr: float):
    return lambda step: _f32(lr, step)


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        frac = torch.clamp(step.float() / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return lr * (final_frac + (1 - final_frac) * cos)

    return fn


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int, final_frac: float = 0.1):
    cos = cosine_schedule(lr, max(total_steps - warmup, 1), final_frac)

    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = lr * torch.clamp(s / max(warmup, 1), max=1.0)
        return torch.where(s < warmup, warm, cos(step - warmup))

    return fn
