"""LR schedules (plain callables step -> lr) — counterpart of
:mod:`repro.optim.schedule`.

The step is a 0-d tensor and the arithmetic is float32 tensor arithmetic,
as in JAX.  The divisors are tensors on the step's device: CUDA divides by
a CPU scalar as a product with its reciprocal, which can round the other
way.
"""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32, device=like.device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    def f(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * step / _f32(max(warmup_steps, 1), step)
        frac = torch.clamp((step - warmup_steps) / _f32(max(total_steps - warmup_steps, 1), step),
                           0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return f


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32, device=step.device)
