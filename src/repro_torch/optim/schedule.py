"""LR schedules, ported from ``repro.optim.schedule``: linear warmup +
cosine decay (the LM default), in float32 as the reference computes it.
``step`` is an int or a 0-d tensor; the result is a 0-d float32 tensor
on the step's device (the CPU for an int)."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, peak: float, warmup: int, total: int, floor_frac: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = peak * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def constant(step, *, peak: float, **_) -> torch.Tensor:
    return torch.full((), peak, dtype=torch.float32, device=_f32(step).device)
