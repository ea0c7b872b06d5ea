"""LR schedules (counterpart of ``repro.optim.schedules``): each returns a
float32 multiplier on the base LR, on the device of ``step`` when it is a
tensor."""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def linear_warmup(step, warmup_steps: int) -> torch.Tensor:
    s = torch.as_tensor(step, dtype=F32)
    return torch.clamp((s + 1.0) / max(warmup_steps, 1), max=1.0)


def cosine_schedule(step, total_steps: int, warmup_steps: int = 0,
                    final_frac: float = 0.1) -> torch.Tensor:
    s = torch.as_tensor(step, dtype=F32)
    warm = linear_warmup(step, warmup_steps)
    frac = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_frac + (1.0 - final_frac) * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return warm * cos
