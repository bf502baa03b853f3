"""Learning-rate schedules (the port of ``repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, peak_lr: float, warmup: int, total: int,
                  floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``floor_frac * peak_lr``; a
    float32 0-d tensor on ``step``'s device (the CPU for a Python int)."""
    t = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * (t + 1.0) / max(warmup, 1)  # step 0 must have lr > 0
    prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(t < warmup, warm, cos)
