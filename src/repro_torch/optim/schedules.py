"""Learning-rate schedules: pure functions of the step counter, in f32
(the JAX package's `optim/schedules.py`)."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(step, *, warmup: int, total: int,
                       min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup to 1 over ``warmup`` steps, then a cosine down to
    ``min_ratio`` at ``total``; ``step`` a tensor (any shape) or int."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(1.0, warmup), max=1.0)
    prog = torch.clamp((step - warmup) / max(1.0, total - warmup), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos


def constant(step, **_) -> torch.Tensor:
    """1 at every step."""
    return torch.ones_like(torch.as_tensor(step), dtype=torch.float32)
