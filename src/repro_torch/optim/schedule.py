"""Learning-rate schedules: multiplicative scales for ``AdamWConfig.lr``
(the reference's ``repro.optim.schedule``), float32 tensors."""

from __future__ import annotations

import math

import torch


def constant(step):
    """1.0 at every step (a float32 tensor of the step's shape)."""
    return torch.ones_like(torch.as_tensor(step, dtype=torch.float32))


def warmup_cosine(step, warmup_steps: int, total_steps: int, min_scale: float = 0.1):
    """Linear warm-up from 0 over ``warmup_steps``, then a cosine from 1 down
    to ``min_scale`` at ``total_steps`` (held there after)."""
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = s / max(warmup_steps, 1)
    frac = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_scale + (1.0 - min_scale) * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return torch.where(s < warmup_steps, warm, cos)
