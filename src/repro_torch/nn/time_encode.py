"""Bochner/Time2Vec time encoding ``phi(t) = cos(t * w + b)``."""

from __future__ import annotations

import torch

from repro_torch.nn.init import normal


def time_encode_init(gen, dim: int, device="cpu"):
    """Learnable frequencies and phases, each drawn N(0, 0.1^2). (The fixed
    GraphMixer variant comes with GraphMixer.)"""
    return {"w": normal(gen, (dim,), 0.1, device),
            "b": normal(gen, (dim,), 0.1, device)}


def time_encode(params, dt: torch.Tensor) -> torch.Tensor:
    """dt: (...,) -> (..., dim). Accepts integer or float timestamps."""
    dt = dt.to(torch.float32)
    return torch.cos(dt[..., None] * params["w"] + params["b"])
