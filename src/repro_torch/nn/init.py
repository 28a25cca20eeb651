"""Parameter initializers: the reference's distributions, drawn from an
explicit ``torch.Generator``.

``jax.random`` and torch give different numbers from the same seed, so the
port draws its own weights with the same distributions; parity tests move
the reference's weights in with ``repro_torch.convert.params_from_jax``.
Draws happen on the CPU and are then moved, so a seed gives the same
weights on every device.
"""

from __future__ import annotations

import math

import torch


def _normal(gen, shape, device):
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(device)


def glorot(gen, shape, device="cpu"):
    """Glorot normal: N(0, 2 / (fan_in + fan_out))."""
    fan_in, fan_out = shape[-2], shape[-1]
    return _normal(gen, shape, device) * math.sqrt(2.0 / (fan_in + fan_out))


def lecun(gen, shape, device="cpu"):
    """LeCun normal: N(0, 1 / fan_in), fan_in the second-to-last axis (the
    last for a vector)."""
    fan_in = shape[-2] if len(shape) > 1 else shape[-1]
    return _normal(gen, shape, device) * math.sqrt(1.0 / fan_in)


def normal(gen, shape, stddev=0.02, device="cpu"):
    """N(0, stddev^2)."""
    return _normal(gen, shape, device) * stddev


def zeros(_gen, shape, device="cpu"):
    """All zeros (draws nothing)."""
    return torch.zeros(shape, dtype=torch.float32, device=device)


def ones(_gen, shape, device="cpu"):
    """All ones (draws nothing)."""
    return torch.ones(shape, dtype=torch.float32, device=device)
