"""Normalization layers (twin of ``repro.nn.norm``), written as the
reference writes them so they round alike: ``layer_norm`` takes the biased
variance and multiplies by ``1 / sqrt(var + eps)``; ``rms_norm`` computes
its statistic in float32 and casts back to the input's type."""

from __future__ import annotations

import torch


def layer_norm_init(dim: int, device="cpu"):
    """Unit ``scale`` and zero ``bias`` (dim,), float32."""
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device),
            "bias": torch.zeros((dim,), dtype=torch.float32, device=device)}


def layer_norm(params, x, eps: float = 1e-5):
    """``(x - mean) / sqrt(var + eps) * scale + bias`` over the last axis."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    y = (x - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return y * params["scale"] + params["bias"]


def rms_norm_init(dim: int, device="cpu"):
    """Unit ``scale`` (dim,), float32."""
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}


def rms_norm(params, x, eps: float = 1e-6):
    """``x / sqrt(mean(x^2) + eps) * scale``, the statistic in float32."""
    xf = x.to(torch.float32)
    ms = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(ms + eps))
    return (y * params["scale"]).to(x.dtype)
