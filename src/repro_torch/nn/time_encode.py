"""Bochner/Time2Vec time encoding ``phi(t) = cos(t * w + b)``.

Learnable frequencies (TGAT, TGN, DyGFormer) or GraphMixer's fixed
log-spaced ones, ``w_i = 10^(-4 i / dim)`` and ``b = 0``. The fixed arrays
are ordinary entries of the parameter tree, as in the reference: they get
gradients and the optimizer moves them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.nn.init import normal


def time_encode_init(gen, dim: int, device="cpu", learnable: bool = True):
    """Learnable frequencies and phases, each drawn N(0, 0.1^2); with
    ``learnable=False`` the fixed variant (draws nothing), computed in
    float64 and rounded to float32 as the reference does."""
    if learnable:
        return {"w": normal(gen, (dim,), 0.1, device),
                "b": normal(gen, (dim,), 0.1, device)}
    w = 1.0 / np.power(10.0, np.arange(dim) * 4.0 / dim)
    return {"w": torch.as_tensor(w.astype(np.float32), device=device),
            "b": torch.zeros((dim,), dtype=torch.float32, device=device)}


def time_encode(params, dt: torch.Tensor) -> torch.Tensor:
    """dt: (...,) -> (..., dim). Accepts integer or float timestamps."""
    dt = dt.to(torch.float32)
    return torch.cos(dt[..., None] * params["w"] + params["b"])
