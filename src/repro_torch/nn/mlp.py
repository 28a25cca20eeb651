"""MLP blocks."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.linear import dense, dense_init


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation (PyTorch's exact
    default would miss the float32 tolerance against the reference)."""
    return F.gelu(x, approximate="tanh")


def mlp_init(gen, dims, bias: bool = True, device="cpu"):
    """dims = [d_in, h1, ..., d_out]."""
    return {
        f"layer_{i}": dense_init(gen, dims[i], dims[i + 1], bias, device)
        for i in range(len(dims) - 1)
    }


def mlp(params, x, act=torch.relu, final_act=None):
    """Dense layers with ``act`` between them (and ``final_act`` after)."""
    n = len(params)
    for i in range(n):
        x = dense(params[f"layer_{i}"], x)
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x
