"""Dense layers as (init, apply) function pairs over param dicts.

Weights keep the reference's ``(d_in, d_out)`` layout: ``y = x @ w + b``.
"""

from __future__ import annotations

import torch

from repro_torch.nn.init import glorot, normal, zeros


def dense_init(gen, d_in: int, d_out: int, bias: bool = True, device="cpu"):
    """Glorot-normal ``w`` (d_in, d_out) and zero ``b`` (d_out,)."""
    p = {"w": glorot(gen, (d_in, d_out), device)}
    if bias:
        p["b"] = zeros(gen, (d_out,), device)
    return p


def dense(params, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` over the last axis."""
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


def embedding_init(gen, num: int, dim: int, device="cpu"):
    """An N(0, 0.02^2) ``table`` (num, dim)."""
    return {"table": normal(gen, (num, dim), 0.02, device)}


def embedding(params, ids: torch.Tensor) -> torch.Tensor:
    """The rows ``ids`` of the table."""
    return params["table"][ids]
