"""Gradient compression around the data-parallel all-reduce.

Port of ``repro.distributed.compression`` on nested dicts of tensors:

  * ``bf16``: gradients cast to bfloat16 before the reduce (no state);
  * ``int8_ef``: per-tensor symmetric int8 quantization of (gradient +
    error), the residual carried to the next step (error feedback).

``psum_compressed`` reduces over a process group with ``all_reduce`` where
the reference ``psum``s over an axis, and decompresses to the float32 mean:
int8 payloads are summed as int32 and the scales averaged, as there.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import all_reduce_tree
from repro_torch.tree import tree_map


def zeros_like_error(params):
    """A zero float32 error-feedback tree shaped like ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: int8 ``round(x / scale)`` clipped to [-127, 127],
    ``scale = (max|x| + 1e-12) / 127`` (a float32 scalar tensor)."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q * scale`` in float32."""
    return q.to(torch.float32) * scale


def compress_grads(grads, error, scheme: str):
    """``(wire, new_error, None)``: ``wire`` is what ``psum_compressed``
    reduces (for ``int8_ef`` the pair of trees ``(q, scales)``)."""
    if scheme == "none":
        return grads, error, None
    if scheme == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), grads), error, None
    if scheme == "int8_ef":
        target = tree_map(lambda g, e: g.to(torch.float32) + e, grads, error)
        qs = tree_map(quantize_int8, target)
        q = tree_map(lambda qs_: qs_[0], qs)
        s = tree_map(lambda qs_: qs_[1], qs)
        new_e = tree_map(lambda t, q_, s_: t - dequantize_int8(q_, s_),
                         target, q, s)
        return (q, s), new_e, None
    raise ValueError(f"unknown compression scheme {scheme!r}")


def psum_compressed(wire, scheme: str, group):
    """All-reduce the compressed representation over ``group`` and
    decompress to the float32 mean over its ranks."""
    n = dist.get_world_size(group)
    if scheme == "none":
        return tree_map(lambda g: g / n, all_reduce_tree(wire, group))
    if scheme == "bf16":
        wide = tree_map(lambda g: g.to(torch.float32), wire)
        return tree_map(lambda g: g / n, all_reduce_tree(wide, group))
    if scheme == "int8_ef":
        qs, scales = wire
        red_q = all_reduce_tree(tree_map(lambda q: q.to(torch.int32), qs),
                                group)
        red_s = tree_map(lambda s: s / n,
                         all_reduce_tree(tree_map(lambda s: s.reshape(()), scales),
                                         group))
        return tree_map(lambda q, s: q.to(torch.float32) * s / n, red_q, red_s)
    raise ValueError(f"unknown compression scheme {scheme!r}")
