"""Plain PyTorch segment sum: the version the CPU runs and the card's
kernel is held against."""

from __future__ import annotations

import torch


def segment_sum_ref(data, seg_ids, num_segments: int):
    """data: (E, D); seg_ids: (E,) int, any order -> (num_segments, D)
    float32. Rows whose id lies outside ``[0, num_segments)`` (the padding
    id -1) are dropped, as ``jax.ops.segment_sum`` drops them: they go to
    one sink row past the end, which is sliced off. On the CPU each sum runs
    in edge order, as the CUDA kernel's does; differentiable in ``data``
    (autograd of ``index_add_`` is the gather of the output's gradient)."""
    G = int(num_segments)
    ids = seg_ids.long()
    keep = (ids >= 0) & (ids < G)
    out = torch.zeros((G + 1,) + tuple(data.shape[1:]), dtype=torch.float32,
                      device=data.device)
    return out.index_add_(0, torch.where(keep, ids, G),
                          data.to(torch.float32))[:G]
