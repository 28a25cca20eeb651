"""Gradient clipping by the global norm (the reference's
``repro.optim.clip``)."""

from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def global_norm(tree):
    """The float32 L2 norm over every leaf of ``tree`` (a 0-d tensor): each
    leaf's sum of squares in float32, the sums added in leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float):
    """``(tree scaled by min(1, max_norm / max(norm, 1e-9)), norm)``: each
    leaf scaled in float32 and cast back to its dtype, as the reference
    does; new tensors, the tree is not modified."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm
