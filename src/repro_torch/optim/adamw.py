"""AdamW on nested dicts of tensors (the reference's ``repro.optim.adamw``).

The state mirrors the parameter tree with the reference's keys,
``{"mu": ..., "nu": ..., "step": int32 scalar}``, so it is the checkpoint
layout of both packages. The arithmetic follows the reference: float32
moments, bias corrections computed in float32 from the step count,
``mhat / (sqrt(nhat) + eps)``, decoupled weight decay added to the step.

``adamw_update`` updates the parameters and moments in place (no second
copy of either tree), under ``torch.no_grad()``, with one multi-tensor
launch per elementwise step over all leaves rather than one launch per
leaf, and reads nothing back to the host: the step count stays a device
tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """AdamW hyperparameters (the reference's defaults)."""

    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0


def adamw_init(params):
    """Zero float32 moments shaped like ``params`` and an int32 step of 0,
    on the parameters' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig) -> Tuple[Any, Any]:
    """One AdamW step. Returns ``(params, state)``: the same parameter
    tensors, updated in place, and the state with its moments updated in
    place and a new step tensor. ``params`` and ``grads`` (which mirrors
    them) are float32, as the port's pipelines hold them."""
    step = state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    # Python-scalar bases: float32 powers, with no host-to-device copy.
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)

    # One multi-tensor launch per elementwise step over all leaves (the
    # torch._foreach ops), in the reference's order of operations.
    mul, add, div = torch._foreach_mul, torch._foreach_add, torch._foreach_div
    p, g = tree_leaves(params), tree_leaves(grads)
    mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
    torch._foreach_copy_(mu, add(mul(mu, b1), mul(g, 1.0 - b1)))
    torch._foreach_copy_(nu, add(mul(nu, b2), mul(mul(g, g), 1.0 - b2)))
    delta = div(div(mu, bc1), add(torch._foreach_sqrt(div(nu, bc2)), cfg.eps))
    if cfg.weight_decay:
        delta = add(delta, mul(p, cfg.weight_decay))
    torch._foreach_sub_(p, mul(delta, cfg.lr))
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}
