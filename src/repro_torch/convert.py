"""Move parameters between the reference (JAX) and the port.

``jax.random`` cannot be reproduced in torch, so parity runs draw the
reference's parameters and hand them over. ``params_from_jax`` takes the
reference's parameter pytree as nested dicts of numpy arrays (call
``jax.device_get`` on it first) and returns the same nesting of float32
torch tensors; ``opt_state_from_jax`` does the same for an AdamW state
``{"mu", "nu", "step"}`` (int32 step), so both packages can start from the
same parameters and optimizer state; ``state_from_jax`` moves a model's
state: a snapshot model's recurrent state (GCLSTM's ``(h, c)`` tuple,
T-GCN's one array, the stateless GCN's ``()``) or TGN's ``{"memory",
"last_update"}`` dict (and an LM cache: nested dicts with int32 ``idx``
and ``slot_pos``); ``lm_params_from_jax`` moves the LM's parameters in
the config's ``param_dtype``. Weights keep the reference's
``(d_in, d_out)`` layout, so every public function computes ``x @ w + b``
on both sides and nothing is transposed out of sight.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device="cpu"):
    """Nested dict of numpy arrays -> nested dict of torch tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, dtype=np.float32), device=device)


def params_to_numpy(tree):
    """Inverse of ``params_from_jax``: nested dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def opt_state_from_jax(state, device="cpu"):
    """The reference's AdamW state (numpy leaves) -> the port's: float32
    moment trees and an int32 scalar step."""
    return {"mu": params_from_jax(state["mu"], device),
            "nu": params_from_jax(state["nu"], device),
            "step": torch.as_tensor(np.array(state["step"], dtype=np.int32),
                                    device=device)}


def opt_state_to_numpy(state):
    """Inverse of ``opt_state_from_jax``: numpy moments and step."""
    return {"mu": params_to_numpy(state["mu"]),
            "nu": params_to_numpy(state["nu"]),
            "step": state["step"].detach().cpu().numpy()}


def state_from_jax(state, device="cpu"):
    """A model's state (numpy leaves: ``()``, one array, a tuple of arrays or
    a dict of them) -> the same layout of tensors: float32, and int32 for
    integer leaves (TGN's ``last_update``)."""
    if isinstance(state, dict):
        return {k: state_from_jax(v, device) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return tuple(state_from_jax(s, device) for s in state)
    a = np.asarray(state)
    dtype = np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


def lm_params_from_jax(tree, cfg, device="cpu"):
    """The reference's LM parameters (``M.init``'s pytree, numpy leaves via
    ``jax.device_get``) -> the same nesting of tensors in
    ``cfg.param_dtype``. bfloat16 goes through float32, which is exact both
    ways (``torch.as_tensor`` cannot read ``ml_dtypes.bfloat16`` arrays)."""
    dtype = getattr(torch, cfg.param_dtype)
    if isinstance(tree, dict):
        return {k: lm_params_from_jax(v, cfg, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, dtype=np.float32),
                           device=device).to(dtype)
