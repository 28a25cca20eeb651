"""Parameter specs: single source of truth for shapes, logical sharding
axes, and initialization of every LM parameter.

The port's counterpart of the reference's ``models/lm/params.py``. A model
module builds a nested dict of ``Spec``; from it we derive

  * ``materialize`` — real initialized parameters, drawn from an explicit
    ``torch.Generator`` with the reference's distributions (``jax.random``
    cannot be reproduced, so parity runs convert the reference's
    parameters with ``convert.lm_params_from_jax`` instead);
  * ``abstract`` — meta-device tensors of the same shapes (no allocation);
  * ``tree_shardings`` — the logical axes of every leaf, kept as data: the
    port places no LM parameter on a mesh yet (DTensor placement by these
    axes belongs to LM training, ROADMAP A6).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Spec:
    """One parameter: shape, logical axis names (one per dimension) and
    initializer (``normal`` with ``scale``, ``fan_in``, ``zeros``,
    ``ones``)."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis names, len == len(shape)
    init: str = "normal"  # normal | zeros | ones | fan_in
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} length mismatch")


def spec_map(fn, specs):
    """Apply ``fn`` to every ``Spec`` of a nested dict, keeping the nesting."""
    if isinstance(specs, dict):
        return {k: spec_map(fn, v) for k, v in specs.items()}
    return fn(specs)


def _leaves(specs):
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in _leaves(v)]
    return [specs]


def materialize(specs, generator: torch.Generator, dtype=torch.float32,
                device=None):
    """Initialize real parameters from a spec tree, leaf by leaf in the
    tree's order, every draw from ``generator`` (which must live on
    ``device``; its device by default): ``normal`` is N(0, 1) * scale,
    ``fan_in`` N(0, 1) / sqrt(shape[-2]) (shape[-1] for a vector), as in
    the reference. Draws are float32, then cast to ``dtype``."""
    device = torch.device(device) if device is not None else generator.device

    def one(spec: Spec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        x = torch.randn(spec.shape, generator=generator, device=device,
                        dtype=torch.float32)
        if spec.init == "fan_in":
            fan = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            x = x / math.sqrt(fan)
        else:
            x = x * spec.scale
        return x.to(dtype)

    return spec_map(one, specs)


def abstract(specs, dtype=torch.float32):
    """Meta-device tensors of every spec's shape and ``dtype``: shapes and
    sizes without allocating (the reference's ``ShapeDtypeStruct`` tree)."""
    return spec_map(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"),
                    specs)


def tree_shardings(specs):
    """The logical axes of every leaf (data only: no mesh on one card)."""
    return spec_map(lambda s: s.axes, specs)


def n_params(specs) -> int:
    """Total number of parameters in a spec tree."""
    return sum(math.prod(s.shape) for s in _leaves(specs))
