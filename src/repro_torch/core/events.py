"""Event types: the fundamental unit of a temporal graph (paper Def. 3.1).

An *edge event* ``(t, src, dst, x_edge)`` is a timestamped interaction; a
*node event* ``(t, node, x_node)`` is the arrival of new features at a node.
Storage keeps events in struct-of-arrays COO form (see ``graph.py``); these
dataclasses are the scalar views used at API boundaries and in tests. The
port's copy of ``repro.core.events``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class EdgeEvent:
    t: int
    src: int
    dst: int
    features: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class NodeEvent:
    t: int
    node: int
    features: Optional[np.ndarray] = None
