"""``InMemoryStore`` — the host-numpy ``EventStore`` backend.

Wraps today's in-RAM columnar arrays behind the storage contract with zero
behavior change: construction applies the exact ``DGData.from_arrays``
normalization (int64/float32 casts, stable sort by timestamp), and
``InMemoryStore.from_data`` aliases an existing ``DGData``'s columns
without copying — so a pipeline run off this backend is bit-identical to
one run off the raw arrays. It doubles as the parity oracle for
``MmapStore`` in ``tests/test_torch_storage.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.granularity import TimeDelta
from repro_torch.storage.base import EventStore


class InMemoryStore(EventStore):
    """Host-numpy event storage (the bit-identical default backend)."""

    def __init__(self, src, dst, t, edge_feats=None, node_ids=None,
                 node_t=None, node_feats=None, static_node_feats=None,
                 granularity: TimeDelta | str = "s",
                 num_nodes: Optional[int] = None):
        from repro_torch.core.graph import DGData

        data = DGData.from_arrays(
            src, dst, t, edge_feats=edge_feats, node_ids=node_ids,
            node_t=node_t, node_feats=node_feats,
            static_node_feats=static_node_feats, granularity=granularity,
            num_nodes=num_nodes,
        )
        self._init_from(data)

    def _init_from(self, data) -> None:
        self.src = data.src
        self.dst = data.dst
        self.edge_t = data.edge_t
        self.edge_feats = data.edge_feats
        self.node_ids = data.node_ids
        self.node_t = data.node_t
        self.node_feats = data.node_feats
        self.static_node_feats = data.static_node_feats
        self.num_nodes = int(data.num_nodes)
        self.granularity = data.granularity
        self._eids = None

    @classmethod
    def from_data(cls, data) -> "InMemoryStore":
        """Alias a ``DGData``'s (already sorted) columns — no copy."""
        self = cls.__new__(cls)
        self._init_from(data)
        return self

    def __repr__(self) -> str:  # pragma: no cover
        return (f"InMemoryStore(edges={self.num_edge_events}, "
                f"nodes={self.num_nodes}, d_edge={self.edge_feat_dim})")
