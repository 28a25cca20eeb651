"""Persistent Forecast: predict the most recent observation, unchanged.

For node property prediction, the forecast for node u at time t is the last
observed label vector of u; for link prediction it reduces to EdgeBank with
unlimited memory. Strong baseline per the paper (Tables 4/12). Host numpy,
a copy of ``repro.models.tg.persistent`` (the node pipeline's ``pf`` keeps
its own forecast, as the reference's does).
"""

from __future__ import annotations

import numpy as np


class PersistentForecast:
    """Per-node memory of the last observed label vector (zeros until a
    node is seen)."""

    def __init__(self, num_nodes: int, label_dim: int):
        self.num_nodes = int(num_nodes)
        self.label_dim = int(label_dim)
        self.reset_state()

    def reset_state(self) -> None:
        """Forget every observation."""
        self._last = np.zeros((self.num_nodes, self.label_dim), dtype=np.float32)
        self._seen = np.zeros(self.num_nodes, dtype=bool)

    def update(self, nodes: np.ndarray, labels: np.ndarray) -> None:
        """Record ``labels`` (one row per node) as the nodes' latest."""
        self._last[nodes] = labels
        self._seen[nodes] = True

    def predict(self, nodes: np.ndarray) -> np.ndarray:
        """The nodes' last observed label vectors."""
        return self._last[nodes]
