"""EdgeBank (Poursafaei et al., 2022): non-parametric link-memory baseline.

Unlimited-memory mode: predict 1.0 for any (src, dst) pair observed before
the query time, else 0.0. Implemented with a hashed numpy set for O(1)
batch-vectorized membership tests. A host-only model: the port's copy of
``repro.models.tg.edgebank`` (the online graph service's fallback tier).
"""

from __future__ import annotations

import numpy as np


class EdgeBank:
    """Host memory of observed ``(src, dst)`` pairs with their last time."""

    def __init__(self, num_nodes: int, window: int | None = None):
        """``window``: time-window mode (only edges within the trailing
        window count); ``None`` = unlimited memory (paper default)."""
        self.num_nodes = int(num_nodes)
        self.window = window
        self.reset_state()

    def reset_state(self) -> None:
        """Forget every observed pair."""
        self._seen: dict[int, int] = {}  # key -> last time seen

    def _key(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        return src.astype(np.int64) * self.num_nodes + dst.astype(np.int64)

    def update(self, src: np.ndarray, dst: np.ndarray, t: np.ndarray) -> None:
        """Record each pair (both directions) at its time ``t``."""
        src, dst, t = (np.atleast_1d(np.asarray(a)) for a in (src, dst, t))
        for k, tt in zip(self._key(src, dst).tolist(), t.tolist()):
            self._seen[k] = tt
        # undirected symmetrization (the standard protocol)
        for k, tt in zip(self._key(dst, src).tolist(), t.tolist()):
            self._seen[k] = tt

    # openDG-style online aliases: a live service interleaves single-edge
    # memory updates with link queries, so expose the streaming names too.
    update_memory = update

    def predict(self, src: np.ndarray, dst: np.ndarray, t: np.ndarray) -> np.ndarray:
        """1.0 for each pair seen before (within ``window`` of ``t`` in the
        windowed mode), else 0.0; float32."""
        src, dst, t = (np.atleast_1d(np.asarray(a)) for a in (src, dst, t))
        keys = self._key(src, dst)
        out = np.zeros(len(keys), dtype=np.float32)
        for i, (k, tt) in enumerate(zip(keys.tolist(), t.tolist())):
            last = self._seen.get(k)
            if last is None:
                continue
            if self.window is None or tt - last <= self.window:
                out[i] = 1.0
        return out

    # Streaming alias of :meth:`predict` (openDG ``EdgeBankPredictor`` API).
    predict_link = predict

    def predict_many(self, src: np.ndarray, dst_many: np.ndarray, t: np.ndarray) -> np.ndarray:
        """One-vs-many scoring: dst_many (B, M) -> (B, M)."""
        B, M = dst_many.shape
        flat_src = np.repeat(src, M)
        flat_t = np.repeat(t, M)
        return self.predict(flat_src, dst_many.reshape(-1), flat_t).reshape(B, M)

    def state_dict(self) -> dict[str, np.ndarray]:
        """Canonical checkpoint payload: sorted (key, last-seen-time) arrays.

        Sorting by key makes the layout independent of insertion order, so
        two banks holding the same memory serialize bit-identically.
        """
        keys = np.fromiter(self._seen.keys(), dtype=np.int64, count=len(self._seen))
        times = np.fromiter(self._seen.values(), dtype=np.int64, count=len(self._seen))
        order = np.argsort(keys, kind="stable")
        return {"keys": keys[order], "times": times[order]}

    def load_state_dict(self, state: dict[str, np.ndarray]) -> None:
        """Inverse of :meth:`state_dict`; replaces the current memory."""
        keys = np.asarray(state["keys"], dtype=np.int64)
        times = np.asarray(state["times"], dtype=np.int64)
        self._seen = dict(zip(keys.tolist(), times.tolist()))
