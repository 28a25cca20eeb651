"""Temporal neighbor samplers on the host, and the ``NeighborBlock``.

Numpy copy of the recency half of ``repro.core.sampler`` (bit-equal):
``RecencySampler`` keeps, per node, a fixed-size circular buffer of the K
most recent neighbor interactions; a batch insert touches O(B) slots with
vectorized scatters (a stable sort by node gives each node's events their
slots in order, so duplicates and equal timestamps land exactly as
sequential insertion puts them), and a lookup is one gather.
``SequentialRecencySampler`` is the per-event loop it is held against.

The device twin, ``core.device_sampler.DeviceRecencySampler``, keeps the same
buffers on the card; the two share the ``state_dict`` checkpoint contract
and give the same neighborhoods. ``UniformSampler`` and ``csr_from_state``
come with the uniform slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass
class NeighborBlock:
    """Fixed-shape neighborhood of a set of seed nodes at query times.

    ``nbr_ids[i, k]``   : k-th sampled neighbor of seed i (-1 = padding)
    ``nbr_times[i, k]`` : interaction timestamp (0 where padded)
    ``nbr_eids[i, k]``  : edge-event index into storage (-1 where padded)
    ``mask[i, k]``      : True where a real neighbor is present

    The host sampler fills it with int64 and bool numpy arrays; the device
    sampler with int32 and bool torch tensors on its device.
    """

    nbr_ids: Any
    nbr_times: Any
    nbr_eids: Any
    mask: Any


class RecencySampler:
    """Vectorized most-recent-K temporal neighbor sampler (circular buffer).

    State: three ``(num_nodes, K)`` int64 arrays (neighbor id, time, edge
    id) plus ``(num_nodes,)`` write cursor and fill count. The buffer is
    undirected by default (each edge inserts dst into src's buffer and vice
    versa).
    """

    def __init__(self, num_nodes: int, k: int, directed: bool = False):
        if k <= 0:
            raise ValueError("k must be positive")
        self.num_nodes = int(num_nodes)
        self.k = int(k)
        self.directed = directed
        self.reset_state()

    def reset_state(self) -> None:
        """Clear buffers: ids/eids -1, times 0, cursor/count 0."""
        n, k = self.num_nodes, self.k
        self._ids = np.full((n, k), -1, dtype=np.int64)
        self._times = np.zeros((n, k), dtype=np.int64)
        self._eids = np.full((n, k), -1, dtype=np.int64)
        self._cursor = np.zeros(n, dtype=np.int64)
        self._count = np.zeros(n, dtype=np.int64)

    def update(self, src: np.ndarray, dst: np.ndarray, t: np.ndarray,
               eids: Optional[np.ndarray] = None) -> None:
        """Insert a time-sorted batch of edges.

        For node u appearing m times in the batch, its m insertions are
        placed at slots ``cursor[u] + 0..m-1 (mod K)`` in chronological
        order — identical to sequential insertion.
        """
        if eids is None:
            eids = np.full(len(src), -1, dtype=np.int64)
        if self.directed:
            nodes = np.asarray(src, dtype=np.int64)
            nbrs = np.asarray(dst, dtype=np.int64)
            times = np.asarray(t, dtype=np.int64)
            es = np.asarray(eids, dtype=np.int64)
        else:
            # Interleave src/dst copies (event i -> positions 2i, 2i+1) so
            # the stable sort by node below keeps exact event order.
            B = len(src)
            nodes = np.empty(2 * B, dtype=np.int64)
            nbrs = np.empty(2 * B, dtype=np.int64)
            times = np.empty(2 * B, dtype=np.int64)
            es = np.empty(2 * B, dtype=np.int64)
            nodes[0::2], nodes[1::2] = src, dst
            nbrs[0::2], nbrs[1::2] = dst, src
            times[0::2], times[1::2] = t, t
            es[0::2], es[1::2] = eids, eids

        order = np.argsort(nodes, kind="stable")
        sn, sb, st, se = nodes[order], nbrs[order], times[order], es[order]
        if len(sn) == 0:
            return
        group_start = np.empty(len(sn), dtype=bool)
        group_start[0] = True
        group_start[1:] = sn[1:] != sn[:-1]
        gidx = np.cumsum(group_start) - 1
        first_pos = np.flatnonzero(group_start)
        seq = np.arange(len(sn)) - first_pos[gidx]  # rank within the node

        slots = (self._cursor[sn] + seq) % self.k
        self._ids[sn, slots] = sb
        self._times[sn, slots] = st
        self._eids[sn, slots] = se

        uniq = sn[group_start]
        counts = np.diff(np.concatenate([first_pos, [len(sn)]]))
        self._cursor[uniq] = (self._cursor[uniq] + counts) % self.k
        self._count[uniq] = np.minimum(self._count[uniq] + counts, self.k)

    def sample(self, seeds: np.ndarray,
               query_t: Optional[np.ndarray] = None) -> NeighborBlock:
        """Gather the (up to) K most recent neighbors of each seed, most
        recent first. ``query_t``, when given, also masks any neighbor with
        time > query_t (the buffer only ever holds past events)."""
        seeds = np.asarray(seeds, dtype=np.int64)
        cur = self._cursor[seeds]
        offs = np.arange(1, self.k + 1)[None, :]
        slots = (cur[:, None] - offs) % self.k  # most recent first
        rows = seeds[:, None]
        ids = self._ids[rows, slots]
        times = self._times[rows, slots]
        eids = self._eids[rows, slots]
        mask = np.arange(self.k)[None, :] < self._count[seeds][:, None]
        if query_t is not None:
            mask = mask & (times <= np.asarray(query_t, dtype=np.int64)[:, None])
        ids = np.where(mask, ids, -1)
        times = np.where(mask, times, 0)
        eids = np.where(mask, eids, -1)
        return NeighborBlock(ids, times, eids, mask)

    def state_dict(self) -> dict:
        """Canonical ``{ids, times, eids, cursor, count}`` numpy state —
        loads into either recency sampler (host or device)."""
        return {
            "ids": self._ids, "times": self._times, "eids": self._eids,
            "cursor": self._cursor, "count": self._count,
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore buffers saved by either recency sampler (of either
        package)."""
        self._ids = np.array(state["ids"], dtype=np.int64)
        self._times = np.array(state["times"], dtype=np.int64)
        self._eids = np.array(state["eids"], dtype=np.int64)
        self._cursor = np.array(state["cursor"], dtype=np.int64)
        self._count = np.array(state["count"], dtype=np.int64)


class SequentialRecencySampler(RecencySampler):
    """Per-event Python loop: the oracle ``RecencySampler`` is held to."""

    def update(self, src, dst, t, eids=None) -> None:
        if eids is None:
            eids = np.full(len(src), -1, dtype=np.int64)

        def _insert(u: int, v: int, tt: int, e: int) -> None:
            c = int(self._cursor[u])
            self._ids[u, c] = v
            self._times[u, c] = tt
            self._eids[u, c] = e
            self._cursor[u] = (c + 1) % self.k
            self._count[u] = min(self._count[u] + 1, self.k)

        for i in range(len(src)):
            _insert(int(src[i]), int(dst[i]), int(t[i]), int(eids[i]))
            if not self.directed:
                _insert(int(dst[i]), int(src[i]), int(t[i]), int(eids[i]))
