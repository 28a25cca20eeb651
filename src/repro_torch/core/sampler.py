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
and give the same neighborhoods.

``UniformSampler`` draws K neighbors uniformly (with replacement) from each
seed's strict past over a CSR-by-time adjacency built once per stream, with
numpy draws from ``default_rng((seed, counter))``: bit-equal to the
reference's host sampler. ``csr_from_state`` reads the uniform samplers'
shared checkpoint contract; the device twin is
``core.device_uniform.DeviceUniformSampler``.
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


def csr_from_state(state: dict, num_nodes: int):
    """Rebuild ``(nodes, nbrs, times, eids)`` int64 arrays from the shared
    uniform-sampler checkpoint contract (``adj_nbr/adj_t/adj_e/indptr``).
    The node column is implicit in ``indptr`` (node-major layout). Used by
    both uniform samplers, so the contract cannot diverge between them."""
    indptr = np.asarray(state["indptr"], dtype=np.int64)
    nodes = np.repeat(np.arange(num_nodes, dtype=np.int64), np.diff(indptr))
    return (nodes,
            np.asarray(state["adj_nbr"], dtype=np.int64),
            np.asarray(state["adj_t"], dtype=np.int64),
            np.asarray(state["adj_e"], dtype=np.int64))


def doubled_edges(src, dst, t, eids=None):
    """Both directions of every event as int64 ``(nodes, nbrs, times,
    eids)``: event i gives (src_i -> dst_i) at i and (dst_i -> src_i) at
    E + i. ``eids`` defaults to the event index."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    eids = (np.arange(len(src), dtype=np.int64) if eids is None
            else np.asarray(eids, dtype=np.int64))
    return (np.concatenate([src, dst]), np.concatenate([dst, src]),
            np.concatenate([t, t]), np.concatenate([eids, eids]))


class UniformSampler:
    """Uniform temporal neighbor sampling over *all* past neighbors.

    Built over a static CSR-by-time adjacency of an edge stream (strict
    ``t < query_t`` filtering at sample time keeps it leak-free even when
    built over the full stream); per query, the seed's prefix of neighbors
    with t < query_t comes from one global binary search on a composite
    ``(node, time rank)`` key, and K draws are taken uniformly from it (with
    replacement). Draws use ``default_rng((seed, counter))`` per call, so
    epochs replay exactly after ``reset_state``. ``build_from_store`` builds
    the same adjacency from an ``EventStore`` by the streaming two-pass CSR.
    """

    def __init__(self, num_nodes: int, k: int, seed: int = 0,
                 checkpoint_adjacency: bool = True):
        self.num_nodes = int(num_nodes)
        self.k = int(k)
        self._seed = seed
        self._counter = 0
        self._built = False
        self.checkpoint_adjacency = bool(checkpoint_adjacency)

    def build(self, src, dst, t, eids: Optional[np.ndarray] = None) -> None:
        """Build the CSR-by-time adjacency (both directions per event)."""
        nodes, nbrs, times, es = doubled_edges(src, dst, t, eids)
        order = np.lexsort((times, nodes))  # by node, then time
        self._set_adjacency(nodes[order], nbrs[order], times[order], es[order])

    def build_from_store(self, store, chunk_size: int = 1 << 20,
                         scratch_dir: Optional[str] = None) -> None:
        """Build the adjacency from an ``EventStore`` without materializing
        the doubled edge list: ``repro_torch.storage.streaming_csr`` (degree
        count, then chunked fill at per-node cursors) walks the stream in
        O(chunk)-resident windows; ``scratch_dir`` parks the O(E) adjacency
        arrays on disk. Same layout as ``build`` (bit-identical whenever no
        two distinct events share a ``(node, timestamp)`` pair; see
        ``repro_torch/storage/csr.py``)."""
        from repro_torch.storage.csr import streaming_csr

        csr = streaming_csr(store, num_nodes=self.num_nodes,
                            chunk_size=chunk_size, scratch_dir=scratch_dir,
                            with_keys=False)
        self._set_adjacency(*csr_from_state(csr, self.num_nodes))

    def _set_adjacency(self, nodes, nbrs, times, es) -> None:
        """Install a node-major, time-ascending adjacency and derive the
        search structures (unique-time table and composite key)."""
        self._adj_nbr = nbrs
        self._adj_t = times
        self._adj_e = es
        counts = np.bincount(nodes, minlength=self.num_nodes)
        self._indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        # Ranking times through the unique-value table keeps the key range
        # at num_nodes * (#distinct times + 1); the key is globally sorted
        # because the adjacency is node-major with times ascending.
        self._tvals = np.unique(self._adj_t)
        self._key_base = len(self._tvals) + 1
        tranks = np.searchsorted(self._tvals, self._adj_t)
        self._adj_key = nodes * self._key_base + tranks
        self._built = True

    def reset_state(self) -> None:
        """Rewind the draw counter (start of an epoch); the adjacency is a
        pure function of the stream and is kept."""
        self._counter = 0

    def prefix(self, seeds, query_t):
        """``(starts, n_valid)`` (B,) int64: where each seed's adjacency run
        starts and how many of its entries lie strictly before
        ``query_t``. Duplicate ``(seed, query_t)`` pairs (the whole hop-2
        frontier of a one-vs-many eval batch) are searched once: the
        binary search runs on the unique keys and is gathered back."""
        if not self._built:
            raise RuntimeError("UniformSampler.build() must be called first")
        seeds = np.asarray(seeds, dtype=np.int64)
        query_t = np.asarray(query_t, dtype=np.int64)
        starts = self._indptr[seeds]
        qranks = np.searchsorted(self._tvals, query_t, side="left")
        keys = seeds * self._key_base + qranks
        uniq_keys, inverse = np.unique(keys, return_inverse=True)
        ends = np.searchsorted(self._adj_key, uniq_keys,
                               side="left")[inverse.reshape(keys.shape)]
        return starts, ends - starts

    def sample(self, seeds, query_t) -> NeighborBlock:
        """Draw K uniform neighbors per seed, strictly before ``query_t``
        (one counter step). Seeds with no past neighbor come back fully
        masked: ids/eids -1, times 0."""
        starts, n_valid = self.prefix(seeds, query_t)
        B, K = len(starts), self.k
        has = n_valid > 0
        rng = np.random.default_rng((self._seed, self._counter))
        self._counter += 1
        draw = rng.integers(0, np.maximum(n_valid, 1)[:, None], size=(B, K))
        idx = np.minimum(starts[:, None] + draw, len(self._adj_nbr) - 1)
        ids = np.where(has[:, None], self._adj_nbr[idx], -1)
        times = np.where(has[:, None], self._adj_t[idx], 0)
        eids = np.where(has[:, None], self._adj_e[idx], -1)
        mask = np.broadcast_to(has[:, None], (B, K)).copy()
        return NeighborBlock(ids, times, eids, mask)

    # -- checkpoint contract (shared with DeviceUniformSampler) ----------
    def state_dict(self) -> dict:
        """CSR arrays and the draw counter; loads into either uniform
        sampler (of either package). With ``checkpoint_adjacency=False`` only
        the counter is saved: the restoring side rebuilds the adjacency from
        the stream with ``build``."""
        if not self._built or not self.checkpoint_adjacency:
            return {"counter": np.int64(self._counter)}
        return {
            "adj_nbr": self._adj_nbr, "adj_t": self._adj_t,
            "adj_e": self._adj_e, "indptr": self._indptr,
            "counter": np.int64(self._counter),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore from either uniform sampler's ``state_dict``. Counter-only
        states keep (or await) an adjacency built from the stream."""
        self._counter = int(state["counter"])
        if "adj_nbr" not in state:
            return
        self._set_adjacency(*csr_from_state(state, self.num_nodes))
