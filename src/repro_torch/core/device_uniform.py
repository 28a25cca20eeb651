"""Device-resident uniform temporal neighbor sampling in PyTorch (single
device).

``DeviceUniformSampler`` is the twin of the host ``UniformSampler``
(``core.sampler``): the CSR-by-time adjacency lives on the device, built by
one stable sort of the doubled edge list on the composite key
``node * (#distinct times + 1) + rank(t)`` with per-node extents from a
``bincount``; a query's count of neighbors strictly before ``query_t`` is
``searchsorted(keys, seed * base + rank(query_t)) - indptr[seed]``, one
vectorized search for the whole seed batch (every query searched, the
reference device sampler's form: the host sampler's ``np.unique`` dedup of
the hop-2 frontier is a host saving), and K draws per seed are taken
uniformly with replacement from that prefix.

Where it differs from the reference's device twin
(``repro.core.device_uniform``), and why:

* the composite key is int64. The reference builds it in int32 and refuses
  a graph whose ``num_nodes * base`` reaches 2^31 (full-scale wikipedia
  comes to ~1.4e9; reddit can pass it); here the key cannot overflow, so
  the CSR is bit-equal to the host sampler's for any stream, and the
  device and host samplers give the same valid-prefix lengths and masks;
* the draws cannot reproduce ``jax.random.randint`` under ``fold_in``: they
  come from a ``torch.Generator`` on the sampler's device, seeded per call
  from ``(seed, counter)`` through numpy's ``SeedSequence``, so an epoch
  replays exactly after ``reset_state`` or a checkpoint restore. A draw is
  ``r mod n_valid`` for a 62-bit uniform ``r`` (bias below 2^-31 for any
  prefix that fits int32).

The ``state_dict`` contract (``adj_nbr/adj_t/adj_e/indptr/counter``, host
int64) is the host sampler's, so either sampler loads the other's state.
Neighbor tensors come back int32 (bool mask) on the sampler's device.
``build_from_store`` places the streaming CSR of an ``EventStore``
(``repro_torch.storage.streaming_csr``) as it is, int64 key included, so it
takes every graph ``build`` takes (the reference's refuses one whose key
passes int32). The mesh-sharded form waits for the multi-GPU slice
(ROADMAP A5).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.device_sampler import as_int32
from repro_torch.core.sampler import NeighborBlock, csr_from_state, doubled_edges
from repro_torch.device import resolve_device

_DRAW_HIGH = 1 << 62


def draw_seed(seed: int, counter: int) -> int:
    """The generator seed of draw call ``counter``: a 63-bit integer mixed
    from ``(seed, counter)`` by numpy's ``SeedSequence``."""
    words = np.random.SeedSequence([int(seed), int(counter)]).generate_state(
        2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def build_csr(nodes, nbrs, times, eids, num_nodes: int) -> dict:
    """Sort a doubled edge list (device tensors) into node-major,
    time-ascending CSR order: a stable sort on the int64 composite key
    keeps stream order on exact ``(node, time)`` ties, the layout numpy's
    ``lexsort((times, nodes))`` gives on the host."""
    nodes = nodes.long()
    times64 = times.long()
    tvals = torch.unique(times64)  # sorted
    base = tvals.numel() + 1
    key = nodes * base + torch.searchsorted(tvals, times64)
    key, order = torch.sort(key, stable=True)
    counts = torch.bincount(nodes, minlength=num_nodes)
    indptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=key.device),
                        torch.cumsum(counts, 0)])
    return {"adj_nbr": nbrs[order].to(torch.int32),
            "adj_t": times[order].to(torch.int32),
            "adj_e": eids[order].to(torch.int32),
            "adj_key": key, "indptr": indptr, "tvals": tvals, "base": base}


class DeviceUniformSampler:
    """PyTorch device-resident uniform temporal neighbor sampler.

    Drop-in twin of ``UniformSampler``: ``build`` once per stream, then
    ``sample(seeds, query_t)`` draws K past neighbors per seed uniformly
    with replacement, on ``device``.
    """

    def __init__(self, num_nodes: int, k: int, seed: int = 0, device="cuda",
                 checkpoint_adjacency: bool = True):
        if k <= 0:
            raise ValueError("k must be positive")
        self.num_nodes = int(num_nodes)
        self.k = int(k)
        self._seed = int(seed)
        self._counter = 0
        self._adj = None
        self._gen = None
        self.checkpoint_adjacency = bool(checkpoint_adjacency)
        self.device = resolve_device(device)

    @property
    def _built(self) -> bool:
        return self._adj is not None

    def build(self, src, dst, t, eids: Optional[np.ndarray] = None) -> None:
        """Build the device CSR-by-time adjacency of an edge stream (both
        directions per event; ``eids`` defaults to the event index)."""
        nodes, nbrs, times, es = doubled_edges(src, dst, t, eids)
        self._install(nodes, nbrs, times, es)

    def build_from_store(self, store, chunk_size: int = 1 << 20,
                         scratch_dir: Optional[str] = None) -> None:
        """Build the device CSR from an ``EventStore`` by the streaming
        two-pass build (``repro_torch.storage.streaming_csr``: O(chunk) host
        memory beyond the adjacency, which ``scratch_dir`` parks in
        disk-backed memmaps). The host arrays are already sorted, so they
        are placed on the device without the device sort; ids, times and
        edge ids are narrowed to int32 with the range check of ``build``,
        the composite key stays int64. Same layout as ``build`` whenever no
        two distinct events share a ``(node, timestamp)`` pair
        (``repro_torch/storage/csr.py``)."""
        from repro_torch.storage.csr import streaming_csr

        csr = streaming_csr(store, num_nodes=self.num_nodes,
                            chunk_size=chunk_size, scratch_dir=scratch_dir)
        dev = self.device
        i64 = lambda a: torch.tensor(np.asarray(a, np.int64), device=dev)  # noqa: E731
        self._adj = {
            "adj_nbr": as_int32(csr["adj_nbr"], "adj_nbr", dev),
            "adj_t": as_int32(csr["adj_t"], "adj_t", dev),
            "adj_e": as_int32(csr["adj_e"], "adj_e", dev),
            "adj_key": i64(csr["adj_key"]), "indptr": i64(csr["indptr"]),
            "tvals": i64(csr["tvals"]), "base": int(csr["base"]),
        }

    def _install(self, nodes, nbrs, times, es) -> None:
        dev = self.device
        self._adj = build_csr(
            torch.as_tensor(nodes, dtype=torch.int64, device=dev),
            as_int32(nbrs, "adj_nbr", dev), as_int32(times, "adj_t", dev),
            as_int32(es, "adj_e", dev), self.num_nodes)

    def reset_state(self) -> None:
        """Rewind the draw counter (start of an epoch); the adjacency is a
        pure function of the stream and is kept."""
        self._counter = 0

    def _queries(self, seeds, query_t):
        dev = self.device
        return (torch.as_tensor(seeds, device=dev).long(),
                torch.as_tensor(query_t, device=dev).long())

    def prefix(self, seeds, query_t):
        """``(starts, n_valid)`` (B,) int64 device tensors: where each
        seed's adjacency run starts and how many of its entries lie
        strictly before ``query_t``."""
        if not self._built:
            raise RuntimeError("DeviceUniformSampler.build() must be called first")
        adj = self._adj
        seeds, query_t = self._queries(seeds, query_t)
        qranks = torch.searchsorted(adj["tvals"], query_t, side="left")
        starts = adj["indptr"][seeds]
        ends = torch.searchsorted(adj["adj_key"], seeds * adj["base"] + qranks,
                                  side="left")
        return starts, ends - starts

    def draw(self, n_valid, counter: int):
        """(B, K) int64 offsets, uniform in ``[0, max(n_valid, 1))``, of
        draw call ``counter``."""
        if self._gen is None:
            self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(draw_seed(self._seed, counter))
        r = torch.randint(0, _DRAW_HIGH, (n_valid.shape[0], self.k),
                          generator=self._gen, device=self.device)
        return r % torch.clamp(n_valid, min=1)[:, None]

    def sample(self, seeds, query_t) -> NeighborBlock:
        """Draw K uniform past neighbors per seed, strictly before
        ``query_t`` (one counter step). Returns a fixed-shape device
        ``NeighborBlock``; seeds with an empty prefix come back fully
        masked (ids/eids -1, times 0)."""
        starts, n_valid = self.prefix(seeds, query_t)
        draw = self.draw(n_valid, self._counter)
        self._counter += 1
        adj = self._adj
        B, K = n_valid.shape[0], self.k
        has = (n_valid > 0)[:, None]
        idx = torch.clamp(starts[:, None] + draw,
                          max=max(adj["adj_nbr"].shape[0] - 1, 0))
        # An empty stream has nothing to gather: every row is masked.
        rows = [torch.where(has, adj[name][idx], fill) if adj[name].numel()
                else torch.full((B, K), fill, dtype=torch.int32, device=idx.device)
                for name, fill in (("adj_nbr", -1), ("adj_t", 0), ("adj_e", -1))]
        return NeighborBlock(*rows, has.expand(B, K).contiguous())

    # -- checkpoint contract (shared with UniformSampler) ----------------
    def state_dict(self) -> dict:
        """Canonical host-numpy state: the CSR arrays (int64) and the draw
        counter, or the counter alone with ``checkpoint_adjacency=False``."""
        if not self._built or not self.checkpoint_adjacency:
            return {"counter": np.int64(self._counter)}
        adj = self._adj
        return {
            "adj_nbr": adj["adj_nbr"].cpu().numpy().astype(np.int64),
            "adj_t": adj["adj_t"].cpu().numpy().astype(np.int64),
            "adj_e": adj["adj_e"].cpu().numpy().astype(np.int64),
            "indptr": adj["indptr"].cpu().numpy().astype(np.int64),
            "counter": np.int64(self._counter),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore from either uniform sampler's ``state_dict``; the
        composite key and time table are rebuilt on the device."""
        self._counter = int(state["counter"])
        if "adj_nbr" not in state:
            return
        self._install(*csr_from_state(state, self.num_nodes))
