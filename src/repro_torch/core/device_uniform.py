"""Device-resident uniform temporal neighbor sampling in PyTorch.

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
passes int32).

**Node-sharded** (``mesh=``, ``docs/sharding.md`` "Uniform CSR"): the CSR
is sorted once on the host (``host_csr``, the same stable sort) and split
on node boundaries over the ``mesh_axis`` ranks of a ``DeviceMesh``, each
rank placing only its nodes' contiguous run, padded to the largest shard's
edge count with int64-max keys so a local ``searchsorted`` never lands in
padding. ``partition="rows"`` gives every shard ``ceil(N / shards)``
nodes; ``"degree"`` cuts at the cumulative-degree quantiles
(``_shard_bounds``), balancing the edge counts. ``sample`` makes two
``all_reduce``s over the axis's group: the owners' valid-prefix lengths,
then the owners' gathered rows. The draws in between are made on every
rank from the combined lengths with the same ``(seed, counter)``
generator, so every rank draws the same offsets and the neighbors equal
the one-device sampler's under either partition. ``state_dict`` assembles
the canonical host CSR (one more ``all_reduce``) and ``load_state_dict``
re-splits any canonical state for this rank.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.device_sampler import as_int32
from repro_torch.core.sampler import NeighborBlock, csr_from_state, doubled_edges
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (
    all_reduce_flat,
    axis_group,
    axis_index,
    axis_size,
    node_rows_per_shard,
)

_DRAW_HIGH = 1 << 62
_KEY_PAD = np.iinfo(np.int64).max


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


def host_csr(nodes, nbrs, times, eids, num_nodes: int) -> dict:
    """``build_csr`` on the host: numpy's stable sort on the same int64
    composite key, so the arrays are bit-equal to the device build's."""
    nodes = np.asarray(nodes, np.int64)
    times64 = np.asarray(times, np.int64)
    tvals = np.unique(times64)
    base = len(tvals) + 1
    key = nodes * base + np.searchsorted(tvals, times64)
    order = np.argsort(key, kind="stable")
    indptr = np.concatenate([[0], np.cumsum(
        np.bincount(nodes, minlength=num_nodes))]).astype(np.int64)
    return {"adj_nbr": np.asarray(nbrs)[order], "adj_t": times64[order],
            "adj_e": np.asarray(eids)[order], "adj_key": key[order],
            "indptr": indptr, "tvals": tvals, "base": base}


class DeviceUniformSampler:
    """PyTorch device-resident uniform temporal neighbor sampler.

    Drop-in twin of ``UniformSampler``: ``build`` once per stream, then
    ``sample(seeds, query_t)`` draws K past neighbors per seed uniformly
    with replacement, on ``device``.
    """

    def __init__(self, num_nodes: int, k: int, seed: int = 0, device="cuda",
                 checkpoint_adjacency: bool = True, mesh=None,
                 mesh_axis: str = "data", partition: str = "rows"):
        if k <= 0:
            raise ValueError("k must be positive")
        if partition not in ("rows", "degree"):
            raise ValueError(
                f"partition must be 'rows' or 'degree', got {partition!r}")
        self.num_nodes = int(num_nodes)
        self.k = int(k)
        self._seed = int(seed)
        self._counter = 0
        self._adj = None
        self._gen = None
        self.checkpoint_adjacency = bool(checkpoint_adjacency)
        self.device = resolve_device(device)
        self.partition = partition
        self._mesh = mesh
        if mesh is not None:
            if mesh_axis not in mesh.mesh_dim_names:
                raise ValueError(f"mesh has no axis {mesh_axis!r}; axes are "
                                 f"{mesh.mesh_dim_names}")
            self._group = axis_group(mesh, mesh_axis)
            self._shards = axis_size(mesh, mesh_axis)
            self._shard = axis_index(mesh, mesh_axis)

    @property
    def _built(self) -> bool:
        return self._adj is not None

    def build(self, src, dst, t, eids: Optional[np.ndarray] = None) -> None:
        """Build the device CSR-by-time adjacency of an edge stream (both
        directions per event; ``eids`` defaults to the event index)."""
        self._install(*doubled_edges(src, dst, t, eids))

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
        if self._mesh is not None:
            self._shard_adjacency(csr)
            return
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
        if self._mesh is not None:
            self._shard_adjacency(host_csr(nodes, nbrs, times, es,
                                           self.num_nodes))
            return
        dev = self.device
        self._adj = build_csr(
            torch.as_tensor(nodes, dtype=torch.int64, device=dev),
            as_int32(nbrs, "adj_nbr", dev), as_int32(times, "adj_t", dev),
            as_int32(es, "adj_e", dev), self.num_nodes)

    def _shard_bounds(self, indptr: np.ndarray) -> np.ndarray:
        """Node boundaries ``(shards + 1,)``: shard ``i`` owns nodes
        ``[bounds[i], bounds[i+1])``. ``"rows"``: ``ceil(N / shards)``
        nodes each; ``"degree"``: cuts at the cumulative-degree quantiles
        (``searchsorted`` on the global indptr), as the reference cuts."""
        s, n = self._shards, self.num_nodes
        if self.partition == "degree":
            total = int(indptr[n])
            targets = (np.arange(1, s, dtype=np.int64) * total) // s
            cuts = np.searchsorted(indptr[: n + 1], targets)
            bounds = np.concatenate([[0], cuts, [n]]).astype(np.int64)
            return np.maximum.accumulate(bounds)
        per = node_rows_per_shard(n, s)
        return np.minimum(np.arange(s + 1, dtype=np.int64) * per, n)

    def _shard_adjacency(self, host: dict) -> None:
        """Place this rank's slice of the host CSR: its nodes' contiguous
        run of the node-major arrays, padded to the largest shard's edge
        count ``L`` (keys with int64 max, values with 0, never read), and
        its rebased indptr, padded to the largest shard's node count
        (clamped at its upper bound, so padding reads as zero degree)."""
        indptr = np.asarray(host["indptr"], np.int64)
        bounds = self._shard_bounds(indptr)
        i = self._shard
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        rows = max(int(np.diff(bounds).max()), 1)
        counts = indptr[bounds[1:]] - indptr[bounds[:-1]]
        L = max(int(counts.max()), 1)
        off, cnt = int(indptr[lo]), int(counts[i])
        dev = self.device

        def slab(name, fill, dtype):
            out = np.full(L, fill, dtype)
            out[:cnt] = np.asarray(host[name][off:off + cnt])
            return out

        local_ptr = indptr[np.minimum(lo + np.arange(rows + 1), hi)] - off
        self._adj = {
            "adj_nbr": as_int32(slab("adj_nbr", 0, np.int64), "adj_nbr", dev),
            "adj_t": as_int32(slab("adj_t", 0, np.int64), "adj_t", dev),
            "adj_e": as_int32(slab("adj_e", 0, np.int64), "adj_e", dev),
            "adj_key": torch.as_tensor(slab("adj_key", _KEY_PAD, np.int64),
                                       device=dev),
            "indptr": torch.as_tensor(local_ptr, device=dev),
            "tvals": torch.as_tensor(np.asarray(host["tvals"], np.int64),
                                     device=dev),
            "base": int(host["base"]), "lo": lo, "hi": hi, "L": L,
        }
        self._host_indptr = indptr
        self._run = (off, cnt)

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
        seeds, query_t = self._queries(seeds, query_t)
        starts, n_valid, _ = self._prefix(seeds, query_t)
        if self._mesh is not None:  # global starts, as one device has them
            starts = torch.as_tensor(self._host_indptr,
                                     device=self.device)[seeds]
        return starts, n_valid

    def _prefix(self, seeds, query_t):
        """``(starts, n_valid, owned)`` with starts into this rank's
        arrays; sharded, ``n_valid`` is combined over the axis (first
        ``all_reduce``) and ``owned`` marks this rank's seeds (``None`` on
        one device)."""
        adj = self._adj
        qranks = torch.searchsorted(adj["tvals"], query_t, side="left")
        owned = None
        rows = seeds
        if self._mesh is not None:
            owned = (seeds >= adj["lo"]) & (seeds < adj["hi"])
            rows = torch.where(owned, seeds - adj["lo"], 0)
        starts = adj["indptr"][rows]
        ends = torch.searchsorted(adj["adj_key"], seeds * adj["base"] + qranks,
                                  side="left")
        n_valid = ends - starts
        if owned is not None:
            n_valid = torch.where(owned, n_valid, 0)
            dist.all_reduce(n_valid, group=self._group)
        return starts, n_valid, owned

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
        if not self._built:
            raise RuntimeError("DeviceUniformSampler.build() must be called first")
        starts, n_valid, owned = self._prefix(*self._queries(seeds, query_t))
        draw = self.draw(n_valid, self._counter)
        self._counter += 1
        adj = self._adj
        B, K = n_valid.shape[0], self.k
        has = (n_valid > 0)[:, None]
        idx = torch.clamp(starts[:, None] + draw,
                          max=max(adj["adj_nbr"].shape[0] - 1, 0))
        names = ("adj_nbr", "adj_t", "adj_e")
        if owned is not None:
            # Second all_reduce: each seed's rows from its owner.
            got = torch.stack([adj[name][idx] for name in names], dim=-1)
            got = torch.where(owned[:, None, None], got, 0)
            dist.all_reduce(got, group=self._group)
            got = got.unbind(-1)
        elif adj["adj_nbr"].numel():
            got = [adj[name][idx] for name in names]
        else:  # an empty stream has nothing to gather: every row is masked
            got = [torch.zeros((B, K), dtype=torch.int32, device=idx.device)] * 3
        rows = [torch.where(has, g, fill) for g, fill in zip(got, (-1, 0, -1))]
        return NeighborBlock(*rows, has.expand(B, K).contiguous())

    # -- checkpoint contract (shared with UniformSampler) ----------------
    def state_dict(self) -> dict:
        """Canonical host-numpy state: the CSR arrays (int64) and the draw
        counter, or the counter alone with ``checkpoint_adjacency=False``."""
        if not self._built or not self.checkpoint_adjacency:
            return {"counter": np.int64(self._counter)}
        adj = self._adj
        names = ("adj_nbr", "adj_t", "adj_e")
        if self._mesh is None:
            cols = [adj[name] for name in names]
            indptr = adj["indptr"].cpu().numpy()
        else:
            # Every rank writes its run into zero-filled canonical arrays;
            # one owner per entry, so the all_reduce is exact.
            off, cnt = self._run
            full = torch.zeros((3, int(self._host_indptr[-1])),
                               dtype=torch.int32, device=self.device)
            for row, name in enumerate(names):
                full[row, off:off + cnt] = adj[name][:cnt]
            cols = all_reduce_flat([full], self._group)[0].unbind(0)
            indptr = self._host_indptr
        out = {name: c.cpu().numpy().astype(np.int64)
               for name, c in zip(names, cols)}
        out["indptr"] = np.asarray(indptr).astype(np.int64)
        out["counter"] = np.int64(self._counter)
        return out

    def load_state_dict(self, state: dict) -> None:
        """Restore from either uniform sampler's ``state_dict`` at any mesh
        shape; the composite key and time table are rebuilt (sharded: the
        CSR re-split for this rank)."""
        self._counter = int(state["counter"])
        if "adj_nbr" not in state:
            return
        self._install(*csr_from_state(state, self.num_nodes))
