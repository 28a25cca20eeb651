"""Hook library for the link recipes (paper Table 2).

PyTorch port of ``repro.core.tg_hooks``' link hooks: padding, train/eval
negatives, recency neighbors on the host (``RecencyNeighborHook``, numpy
circular buffers with batch-level de-duplication) or on the device
(``DeviceRecencyNeighborHook``, with the packed buffer exposed for the fused
attention), uniform neighbors on the host (``UniformNeighborHook``) or on
the device (``DeviceUniformNeighborHook``), one or two hops each,
edge-feature lookup and the device transfer. Negatives are drawn with numpy
exactly as in the reference, so they are bit-equal.
``SnapshotNegativeHook`` serves the DTDG snapshot recipe and
``DOSEstimateHook`` the density-of-states analytics recipe (numpy, its probe
draws bit-equal to the reference's).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.core.batch import Batch
from repro_torch.core.device_sampler import DeviceRecencySampler
from repro_torch.core.device_uniform import DeviceUniformSampler
from repro_torch.core.hooks import Hook
from repro_torch.core.negatives import NegativeEdgeSampler, snapshot_negatives
from repro_torch.core.sampler import RecencySampler, UniformSampler
from repro_torch.device import host_tensor, resolve_device

_EDGE_TABLE_CACHE: OrderedDict = OrderedDict()
_EDGE_TABLE_CACHE_MAX = 8


def _host(x) -> np.ndarray:
    """A batch attribute as a host numpy array. The recipe's contract-free
    ``DeviceTransferHook`` may already have moved it to the device (the
    topological order runs it as soon as it is ready), as in the reference,
    whose hooks read device arrays back with ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def device_edge_table(feats, device) -> torch.Tensor:
    """Device-resident float32 copy of an edge-feature storage array, cached
    by storage identity and device (epoch resets rebuild nothing; the entry
    pins the source array so its ``id`` cannot be recycled). A read-only
    memmap column is copied, not aliased (``device.host_tensor``). Each rank
    of a multi-rank run is a process of its own, so the table is staged
    once per rank, on the rank's device (the reference stages it once,
    mesh-replicated)."""
    if isinstance(feats, torch.Tensor):
        return feats.to(device=device, dtype=torch.float32)
    dev = torch.device(device)
    key = (id(feats), str(dev))
    entry = _EDGE_TABLE_CACHE.get(key)
    if entry is not None and entry[0] is feats:
        _EDGE_TABLE_CACHE.move_to_end(key)
        return entry[1]
    table = host_tensor(np.asarray(feats, np.float32)).to(dev)
    _EDGE_TABLE_CACHE[key] = (feats, table)
    while len(_EDGE_TABLE_CACHE) > _EDGE_TABLE_CACHE_MAX:
        _EDGE_TABLE_CACHE.popitem(last=False)
    return table


class NegativeEdgeHook(Hook):
    """Produces ``neg``: (B, num_negatives) corrupted destinations."""

    def __init__(self, num_nodes: int, num_negatives: int = 1,
                 strategy: str = "random", seed: int = 0,
                 dst_pool: Optional[np.ndarray] = None):
        super().__init__(requires={"src", "dst", "time"}, produces={"neg"})
        self._sampler = NegativeEdgeSampler(
            num_nodes, strategy=strategy, num_negatives=num_negatives,
            seed=seed, dst_pool=dst_pool,
        )

    def reset_state(self) -> None:
        """Reset the negative sampler's RNG and observed-destination pool."""
        self._sampler.reset_state()

    def __call__(self, batch: Batch) -> Batch:
        src, dst, t = batch["src"], batch["dst"], batch["time"]
        batch["neg"] = self._sampler.sample(src, dst, t)
        if "batch_mask" in batch:
            m = batch["batch_mask"]
            self._sampler.observe(src[m], dst[m])
        else:
            self._sampler.observe(src, dst)
        return batch


class TGBEvalNegativesHook(Hook):
    """One-vs-many evaluation negatives (TGB protocol).

    Deterministic per (seed, batch_counter) so every epoch ranks positives
    against the same negative sets. Produces ``neg``: (B, num_negatives).
    """

    def __init__(self, num_nodes: int, num_negatives: int = 100, seed: int = 0,
                 dst_pool: Optional[np.ndarray] = None):
        super().__init__(requires={"src", "dst", "time"}, produces={"neg"})
        self.num_negatives = num_negatives
        self._seed = seed
        self._counter = 0
        self._pool = (
            np.arange(num_nodes, dtype=np.int64) if dst_pool is None
            else np.asarray(dst_pool, dtype=np.int64)
        )

    def reset_state(self) -> None:
        """Rewind the per-batch counter so eval negatives replay exactly."""
        self._counter = 0

    def __call__(self, batch: Batch) -> Batch:
        rng = np.random.default_rng((self._seed, self._counter))
        self._counter += 1
        B = len(batch["src"])
        batch["neg"] = rng.choice(self._pool, size=(B, self.num_negatives)).astype(np.int64)
        return batch


def _like(ref, x: np.ndarray):
    """``x`` where the batch's ``ref`` attribute lives: unchanged when that
    is a host array, else staged on its device as ``stage_batch`` stages
    (int64 narrowed to int32)."""
    if not isinstance(ref, torch.Tensor):
        return x
    if x.dtype == np.int64:
        x = x.astype(np.int32)
    return host_tensor(x).to(ref.device)


def _produces(num_hops: int) -> set:
    """The attributes a recency neighbor hook produces for ``num_hops``."""
    out = {"seed_nodes", "seed_times", "nbr_ids", "nbr_times", "nbr_eids",
           "nbr_mask"}
    if num_hops == 2:
        out |= {"nbr2_ids", "nbr2_times", "nbr2_eids", "nbr2_mask"}
    return out


def _requires(include_negatives: bool) -> set:
    """The attributes a neighbor hook reads: the events, and ``neg`` when
    it seeds the negatives too."""
    return {"src", "dst", "time"} | ({"neg"} if include_negatives else set())


def _seed_rows(batch, include_negatives: bool):
    """The batch's seeds ``[src | dst | neg...]`` and their query times, as
    host int64 arrays."""
    src, dst, t = _host(batch["src"]), _host(batch["dst"]), _host(batch["time"])
    seeds, times = [src, dst], [t, t]
    if include_negatives and "neg" in batch:
        neg = _host(batch["neg"])
        seeds.append(neg.reshape(-1))
        times.append(np.repeat(t, neg.shape[1]))
    return (np.concatenate(seeds).astype(np.int64),
            np.concatenate(times).astype(np.int64))


class RecencyNeighborHook(Hook):
    """Temporal neighbor sampling from host recency circular buffers.

    Seeds are the batch's ``[src | dst | neg...]`` nodes at the batch query
    times; produces ``seed_nodes``/``seed_times`` (S,) and
    ``nbr_ids/nbr_times/nbr_eids/nbr_mask`` (S, K), then reveals the batch's
    positive edges to the sampler (predict-then-reveal; padded events are
    left out through ``batch_mask``). Each distinct seed node is sampled
    once and the rows are gathered back to the full seed list (the paper's
    batch-level de-duplication, §5.1, the reference's ``dedup=True``):
    exact, since the buffers do not change while a batch is sampled. With
    ``num_hops=2`` it also produces ``nbr2_ids/nbr2_times/nbr2_eids/
    nbr2_mask`` (S * K, K): the hop-1 frontier's own neighborhoods, each
    distinct frontier node sampled once from the same (pre-update) buffers,
    padded frontier slots set to -1 / 0 / -1 / False.

    The reference's switches: ``include_negatives=False`` seeds the
    positive events only (``neg`` is then neither required nor read);
    ``dedup=False`` samples every seed row on its own (the same rows);
    ``update_buffer=False`` leaves the buffers as they were (the sampler's
    state is unchanged after the batch).

    The sampling runs in numpy on the host (``RecencySampler``). The
    recipe's contract-free ``DeviceTransferHook`` runs before this hook
    (``resolve_order``), so the batch's events may already be on the device:
    the hook then reads them back and hands its outputs to that device, so
    that the edge-feature lookup after it gathers on the device. The values
    are those the reference's host hook gives.
    """

    def __init__(self, num_nodes: int, k: int, num_hops: int = 1,
                 include_negatives: bool = True, dedup: bool = True,
                 update_buffer: bool = True):
        if num_hops not in (1, 2):
            raise ValueError("num_hops must be 1 or 2")
        super().__init__(requires=_requires(include_negatives),
                         produces=_produces(num_hops))
        self.sampler = RecencySampler(num_nodes, k)
        self.k = k
        self.num_hops = num_hops
        self.include_negatives = include_negatives
        self.dedup = dedup
        self.update_buffer = update_buffer

    def _sample(self, nodes: np.ndarray):
        """The neighborhoods of ``nodes``: each distinct node sampled once
        and gathered back (``dedup``), or every row sampled on its own."""
        if not self.dedup:
            blk = self.sampler.sample(nodes)
            return blk.nbr_ids, blk.nbr_times, blk.nbr_eids, blk.mask
        uniq, inverse = np.unique(nodes, return_inverse=True)
        blk = self.sampler.sample(uniq)
        return (blk.nbr_ids[inverse], blk.nbr_times[inverse],
                blk.nbr_eids[inverse], blk.mask[inverse])

    def reset_state(self) -> None:
        """Clear the host circular buffers (start of an epoch)."""
        self.sampler.reset_state()

    def state_dict(self) -> dict:
        """Checkpoint the sampler buffers (shared host/device contract)."""
        return self.sampler.state_dict()

    def load_state_dict(self, state: dict) -> None:
        """Restore sampler buffers saved by any recency sampler."""
        self.sampler.load_state_dict(state)

    def __call__(self, batch: Batch) -> Batch:
        """Sample the neighborhoods, then reveal the batch's positive edges
        to the sampler."""
        ref = batch["src"]
        src, dst, t = _host(ref), _host(batch["dst"]), _host(batch["time"])
        seed_nodes, seed_times = _seed_rows(batch, self.include_negatives)
        nbr_ids, nbr_times, nbr_eids, nbr_mask = self._sample(seed_nodes)
        out = {"seed_nodes": seed_nodes, "seed_times": seed_times,
               "nbr_ids": nbr_ids, "nbr_times": nbr_times,
               "nbr_eids": nbr_eids, "nbr_mask": nbr_mask}
        if self.num_hops == 2:
            flat = nbr_ids.reshape(-1)
            ids2, t2, e2, m2 = self._sample(np.where(flat >= 0, flat, 0))
            pad = (flat < 0)[:, None]
            out.update(nbr2_ids=np.where(pad, -1, ids2),
                       nbr2_times=np.where(pad, 0, t2),
                       nbr2_eids=np.where(pad, -1, e2),
                       nbr2_mask=np.where(pad, False, m2))
        for key, x in out.items():
            batch[key] = _like(ref, x)
        if not self.update_buffer:
            return batch

        eids = batch.meta.get("eids")
        if "batch_mask" in batch:  # exclude padded events from state
            m = _host(batch["batch_mask"]).astype(bool)
            src, dst, t = src[m], dst[m], t[m]
            eids = None if eids is None else eids[m[: len(eids)]]
        self.sampler.update(src, dst, t, eids)
        return batch


class DeviceRecencyNeighborHook(Hook):
    """Device-resident temporal neighbor sampling.

    Seeds are the batch's ``[src | dst | neg...]`` nodes at the batch query
    times; produces ``seed_nodes``/``seed_times`` (host int64, staged by
    ``DeviceTransferHook``) and ``nbr_ids/nbr_times/nbr_eids/nbr_mask``
    (S, K) device tensors, then reveals the batch's positive edges to the
    sampler (predict-then-reveal; padded events are routed to the sink row
    through ``batch_mask``). With ``num_hops=2`` it also produces the
    frontier's ``nbr2_*`` (S * K, K) device tensors, as the host hook does
    but without de-duplication (one gather for every frontier slot).

    With ``expose_buffer=True`` (the default: on CUDA the fused kernel reads
    it) each batch also carries ``nbr_buf``, the packed buffer *as sampled*:
    the sampler's update writes fresh tensors, so the stashed reference is
    the pre-update snapshot. ``edge_feat_table`` (the (E, d_edge) device
    table indexed by the buffer's edge-id channel) rides along when
    ``edge_feats`` is given. With ``mesh`` the sampler is node-sharded over
    ``mesh_axis`` and ``nbr_buf`` is this rank's block (read by the
    shard-aware fused layer; the recipe leaves it off unless asked).
    ``include_negatives=False`` seeds the positive events only and
    ``update_buffer=False`` leaves the sampler's state as it was, as in the
    reference.
    """

    def __init__(self, num_nodes: int, k: int, num_hops: int = 1,
                 include_negatives: bool = True, update_buffer: bool = True,
                 device="cuda", expose_buffer: Optional[bool] = None,
                 edge_feats=None, mesh=None, mesh_axis: str = "data"):
        if num_hops not in (1, 2):
            raise ValueError("num_hops must be 1 or 2")
        expose_buffer = True if expose_buffer is None else expose_buffer
        produces = _produces(num_hops)
        if expose_buffer:
            produces |= {"nbr_buf"}
            if edge_feats is not None:
                produces |= {"edge_feat_table"}
        # Shared checkpoint key with the host twin of the reference.
        super().__init__(requires=_requires(include_negatives),
                         produces=produces, state_key="RecencyNeighborHook")
        self.sampler = DeviceRecencySampler(num_nodes, k, device=device,
                                            mesh=mesh, mesh_axis=mesh_axis)
        self.k = k
        self.num_hops = num_hops
        self.include_negatives = include_negatives
        self.update_buffer = update_buffer
        self.expose_buffer = expose_buffer
        self._edge_table = None
        if expose_buffer and edge_feats is not None:
            self._edge_table = device_edge_table(edge_feats,
                                                 self.sampler.device)

    def reset_state(self) -> None:
        """Clear the on-device circular buffers (start of an epoch)."""
        self.sampler.reset_state()

    def state_dict(self) -> dict:
        """Checkpoint the sampler buffers (canonical host contract)."""
        return self.sampler.state_dict()

    def load_state_dict(self, state: dict) -> None:
        """Restore sampler buffers saved by any recency sampler."""
        self.sampler.load_state_dict(state)

    def __call__(self, batch: Batch) -> Batch:
        """Sample the neighborhoods, expose the pre-update buffer, then
        reveal the batch's positive edges to the sampler."""
        src, dst, t = _host(batch["src"]), _host(batch["dst"]), _host(batch["time"])
        if self.expose_buffer:
            batch["nbr_buf"] = self.sampler.packed_buffer
            if self._edge_table is not None:
                batch["edge_feat_table"] = self._edge_table
        seed_nodes, seed_times = _seed_rows(batch, self.include_negatives)
        blk = self.sampler.sample(seed_nodes)
        batch["seed_nodes"], batch["seed_times"] = seed_nodes, seed_times
        batch["nbr_ids"], batch["nbr_times"] = blk.nbr_ids, blk.nbr_times
        batch["nbr_eids"], batch["nbr_mask"] = blk.nbr_eids, blk.mask
        if self.num_hops == 2:
            flat = blk.nbr_ids.reshape(-1)
            blk2 = self.sampler.sample(torch.clamp(flat, min=0))
            pad = (flat < 0)[:, None]
            batch["nbr2_ids"] = torch.where(pad, -1, blk2.nbr_ids)
            batch["nbr2_times"] = torch.where(pad, 0, blk2.nbr_times)
            batch["nbr2_eids"] = torch.where(pad, -1, blk2.nbr_eids)
            batch["nbr2_mask"] = torch.where(pad, False, blk2.mask)
        if not self.update_buffer:
            return batch

        eids = batch.meta.get("eids")
        n = len(src)
        eids_full = np.full(n, -1, dtype=np.int64)
        if eids is not None:
            eids_full[: len(eids)] = eids
        valid = _host(batch["batch_mask"]) if "batch_mask" in batch \
            else np.ones(n, bool)
        self.sampler.update(src, dst, t, eids_full, valid=valid)
        return batch


class UniformNeighborHook(Hook):
    """Uniform temporal neighbor sampling over a pre-built adjacency.

    Seeds are the batch's ``[src | dst | neg...]`` nodes at the batch event
    times; each draws K uniform neighbors from its strict past (``t <
    query_t``), so a once-per-stream ``build`` leaks nothing. Stateless
    across batches apart from the draw counter (checkpointed through
    ``state_dict``). With ``num_hops=2`` each hop-1 slot becomes a hop-2 seed
    queried at its own interaction time; a padded hop-1 slot is queried as
    node 0 at t = 0 and its row is then masked (-1 / 0 / -1 / False).

    The sampling runs in numpy on the host (``UniformSampler``, bit-equal to
    the reference's); as ``RecencyNeighborHook`` does, the hook hands its
    outputs to the device the batch's events are on.
    """

    def __init__(self, num_nodes: int, k: int, include_negatives: bool = False,
                 seed: int = 0, num_hops: int = 1,
                 checkpoint_adjacency: bool = True):
        if num_hops not in (1, 2):
            raise ValueError("num_hops must be 1 or 2")
        super().__init__(requires=_requires(include_negatives),
                         produces=_produces(num_hops),
                         state_key="UniformNeighborHook")
        self.sampler = self._make_sampler(num_nodes, k, seed,
                                          checkpoint_adjacency)
        self.k = k
        self.num_hops = num_hops
        self.include_negatives = include_negatives

    def _make_sampler(self, num_nodes, k, seed, checkpoint_adjacency):
        return UniformSampler(num_nodes, k, seed=seed,
                              checkpoint_adjacency=checkpoint_adjacency)

    def build(self, src, dst, t, eids=None) -> "UniformNeighborHook":
        """Build the sampler's CSR-by-time adjacency; returns self."""
        self.sampler.build(src, dst, t, eids)
        return self

    def build_from_store(self, store, **kwargs) -> "UniformNeighborHook":
        """Build the adjacency from an ``EventStore`` by the streaming
        two-pass CSR (``repro_torch.storage.streaming_csr``); returns self.
        Works for the host and the device hook (each sampler implements
        ``build_from_store``)."""
        self.sampler.build_from_store(store, **kwargs)
        return self

    def reset_state(self) -> None:
        """Rewind the sampler's draw counter (epochs replay exactly)."""
        self.sampler.reset_state()

    def state_dict(self) -> dict:
        """Checkpoint the sampler (shared host/device uniform contract)."""
        return self.sampler.state_dict()

    def load_state_dict(self, state: dict) -> None:
        """Restore state saved by either uniform sampler."""
        self.sampler.load_state_dict(state)

    def _hop2(self, blk, where):
        """The recursive frontier: every hop-1 slot queried at its own time;
        ``where`` is ``np.where`` or ``torch.where``."""
        flat_ids = blk.nbr_ids.reshape(-1)
        flat_t = blk.nbr_times.reshape(-1)
        invalid = flat_ids < 0
        blk2 = self.sampler.sample(where(invalid, 0, flat_ids),
                                   where(invalid, 0, flat_t))
        pad = invalid[:, None]
        return {"nbr2_ids": where(pad, -1, blk2.nbr_ids),
                "nbr2_times": where(pad, 0, blk2.nbr_times),
                "nbr2_eids": where(pad, -1, blk2.nbr_eids),
                "nbr2_mask": where(pad, False, blk2.mask)}

    def __call__(self, batch: Batch) -> Batch:
        """Sample the batch's uniform temporal neighborhoods."""
        seed_nodes, seed_times = _seed_rows(batch, self.include_negatives)
        blk = self.sampler.sample(seed_nodes, seed_times)
        out = {"seed_nodes": seed_nodes, "seed_times": seed_times,
               "nbr_ids": blk.nbr_ids, "nbr_times": blk.nbr_times,
               "nbr_eids": blk.nbr_eids, "nbr_mask": blk.mask}
        if self.num_hops == 2:
            out.update(self._hop2(blk, np.where))
        for key, x in out.items():
            batch[key] = _like(batch["src"], x)
        return batch


class DeviceUniformNeighborHook(UniformNeighborHook):
    """Device-resident uniform temporal neighbor sampling.

    Same contract, seeds and ``num_hops=2`` frontier as
    ``UniformNeighborHook``, backed by ``DeviceUniformSampler``: the neighbor
    tensors are born on the device (int32, bool mask), ``seed_nodes`` /
    ``seed_times`` are host int64 that ``DeviceTransferHook`` stages, as the
    device recency hook gives them. The checkpoint key is the host twin's,
    so either hook restores the other's state.
    """

    def __init__(self, num_nodes: int, k: int, include_negatives: bool = False,
                 seed: int = 0, num_hops: int = 1,
                 checkpoint_adjacency: bool = True, device="cuda", mesh=None,
                 mesh_axis: str = "data", partition: str = "rows"):
        self._device = resolve_device(device)
        self._shard_kw = {"mesh": mesh, "mesh_axis": mesh_axis,
                          "partition": partition}
        super().__init__(num_nodes, k, include_negatives=include_negatives,
                         seed=seed, num_hops=num_hops,
                         checkpoint_adjacency=checkpoint_adjacency)

    def _make_sampler(self, num_nodes, k, seed, checkpoint_adjacency):
        return DeviceUniformSampler(num_nodes, k, seed=seed,
                                    device=self._device,
                                    checkpoint_adjacency=checkpoint_adjacency,
                                    **self._shard_kw)

    def __call__(self, batch: Batch) -> Batch:
        """Sample the batch's uniform temporal neighborhoods on the device."""
        seed_nodes, seed_times = _seed_rows(batch, self.include_negatives)
        blk = self.sampler.sample(seed_nodes, seed_times)
        batch["seed_nodes"], batch["seed_times"] = seed_nodes, seed_times
        batch["nbr_ids"], batch["nbr_times"] = blk.nbr_ids, blk.nbr_times
        batch["nbr_eids"], batch["nbr_mask"] = blk.nbr_eids, blk.mask
        if self.num_hops == 2:
            for key, x in self._hop2(blk, torch.where).items():
                batch[key] = x
        return batch


class SnapshotNegativeHook(Hook):
    """Per-snapshot negative destinations for the DTDG link recipe.

    Produces ``neg``: (capacity, num_negatives) int32 corrupted destinations
    on ``device`` for the batch's (predicted) snapshot. The draws are a pure
    function of ``(seed, num_negatives, snapshot row)``
    (``core.negatives.snapshot_negatives``), the function the compiled
    pipeline uses to draw a chunk's rows at once, so the hook path and the
    compiled path are bit-identical.

    The snapshot row comes from ``batch.meta['snapshot_row']`` when present
    (how ``DTDGLinkPipeline`` drives the hook). Without it an internal cursor
    advances one row per call; ``seek(row)`` positions it and
    ``state_dict`` checkpoints it.
    """

    def __init__(self, num_nodes: int, capacity: int, num_negatives: int = 1,
                 seed: int = 0, device="cuda"):
        super().__init__(requires={"src"}, produces={"neg"})
        self.num_nodes = int(num_nodes)
        self.capacity = int(capacity)
        self.num_negatives = int(num_negatives)
        self._seed = int(seed)
        self._device = resolve_device(device)
        self._cursor = 0

    def seek(self, row: int) -> None:
        """Position the cursor at snapshot ``row`` (split boundaries)."""
        self._cursor = int(row)

    def reset_state(self) -> None:
        """Rewind the snapshot cursor (start of an epoch)."""
        self._cursor = 0

    def state_dict(self) -> dict:
        """Checkpoint the snapshot cursor (draws are cursor-derived)."""
        return {"cursor": np.int64(self._cursor)}

    def load_state_dict(self, state: dict) -> None:
        """Restore the snapshot cursor."""
        self._cursor = int(state["cursor"])

    def __call__(self, batch: Batch) -> Batch:
        """Attach this snapshot's deterministic negative draws."""
        row = int(batch.meta.get("snapshot_row", self._cursor))
        batch["neg"] = snapshot_negatives(
            self._seed, self.num_nodes, self.capacity, self.num_negatives,
            [row], device=self._device)[0]
        self._cursor = row + 1
        return batch


class EdgeFeatureLookupHook(Hook):
    """Produces ``<prefix>_feats``: gather stored edge features for sampled
    neighbor edge ids (zeros where padded / featureless).

    The fused attention path never reads ``nbr_feats``: it gathers edge rows
    inside the kernel from ``edge_feat_table``. The hook stays in the recipe
    because the classic path (``fused=False``) consumes it.
    """

    def __init__(self, edge_feats: Optional[np.ndarray], feat_dim: int,
                 prefix: str = "nbr"):
        super().__init__(
            requires={f"{prefix}_eids"}, produces={f"{prefix}_feats"}
        )
        self._feats = edge_feats
        self._dim = feat_dim
        self._prefix = prefix

    def __call__(self, batch: Batch) -> Batch:
        eids = batch[f"{self._prefix}_eids"]
        if isinstance(eids, np.ndarray):
            out = np.zeros(eids.shape + (self._dim,), dtype=np.float32)
            if self._feats is not None:
                ok = eids >= 0
                out[ok] = self._feats[eids[ok]]
        elif self._feats is None:
            out = torch.zeros(eids.shape + (self._dim,), dtype=torch.float32,
                              device=eids.device)
        else:
            table = device_edge_table(self._feats, eids.device)
            rows = table[torch.clamp(eids, min=0).long()]
            out = torch.where((eids >= 0)[..., None], rows, 0.0)
        batch[f"{self._prefix}_feats"] = out
        return batch


class PadBatchHook(Hook):
    """Pads event tensors to a fixed batch size and emits ``batch_mask`` so
    every step sees identical shapes."""

    PADDABLE = ("src", "dst", "time", "neg", "edge_feats", "labels")

    def __init__(self, batch_size: int):
        super().__init__(requires={"src"}, produces={"batch_mask"})
        self.batch_size = batch_size

    def __call__(self, batch: Batch) -> Batch:
        n = len(batch["src"])
        pad = self.batch_size - n
        if pad < 0:
            raise ValueError(f"batch of {n} exceeds fixed size {self.batch_size}")
        mask = np.zeros(self.batch_size, dtype=bool)
        mask[:n] = True
        for key in self.PADDABLE:
            if key in batch:
                v = batch[key]
                widths = [(0, pad)] + [(0, 0)] * (v.ndim - 1)
                batch[key] = np.pad(v, widths)
        batch["batch_mask"] = mask
        return batch


def stage_batch(batch: Batch, device, pool=None) -> Batch:
    """Move every host numpy attribute of ``batch`` to ``device`` (int64
    narrowed to int32, as the reference stages for its jitted models;
    read-only memmap slices copied, ``device.host_tensor``); tensors already
    on the device pass through. ``pool`` (a
    ``core.loader._HostStagingPool``) routes each array through a reused
    pinned buffer and copies it with ``non_blocking=True``; the caller
    records the event that the slot's next rewrite waits for."""
    for key in list(batch.keys()):
        v = batch[key]
        if isinstance(v, np.ndarray):
            if pool is not None:
                batch[key] = pool.stage(key, v).to(device, non_blocking=True)
                continue
            if v.dtype == np.int64:
                v = v.astype(np.int32)
            batch[key] = host_tensor(v).to(device)
    return batch


class DeviceTransferHook(Hook):
    """Moves all array attributes to a torch device (paper Table 2: R=∅,
    P=∅); in a multi-rank run, the rank's device (every rank stages the
    whole, replicated batch). Register last; ordering among contract-free
    hooks follows registration."""

    def __init__(self, device="cuda"):
        super().__init__(requires=set(), produces=set())
        self._device = resolve_device(device)

    def __call__(self, batch: Batch) -> Batch:
        return stage_batch(batch, self._device)


class DOSEstimateHook(Hook):
    """Analytics: the spectral density of states of the batch's interaction
    graph by Hutchinson moment estimation (paper Fig. 3's recipe).

    Produces ``dos``: (num_moments,) float32 Chebyshev moment estimates of
    the normalized adjacency's spectrum, from ``num_probes`` Rademacher
    probes. The probes come from one ``default_rng(seed)`` that persists
    across batches and epochs, so a sequence of batches gives the
    reference's moments bit for bit.
    """

    def __init__(self, num_nodes: int, num_moments: int = 10, num_probes: int = 4,
                 seed: int = 0):
        super().__init__(requires={"src", "dst"}, produces={"dos"})
        self.num_nodes = num_nodes
        self.num_moments = num_moments
        self.num_probes = num_probes
        self._rng = np.random.default_rng(seed)

    def reset_state(self) -> None:
        """Stateless across epochs (the probe RNG persists on purpose)."""

    def __call__(self, batch: Batch) -> Batch:
        src, dst = _host(batch["src"]), _host(batch["dst"])
        nodes, idx = np.unique(np.concatenate([src, dst]), return_inverse=True)
        n = len(nodes)
        if n == 0:
            batch["dos"] = np.zeros(self.num_moments, dtype=np.float32)
            return batch
        r, c = idx[:len(src)], idx[len(src):]
        deg = np.bincount(idx, minlength=n).astype(np.float64)
        dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
        w = (dinv[r] * dinv[c])[:, None]

        def matvec(x):
            y = np.zeros_like(x)
            np.add.at(y, r, w * x[c])
            np.add.at(y, c, w * x[r])
            return y

        z = self._rng.choice([-1.0, 1.0], size=(n, self.num_probes))
        scale = n * self.num_probes
        tkm1, tk = z, matvec(z)
        moments = [float((z * tkm1).sum() / scale), float((z * tk).sum() / scale)]
        for _ in range(self.num_moments - 2):
            tkp1 = 2.0 * matvec(tk) - tkm1
            moments.append(float((z * tkp1).sum() / scale))
            tkm1, tk = tk, tkp1
        batch["dos"] = np.asarray(moments[: self.num_moments], dtype=np.float32)
        return batch
