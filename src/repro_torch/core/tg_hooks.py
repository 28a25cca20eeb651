"""Hook library for the device-recency link recipe (paper Table 2).

PyTorch port of the device-sampling branch of ``repro.core.tg_hooks``:
padding, train/eval negatives, device-resident recency neighbors (with the
packed buffer exposed for the fused attention), edge-feature lookup and the
device transfer. Negatives are drawn with numpy exactly as in the reference,
so they are bit-equal. The host samplers, the uniform samplers and the
analytics hooks are not part of the port yet.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.core.batch import Batch
from repro_torch.core.device_sampler import DeviceRecencySampler
from repro_torch.core.hooks import Hook
from repro_torch.core.negatives import NegativeEdgeSampler
from repro_torch.device import resolve_device

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
    pins the source array so its ``id`` cannot be recycled)."""
    if isinstance(feats, torch.Tensor):
        return feats.to(device=device, dtype=torch.float32)
    dev = torch.device(device)
    key = (id(feats), str(dev))
    entry = _EDGE_TABLE_CACHE.get(key)
    if entry is not None and entry[0] is feats:
        _EDGE_TABLE_CACHE.move_to_end(key)
        return entry[1]
    table = torch.as_tensor(np.asarray(feats, np.float32), device=dev)
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


class DeviceRecencyNeighborHook(Hook):
    """Device-resident temporal neighbor sampling.

    Seeds are the batch's ``[src | dst | neg...]`` nodes at the batch query
    times; produces ``seed_nodes``/``seed_times`` (host int64, staged by
    ``DeviceTransferHook``) and ``nbr_ids/nbr_times/nbr_eids/nbr_mask``
    (S, K) device tensors, then reveals the batch's positive edges to the
    sampler (predict-then-reveal; padded events are routed to the sink row
    through ``batch_mask``). The hop-2 frontier waits for 2-layer TGAT
    (ROADMAP A).

    With ``expose_buffer=True`` (the default: on CUDA the fused kernel reads
    it) each batch also carries ``nbr_buf``, the packed buffer *as sampled*:
    the sampler's update writes fresh tensors, so the stashed reference is
    the pre-update snapshot. ``edge_feat_table`` (the (E, d_edge) device
    table indexed by the buffer's edge-id channel) rides along when
    ``edge_feats`` is given.
    """

    def __init__(self, num_nodes: int, k: int, device="cuda",
                 expose_buffer: Optional[bool] = None, edge_feats=None):
        expose_buffer = True if expose_buffer is None else expose_buffer
        produces = {"seed_nodes", "seed_times", "nbr_ids", "nbr_times",
                    "nbr_eids", "nbr_mask"}
        if expose_buffer:
            produces |= {"nbr_buf"}
            if edge_feats is not None:
                produces |= {"edge_feat_table"}
        # Shared checkpoint key with the host twin of the reference.
        super().__init__(requires={"src", "dst", "time", "neg"},
                         produces=produces, state_key="RecencyNeighborHook")
        self.sampler = DeviceRecencySampler(num_nodes, k, device=device)
        self.k = k
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
        neg = _host(batch["neg"])  # (B, Nneg)
        seed_nodes = np.concatenate([src, dst, neg.reshape(-1)]).astype(np.int64)
        seed_times = np.concatenate(
            [t, t, np.repeat(t, neg.shape[1])]).astype(np.int64)

        blk = self.sampler.sample(seed_nodes)
        batch["seed_nodes"], batch["seed_times"] = seed_nodes, seed_times
        batch["nbr_ids"], batch["nbr_times"] = blk.nbr_ids, blk.nbr_times
        batch["nbr_eids"], batch["nbr_mask"] = blk.nbr_eids, blk.mask

        eids = batch.meta.get("eids")
        n = len(src)
        eids_full = np.full(n, -1, dtype=np.int64)
        if eids is not None:
            eids_full[: len(eids)] = eids
        valid = _host(batch["batch_mask"]) if "batch_mask" in batch \
            else np.ones(n, bool)
        self.sampler.update(src, dst, t, eids_full, valid=valid)
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
    narrowed to int32, as the reference stages for its jitted models);
    tensors already on the device pass through. ``pool`` (a
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
            batch[key] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return batch


class DeviceTransferHook(Hook):
    """Moves all array attributes to a torch device (paper Table 2: R=∅,
    P=∅). Register last; ordering among contract-free hooks follows
    registration."""

    def __init__(self, device="cuda"):
        super().__init__(requires=set(), produces=set())
        self._device = resolve_device(device)

    def __call__(self, batch: Batch) -> Batch:
        return stage_batch(batch, self._device)
