"""Device-resident recency sampling in PyTorch.

``DeviceRecencySampler`` keeps the per-node circular buffers of the K most
recent interactions on the device, in the packed layout of the reference
(``repro.core.device_sampler``):

  ``buf``: (N+1, K, 3) int32 — channels = (neighbor id, time, edge id)
  ``cc``:  (N+1, 2)    int32 — columns  = (cursor, count)

Row ``N`` is a write sink for dropped/padded events and is never read.
``state_dict`` speaks the canonical ``ids/times/eids/cursor/count`` host
contract, so its output is bit-equal to the reference sampler's.

Slot assignment is the reference's segment-cumsum scheme in torch ops:

  1. sort one int64 key ``node * m + stream_pos`` (groups by node, keeps
     stream order inside a group; int64 cannot overflow, so the reference's
     int32 fallback sort is not needed);
  2. sequence number within the group from a running max over group heads
     (``torch.cummax``) and multiplicity from a reverse running min over
     group tails (``cummin`` on the flipped stream);
  3. only the last K events of each node survive, each to a distinct
     ``(node, (cursor + seq) % K)`` cell; duplicate scatter targets occur
     only in the sink row, which is never read.

**Predict-then-reveal.** ``update`` writes into fresh tensors (one ~1 MB
clone of the buffer per batch at the quickstart size) and never mutates
the tensors it replaces, so a ``packed_buffer`` reference taken before an
update stays the pre-update snapshot — the fused attention reads the state
a batch was sampled from, as JAX's immutable arrays guarantee in the
reference.

**Node-sharded** (``mesh=``, ``docs/sharding.md``): over the ``mesh_axis``
ranks of a ``DeviceMesh``, the rank at coordinate ``s`` owns nodes
``[s * per, (s + 1) * per)`` (``per = ceil(N / shards)``) and holds only
their ``(per + 1, K, 3)`` block, with its own sink at local row ``per``.
Every rank sees the same (replicated) batch. ``update`` is rank-local:
owned events go to their local rows, everything else (other ranks' nodes
and padding) to the local sink, through the same ``_insert_stream``, so an
owned row evolves exactly as on one device. ``sample`` gathers the owned
seeds (the rest read zeros), one ``all_reduce`` over the axis's group
assembles every seed's row from its single owner, and the count mask runs
replicated: the result is bit-equal to the one-device sampler at any shard
count. ``state_dict`` assembles the canonical host layout (one more
``all_reduce``, every rank gets it) and ``load_state_dict`` repacks any
canonical state for this rank's block, so checkpoints move across mesh
shapes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.sampler import NeighborBlock
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (
    all_reduce_flat,
    axis_group,
    axis_index,
    axis_size,
    node_rows_per_shard,
)


def as_int32(a, name: str, device) -> torch.Tensor:
    """Narrow host arrays to an int32 device tensor, loudly rejecting values
    that would wrap (silent truncation would break parity with the int64
    host layer). Torch tensors are cast and moved without a range check."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32)
    a = np.asarray(a)
    if a.dtype.itemsize > 4 and a.size and (
            a.max() >= 2**31 or a.min() < -(2**31)):
        raise ValueError(
            f"{name} exceeds int32 range; rescale (e.g. coarser time "
            f"granularity / epoch-relative timestamps) before device sampling"
        )
    return torch.as_tensor(a.astype(np.int32, copy=False), device=device)


def _event_stream(src, dst, t, eids, valid, *, directed: bool):
    """Flatten a batch into the (nodes, ok, vals) insertion stream.

    Directed: one stream position per event (src gets dst). Undirected:
    interleaved src/dst copies (event i -> stream positions 2i, 2i+1) so
    the flattened stream preserves exact sequential insertion order.
    """
    if directed:
        return src, valid, torch.stack([dst, t, eids], dim=-1)
    nodes = torch.stack([src, dst], 1).reshape(-1)
    ok = torch.stack([valid, valid], 1).reshape(-1)
    vals = torch.stack([
        torch.stack([dst, src], 1).reshape(-1),
        torch.stack([t, t], 1).reshape(-1),
        torch.stack([eids, eids], 1).reshape(-1),
    ], dim=-1)
    return nodes, ok, vals


def _insert_stream(state, nodes, ok, vals, *, k: int):
    """Scatter an insertion stream into fresh copies of the circular
    buffers; the input ``state`` tensors are left untouched."""
    sink = state["cc"].shape[0] - 1
    m = nodes.shape[0]
    dev = nodes.device
    nodes = torch.where(ok, nodes.long(), sink)
    idx = torch.arange(m, device=dev)

    skey = torch.sort(nodes * m + idx).values
    sn = skey // m
    pos = skey % m

    brk = sn[1:] != sn[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    group_start = torch.cat([one, brk])
    group_end = torch.cat([brk, one])
    head = torch.cummax(torch.where(group_start, idx, -1), 0).values
    seq = idx - head
    tail_in = torch.where(group_end, idx + 1, m).flip(0)
    tail = torch.cummin(tail_in, 0).values.flip(0)
    mult = tail - head

    survives = (seq >= mult - k) & (sn != sink)
    tgt = torch.where(survives, sn, sink)
    cc_old = state["cc"][sn].long()
    cur = cc_old[:, 0]
    slots = torch.where(survives, (cur + seq) % k, idx % k)
    buf = state["buf"].clone()
    buf[tgt, slots] = vals[pos]

    chead = group_start & (sn != sink)
    ctgt = torch.where(chead, sn, sink)
    ccv = torch.stack([(cur + mult) % k,
                       torch.clamp(cc_old[:, 1] + mult, max=k)], dim=-1)
    cc = state["cc"].clone()
    cc[ctgt] = ccv.to(torch.int32)
    return {"buf": buf, "cc": cc}


def _gather_rows(state, rows_idx, *, k: int):
    """Per-row circular-buffer gather: (rows (B, K, 3), cc (B, 2))."""
    rows_idx = rows_idx.long()
    cc = state["cc"][rows_idx]
    offs = torch.arange(1, k + 1, dtype=torch.int32, device=cc.device)[None]
    raw = cc[:, :1] - offs
    slots = torch.where(raw < 0, raw + k, raw).long()
    return state["buf"][rows_idx[:, None], slots], cc


def _finish_sample(rows, cc, *, k: int):
    """Mask gathered rows by per-seed count -> (ids, times, eids, mask)."""
    ar = torch.arange(k, dtype=torch.int32, device=rows.device)[None]
    mask = ar < cc[:, 1:]
    ids = torch.where(mask, rows[..., 0], -1)
    times = torch.where(mask, rows[..., 1], 0)
    eids = torch.where(mask, rows[..., 2], -1)
    return ids, times, eids, mask


def _empty_rows(rows: int, k: int, device):
    """``rows`` empty buffer rows (ids/eids -1, times 0) and their zero
    cursor/count rows."""
    buf = torch.zeros((rows, k, 3), dtype=torch.int32, device=device)
    buf[..., 0] = -1
    buf[..., 2] = -1
    return buf, torch.zeros((rows, 2), dtype=torch.int32, device=device)


class DeviceRecencySampler:
    """PyTorch device-resident most-recent-K temporal neighbor sampler.

    Twin of ``repro.core.device_sampler.DeviceRecencySampler``: ``update``
    accepts an optional ``valid`` mask so padded fixed-shape batches route
    their padding to the sink row, and ``sample`` returns a fixed-shape
    ``NeighborBlock``. With ``mesh`` (a ``DeviceMesh``, e.g.
    ``distributed.sharding.make_node_mesh``) the buffers are partitioned by
    node id over ``mesh_axis``, this rank's block on ``device`` (the
    module docstring; ``docs/sharding.md``).
    """

    def __init__(self, num_nodes: int, k: int, directed: bool = False,
                 device="cuda", mesh=None, mesh_axis: str = "data"):
        if k <= 0:
            raise ValueError("k must be positive")
        self.num_nodes = int(num_nodes)
        self.k = int(k)
        self.directed = directed
        self.device = resolve_device(device)
        self._mesh = mesh
        if mesh is not None:
            if mesh_axis not in mesh.mesh_dim_names:
                raise ValueError(f"mesh has no axis {mesh_axis!r}; axes are "
                                 f"{mesh.mesh_dim_names}")
            self._group = axis_group(mesh, mesh_axis)
            shards = axis_size(mesh, mesh_axis)
            self._per = node_rows_per_shard(self.num_nodes, shards)
            self._lo = axis_index(mesh, mesh_axis) * self._per
        self.reset_state()

    @property
    def _owned(self) -> int:
        """The number of real nodes in this rank's block."""
        return max(min(self._lo + self._per, self.num_nodes) - self._lo, 0)

    def reset_state(self) -> None:
        """Reallocate empty buffers on the device: ids/eids -1, times 0,
        cursor/count 0 (this rank's ``per + 1`` rows when sharded)."""
        rows = self.num_nodes if self._mesh is None else self._per
        buf, cc = _empty_rows(rows + 1, self.k, self.device)
        self.state = {"buf": buf, "cc": cc}

    @property
    def buffer_ids(self) -> torch.Tensor:
        """The packed buffer's neighbor-id rows, ``(rows, K)`` int32: on one
        device ``N + 1`` rows (sink last); sharded, this rank's
        ``rows_per_shard + 1`` rows (its sink last)."""
        return self.state["buf"][..., 0]

    @property
    def packed_buffer(self) -> torch.Tensor:
        """Packed rows (id, time, edge id) — what ``fused_temporal_layer``
        consumes; never mutated in place. One device: ``(N+1, K, 3)``, sink
        row last. Sharded: this rank's ``(rows_per_shard + 1, K, 3)``
        block, sink last; node ids are then not row indices — read it
        through ``fused_temporal_layer_sharded``."""
        return self.state["buf"]

    @property
    def rows_per_shard(self):
        """Node rows owned per shard (``ceil(N / shards)``) when sharded;
        ``None`` on one device."""
        return None if self._mesh is None else self._per

    def update(self, src, dst, t, eids=None, valid=None) -> None:
        """Insert a time-ordered batch of edges into the circular buffers.

        ``src``/``dst``/``t`` are (B,) host arrays or tensors; ``eids``
        defaults to -1 (no edge-feature association); ``valid`` is an
        optional (B,) bool mask (invalid rows go to the sink row). Sharded,
        each rank inserts the events of the nodes it owns.
        """
        dev = self.device
        src = as_int32(src, "src", dev)
        if src.shape[0] == 0:
            return
        eids = (torch.full(src.shape, -1, dtype=torch.int32, device=dev)
                if eids is None else as_int32(eids, "eids", dev))
        valid = (torch.ones(src.shape, dtype=torch.bool, device=dev)
                 if valid is None
                 else torch.as_tensor(valid, dtype=torch.bool, device=dev))
        dst = as_int32(dst, "dst", dev)
        t = as_int32(t, "t", dev)
        nodes, ok, vals = _event_stream(src, dst, t, eids, valid,
                                        directed=self.directed)
        if self._mesh is not None:
            lo, per = self._lo, self._per
            ok = ok & (nodes >= lo) & (nodes < lo + per)
            nodes = torch.where(ok, nodes - lo, per)
        self.state = _insert_stream(self.state, nodes, ok, vals, k=self.k)

    def _sharded_rows(self, seeds):
        """Each seed's gathered rows and cursor/count from its owner: the
        owned seeds' local rows (zeros for the rest), summed over the
        node axis in one ``all_reduce``."""
        lo, per, k = self._lo, self._per, self.k
        owned = (seeds >= lo) & (seeds < lo + per)
        rows, cc = _gather_rows(self.state, torch.where(owned, seeds - lo, per),
                                k=k)
        both = torch.cat([rows.reshape(-1, 3 * k), cc], dim=1)
        both = torch.where(owned[:, None], both, 0)
        dist.all_reduce(both, group=self._group)
        return both[:, :3 * k].reshape(-1, k, 3), both[:, 3 * k:]

    def sample(self, seeds, query_t=None) -> NeighborBlock:
        """Gather each seed's (up to) K most recent neighbors on the device,
        most-recent-first, padded with -1 ids / 0 times. ``query_t`` (B,)
        optionally masks neighbors newer than each seed's query time (the
        online service's guard: ids and eids -1, times 0, mask False
        there), as the reference's does. Sharded, every rank of the axis
        calls it with the same seeds and gets the same block."""
        seeds = as_int32(seeds, "seeds", self.device)
        if self._mesh is None:
            rows, cc = _gather_rows(self.state, seeds, k=self.k)
        else:
            rows, cc = self._sharded_rows(seeds)
        ids, times, eids, mask = _finish_sample(rows, cc, k=self.k)
        if query_t is not None:
            qt = as_int32(query_t, "query_t", self.device)[:, None]
            mask = mask & (times <= qt)
            ids = torch.where(mask, ids, -1)
            times = torch.where(mask, times, 0)
            eids = torch.where(mask, eids, -1)
        return NeighborBlock(ids, times, eids, mask)

    # -- checkpoint contract (shared with the reference samplers) ---------
    def _canonical(self):
        """The canonical ``(N, K, 3)`` buffer and ``(N, 2)`` cursor/count
        rows on the device (sinks stripped; sharded, assembled from every
        rank's block by one ``all_reduce`` of zero-filled arrays with one
        owner per row)."""
        if self._mesh is None:
            return self.state["buf"][:-1], self.state["cc"][:-1]
        n, k, lo, m = self.num_nodes, self.k, self._lo, self._owned
        buf = torch.zeros((n, k, 3), dtype=torch.int32, device=self.device)
        cc = torch.zeros((n, 2), dtype=torch.int32, device=self.device)
        buf[lo:lo + m] = self.state["buf"][:m]
        cc[lo:lo + m] = self.state["cc"][:m]
        return tuple(all_reduce_flat([buf, cc], self._group))

    def state_dict(self) -> dict:
        """Canonical host-numpy state ``{ids, times, eids, cursor, count}``
        (int64, sink rows stripped): the same at any shard count, and
        loadable by either package's recency samplers at any mesh shape.
        Sharded, every rank of the axis calls it."""
        buf, cc = (x.cpu().numpy() for x in self._canonical())
        return {
            "ids": buf[..., 0].astype(np.int64),
            "times": buf[..., 1].astype(np.int64),
            "eids": buf[..., 2].astype(np.int64),
            "cursor": cc[:, 0].astype(np.int64),
            "count": cc[:, 1].astype(np.int64),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore canonical buffers saved by any recency sampler at any
        mesh shape; sharded, this rank keeps its block of them."""
        buf = np.stack([np.asarray(state["ids"]),
                        np.asarray(state["times"]),
                        np.asarray(state["eids"])], axis=-1).astype(np.int32)
        cc = np.stack([np.asarray(state["cursor"]),
                       np.asarray(state["count"])], axis=-1).astype(np.int32)
        rows = self.num_nodes if self._mesh is None else self._per
        lo = 0 if self._mesh is None else self._lo
        m = self.num_nodes if self._mesh is None else self._owned
        full_buf, full_cc = _empty_rows(rows + 1, self.k, self.device)
        full_buf[:m] = torch.as_tensor(buf[lo:lo + m], device=self.device)
        full_cc[:m] = torch.as_tensor(cc[lo:lo + m], device=self.device)
        self.state = {"buf": full_buf, "cc": full_cc}
