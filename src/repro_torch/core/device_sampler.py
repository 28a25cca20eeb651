"""Device-resident recency sampling in PyTorch (single device).

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
reference. The ``mesh=`` sharded path waits for the multi-GPU slice.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sampler import NeighborBlock
from repro_torch.device import resolve_device


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


class DeviceRecencySampler:
    """PyTorch device-resident most-recent-K temporal neighbor sampler.

    Twin of ``repro.core.device_sampler.DeviceRecencySampler`` on one
    device: ``update`` accepts an optional ``valid`` mask so padded
    fixed-shape batches route their padding to the sink row, and
    ``sample`` returns a fixed-shape ``NeighborBlock``.
    """

    def __init__(self, num_nodes: int, k: int, directed: bool = False,
                 device="cuda"):
        if k <= 0:
            raise ValueError("k must be positive")
        self.num_nodes = int(num_nodes)
        self.k = int(k)
        self.directed = directed
        self.device = resolve_device(device)
        self.reset_state()

    def reset_state(self) -> None:
        """Reallocate empty buffers on the device: ids/eids -1, times 0,
        cursor/count 0."""
        n, k, dev = self.num_nodes, self.k, self.device
        buf = torch.zeros((n + 1, k, 3), dtype=torch.int32, device=dev)
        buf[..., 0] = -1
        buf[..., 2] = -1
        self.state = {"buf": buf,
                      "cc": torch.zeros((n + 1, 2), dtype=torch.int32,
                                        device=dev)}

    @property
    def packed_buffer(self) -> torch.Tensor:
        """(N+1, K, 3) packed rows (id, time, edge id), sink row last —
        what ``fused_temporal_layer`` consumes. Never mutated in place."""
        return self.state["buf"]

    def update(self, src, dst, t, eids=None, valid=None) -> None:
        """Insert a time-ordered batch of edges into the circular buffers.

        ``src``/``dst``/``t`` are (B,) host arrays or tensors; ``eids``
        defaults to -1 (no edge-feature association); ``valid`` is an
        optional (B,) bool mask (invalid rows go to the sink row N).
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
        self.state = _insert_stream(self.state, nodes, ok, vals, k=self.k)

    def sample(self, seeds, query_t=None) -> NeighborBlock:
        """Gather each seed's (up to) K most recent neighbors on the device,
        most-recent-first, padded with -1 ids / 0 times. ``query_t`` (B,)
        optionally masks neighbors newer than each seed's query time (the
        online service's guard: ids and eids -1, times 0, mask False
        there), as the reference's does."""
        seeds = as_int32(seeds, "seeds", self.device)
        rows, cc = _gather_rows(self.state, seeds, k=self.k)
        ids, times, eids, mask = _finish_sample(rows, cc, k=self.k)
        if query_t is not None:
            qt = as_int32(query_t, "query_t", self.device)[:, None]
            mask = mask & (times <= qt)
            ids = torch.where(mask, ids, -1)
            times = torch.where(mask, times, 0)
            eids = torch.where(mask, eids, -1)
        return NeighborBlock(ids, times, eids, mask)

    # -- checkpoint contract (shared with the reference samplers) ---------
    def state_dict(self) -> dict:
        """Canonical host-numpy state ``{ids, times, eids, cursor, count}``
        (int64, sink row stripped)."""
        buf = self.state["buf"][:-1].cpu().numpy()
        cc = self.state["cc"][:-1].cpu().numpy()
        return {
            "ids": buf[..., 0].astype(np.int64),
            "times": buf[..., 1].astype(np.int64),
            "eids": buf[..., 2].astype(np.int64),
            "cursor": cc[:, 0].astype(np.int64),
            "count": cc[:, 1].astype(np.int64),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore canonical buffers saved by any recency sampler."""
        buf = np.stack([np.asarray(state["ids"]),
                        np.asarray(state["times"]),
                        np.asarray(state["eids"])], axis=-1).astype(np.int32)
        cc = np.stack([np.asarray(state["cursor"]),
                       np.asarray(state["count"])], axis=-1).astype(np.int32)
        sink = np.zeros((1, self.k, 3), np.int32)
        sink[..., 0] = -1
        sink[..., 2] = -1
        self.state = {
            "buf": torch.as_tensor(np.concatenate([buf, sink]),
                                   device=self.device),
            "cc": torch.as_tensor(
                np.concatenate([cc, np.zeros((1, 2), np.int32)]),
                device=self.device),
        }
