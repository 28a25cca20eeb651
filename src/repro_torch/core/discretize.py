"""Graph discretization ``psi_r`` (paper Def. 3.5).

Maps a temporal graph at native granularity ``tau`` to a coarser granularity
``tau_hat``, grouping events into equivalence classes ``(floor(t/k), src,
dst)`` and applying a reduction ``r`` to each class's features.

Port of ``repro.core.discretize``:

  * ``discretize`` — the vectorized numpy path (lexsort + reduceat), a
    bit-equal copy of the reference's host path;
  * ``discretize_edges_padded`` — the fixed-capacity core in torch tensor
    ops, on whatever device its inputs lie (three stable argsorts, a
    cumsum, the head scatter, the reduces through ``index_add_`` and
    ``scatter_reduce``): what ``core.loader.snapshot_tensor`` runs on the
    card; ``device_discretize_supported`` is its int32 guard (the
    reference's ``jax_discretize_supported``) and ``_host_ticks`` stages
    timestamps for it;
  * ``discretize_device`` — the whole-graph device form (the reference's
    ``discretize_jax``): the core at ``capacity=E`` on the card, one read
    of the valid count, node events collapsed by ``torch.unique``;
    ``discretize(..., backend="device")`` reaches it;
  * ``discretize_naive`` — the UTG-style dict baseline, a copy of the
    reference's: Table 5's comparison point and the oracle of the tests.

Reductions: first | last | sum | mean | max | count.
``count`` appends (or creates) a 1-dim feature holding the multiplicity.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.granularity import TimeDelta
from repro_torch.core.graph import DGData
from repro_torch.device import host_tensor, resolve_device

_REDUCTIONS = ("first", "last", "sum", "mean", "max", "count")

_I32_SENTINEL = 2**31 - 1


def _coarse_ticks(data: DGData, new_gran: TimeDelta) -> int:
    native = data.granularity
    if native.is_event_ordered or new_gran.is_event_ordered:
        raise TypeError(
            "discretization requires real-time granularities; the "
            "event-ordered granularity is excluded from time ops (paper §3)"
        )
    return new_gran.ticks_per(native)


def _group_boundaries(
    src: np.ndarray, dst: np.ndarray, ct: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Stable group-by (ct, src, dst) on time-sorted input.

    Returns (order, starts): ``order`` is a stable lexsort permutation
    grouping equal keys contiguously while preserving time order within a
    group; ``starts`` indexes group heads in the permuted arrays.
    """
    # np.lexsort is stable; last key is primary.
    order = np.lexsort((dst, src, ct))
    s, d, c = src[order], dst[order], ct[order]
    if len(s) == 0:
        return order, np.zeros(0, dtype=np.int64)
    new_group = np.empty(len(s), dtype=bool)
    new_group[0] = True
    new_group[1:] = (c[1:] != c[:-1]) | (s[1:] != s[:-1]) | (d[1:] != d[:-1])
    starts = np.flatnonzero(new_group).astype(np.int64)
    return order, starts


def _reduce_feats(
    feats: Optional[np.ndarray],
    order: np.ndarray,
    starts: np.ndarray,
    counts: np.ndarray,
    reduce: str,
) -> Optional[np.ndarray]:
    if reduce == "count":
        base = None if feats is None else _reduce_feats(feats, order, starts, counts, "sum")
        cnt = counts.astype(np.float32)[:, None]
        return cnt if base is None else np.concatenate([base, cnt], axis=1)
    if feats is None:
        return None
    f = feats[order]
    if reduce == "first":
        return f[starts]
    if reduce == "last":
        ends = np.concatenate([starts[1:], [len(order)]]) - 1
        return f[ends]
    if reduce == "sum":
        return np.add.reduceat(f, starts, axis=0)
    if reduce == "mean":
        return np.add.reduceat(f, starts, axis=0) / counts.astype(np.float32)[:, None]
    if reduce == "max":
        return np.maximum.reduceat(f, starts, axis=0)
    raise ValueError(f"unknown reduction {reduce!r}; expected one of {_REDUCTIONS}")


def discretize(
    data: DGData, new_gran: TimeDelta, reduce: str = "first",
    backend: str = "numpy", device="cuda",
) -> DGData:
    """Vectorized ``psi_r(G, tau) -> (G_hat, tau_hat)``.

    ``backend="numpy"`` runs on the host; ``backend="device"`` runs
    ``discretize_device`` on ``device`` (the reference's ``"jax"``
    backend, whose name the port refuses).
    """
    if reduce not in _REDUCTIONS:
        raise ValueError(f"unknown reduction {reduce!r}; expected one of {_REDUCTIONS}")
    if backend == "device":
        return discretize_device(data, new_gran, reduce=reduce, device=device)
    if backend != "numpy":
        raise ValueError(
            f"unknown discretize backend {backend!r}; the port has 'numpy' "
            f"and 'device' (the reference's 'jax' backend is 'device' here)")
    k = _coarse_ticks(data, new_gran)
    ct = data.edge_t // k

    order, starts = _group_boundaries(data.src, data.dst, ct)
    counts = np.diff(np.concatenate([starts, [len(order)]]))

    new_feats = _reduce_feats(data.edge_feats, order, starts, counts, reduce)

    src, dst, t = data.src[order][starts], data.dst[order][starts], ct[order][starts]

    # Node events collapse the same way keyed by (ct, node); reduction 'last'
    # (the most recent feature wins within a bucket).
    node_ids = node_t = node_feats = None
    if data.node_ids is not None:
        nct = data.node_t // k
        norder = np.lexsort((data.node_ids, nct))
        ni, nc = data.node_ids[norder], nct[norder]
        if len(ni):
            new_g = np.empty(len(ni), dtype=bool)
            new_g[0] = True
            new_g[1:] = (nc[1:] != nc[:-1]) | (ni[1:] != ni[:-1])
            nstarts = np.flatnonzero(new_g).astype(np.int64)
            nends = np.concatenate([nstarts[1:], [len(ni)]]) - 1
            node_ids, node_t = ni[nstarts], nc[nstarts]
            if data.node_feats is not None:
                node_feats = data.node_feats[norder][nends]
        else:
            node_ids, node_t = ni, nc

    return DGData.from_arrays(
        src,
        dst,
        t,
        edge_feats=new_feats,
        node_ids=node_ids,
        node_t=node_t,
        node_feats=node_feats,
        static_node_feats=data.static_node_feats,
        granularity=new_gran,
        num_nodes=data.num_nodes,
    )


def device_discretize_supported(data: DGData, k: int,
                                edges_only: bool = False) -> bool:
    """True iff the int32 core (``discretize_edges_padded``) can represent
    this graph: coarse ticks must fit int32 (``max(t) // k < 2**31 - 1``);
    node ids fit int32 by construction. Raw timestamps beyond int32 are
    fine as long as the coarse ticks fit: ``_host_ticks`` pre-divides them
    on the host. Without ``edges_only`` the node-event collapse key
    ``tick * n + node`` must fit too. Anything larger takes the host numpy
    path (int64 throughout)."""
    n = max(int(data.num_nodes), 1)
    tmax = int(data.edge_t.max()) if len(data.edge_t) else 0
    if not edges_only and data.node_t is not None and len(data.node_t):
        tmax = max(tmax, int(data.node_t.max()))
        if (tmax // max(k, 1) + 1) * n >= 2**31:
            return False
    return tmax // max(k, 1) < _I32_SENTINEL


def _host_ticks(t: np.ndarray, k: int):
    """Timestamps staged for the int32 core: raw when they fit int32 (the
    core divides by ``k`` on the device), else pre-divided to coarse ticks
    on the host (int64 division; the guard ensures ticks fit) with the
    device-side divisor collapsing to 1. Returns ``(t_staged, k_device)``."""
    if len(t) and int(t.max()) >= _I32_SENTINEL:
        return t // k, 1
    return t, k


def _sink(size: int, fill, dtype, device, width=None):
    """A padded output of ``size`` rows plus one sink row past the end:
    torch raises on out-of-range scatter indices where JAX drops them, so
    every write the reference drops goes to the sink, which is sliced off."""
    shape = (size + 1,) if width is None else (size + 1, width)
    return torch.full(shape, fill, dtype=dtype, device=device)


def discretize_edges_padded(src, dst, t, feats, *, k: int, reduce: str,
                            capacity: int, feat_dim: int):
    """``psi_r`` over edge events with a fixed output capacity, in tensor
    ops on the inputs' device.

    The group-by ``(floor(t/k), src, dst)`` is a three-level stable argsort
    (no dense composite key, so int32 suffices for any graph passing
    ``device_discretize_supported``), and every output is padded to
    ``capacity``:

      src/dst : (capacity,) int32, coarse-tick-major sorted; 0 where padded
      ct      : (capacity,) int32 coarse ticks; int32-max sentinel where
                padded (keeps the array globally sorted for searchsorted)
      feats   : (capacity, feat_dim') float32 reduced features (or None when
                the input has none and ``reduce != 'count'``)
      count   : () int32 number of valid groups (callers check
                ``count <= capacity``; overflow drops the tail)

    Inputs must be time-sorted (as ``DGData`` guarantees) so the
    ``first``/``last`` reductions pick the chronologically first/last event
    of each class. ``t`` must fit int32 (``_host_ticks``).
    """
    e = src.shape[0]
    dev = src.device
    i32, f32 = torch.int32, torch.float32
    src = src.to(i32)
    dst = dst.to(i32)
    ct = t.to(i32) // k

    # Stable lexsort by (ct, src, dst): least-significant key first.
    order = torch.argsort(dst, stable=True)
    order = order[torch.argsort(src[order], stable=True)]
    order = order[torch.argsort(ct[order], stable=True)]
    cs, ss, ds = ct[order], src[order], dst[order]
    new = torch.ones(e, dtype=torch.bool, device=dev)
    if e > 1:
        new[1:] = (cs[1:] != cs[:-1]) | (ss[1:] != ss[:-1]) | (ds[1:] != ds[:-1])
    seg = torch.cumsum(new.to(i32), 0) - 1  # group id per sorted event
    count = new.sum().to(i32)
    # Groups past the capacity go to the sink, as the reference drops them.
    seg = torch.where(seg < capacity, seg, capacity)

    head = torch.where(new, seg, capacity)
    out_src = _sink(capacity, 0, i32, dev).index_copy_(0, head, ss)[:capacity]
    out_dst = _sink(capacity, 0, i32, dev).index_copy_(0, head, ds)[:capacity]
    out_ct = _sink(capacity, _I32_SENTINEL, i32, dev).index_copy_(
        0, head, cs)[:capacity]

    out_feats = None
    if feat_dim or reduce == "count":
        counts = _sink(capacity, 0.0, f32, dev).index_add_(
            0, seg, torch.ones(e, dtype=f32, device=dev))[:capacity]
        f = None if not feat_dim else feats[order].to(f32)  # None: "count"

        def seg_sum():
            return _sink(capacity, 0.0, f32, dev, f.shape[1]).index_add_(
                0, seg, f)[:capacity]

        if reduce in ("first", "last"):
            idx = torch.arange(e, device=dev)
            if reduce == "first":
                pick = _sink(capacity, e, torch.int64, dev).scatter_reduce_(
                    0, seg, idx, "amin")
            else:
                pick = _sink(capacity, -1, torch.int64, dev).scatter_reduce_(
                    0, seg, idx, "amax")
            pick = pick[:capacity].clamp(0, max(e - 1, 0))
            out_feats = f[pick] if e else f.new_zeros((capacity, f.shape[1]))
        elif reduce == "sum":
            out_feats = seg_sum()
        elif reduce == "mean":
            out_feats = seg_sum() / torch.clamp(counts, min=1.0)[:, None]
        elif reduce == "max":
            out_feats = _sink(capacity, -float("inf"), f32, dev,
                              f.shape[1]).scatter_reduce_(
                0, seg[:, None].expand(-1, f.shape[1]), f, "amax")[:capacity]
        elif reduce == "count":
            cnt = counts[:, None]
            out_feats = cnt if f is None else torch.cat([seg_sum(), cnt], 1)
        else:
            raise ValueError(
                f"unknown reduction {reduce!r}; expected one of {_REDUCTIONS}")
        if out_feats is not None:
            valid = torch.arange(capacity, device=dev) < count
            out_feats = torch.where(valid[:, None], out_feats, 0.0)
    return out_src, out_dst, out_ct, out_feats, count


def discretize_device(data: DGData, new_gran: TimeDelta, reduce: str = "first",
                      device="cuda") -> DGData:
    """``psi_r`` on ``device`` over the fixed-capacity core.

    Runs ``discretize_edges_padded`` at ``capacity=E`` (an upper bound on
    the number of classes), reads the valid count once and slices; node
    events collapse on the device too, keyed by ``tick * n + node`` with
    reduction 'last' (inputs are time-sorted, so the largest index of a
    key's events is its latest). A graph beyond the int32 guard
    (``device_discretize_supported``), or one without edge events, takes
    the host numpy path, as the reference's ``discretize_jax`` does.
    """
    if reduce not in _REDUCTIONS:
        raise ValueError(f"unknown reduction {reduce!r}; expected one of {_REDUCTIONS}")
    dev = resolve_device(device)
    k = _coarse_ticks(data, new_gran)
    e = data.num_edge_events
    if e == 0 or not device_discretize_supported(data, k):
        return discretize(data, new_gran, reduce=reduce, backend="numpy")
    n = max(int(data.num_nodes), 1)

    def put(a, dtype=None):
        return host_tensor(np.asarray(a, dtype=dtype)).to(dev)

    feat_dim = data.edge_feat_dim
    feats_in = (torch.zeros((e, 0), dtype=torch.float32, device=dev)
                if feat_dim == 0 else put(data.edge_feats, np.float32))
    t_staged, k_dev = _host_ticks(data.edge_t, k)
    usrc, udst, ut, feats, count = discretize_edges_padded(
        put(data.src), put(data.dst), put(t_staged), feats_in,
        k=k_dev, reduce=reduce, capacity=e, feat_dim=feat_dim)
    g = int(count)  # one host read to slice the valid prefix

    node_kwargs = {}
    if data.node_ids is not None:
        nids = put(data.node_ids)
        nt_staged, nk_dev = _host_ticks(data.node_t, k)
        nct = put(nt_staged) // nk_dev
        if len(data.node_ids):
            nukey, nseg = torch.unique(nct * n + nids, return_inverse=True)
            node_kwargs = dict(node_ids=(nukey % n).cpu().numpy(),
                               node_t=(nukey // n).cpu().numpy())
            if data.node_feats is not None:
                idx = torch.arange(len(nseg), device=dev)
                npick = torch.full((len(nukey),), -1, dtype=idx.dtype,
                                   device=dev).scatter_reduce_(0, nseg, idx, "amax")
                node_kwargs["node_feats"] = put(data.node_feats)[npick].cpu().numpy()
        else:
            node_kwargs = dict(node_ids=nids.cpu().numpy(),
                               node_t=nct.cpu().numpy())

    return DGData.from_arrays(
        usrc[:g].cpu().numpy(),
        udst[:g].cpu().numpy(),
        ut[:g].cpu().numpy(),
        edge_feats=None if feats is None else feats[:g].cpu().numpy(),
        static_node_feats=data.static_node_feats,
        granularity=new_gran,
        num_nodes=data.num_nodes,
        **node_kwargs,
    )


def discretize_naive(data: DGData, new_gran: TimeDelta, reduce: str = "first") -> DGData:
    """UTG-style dict-based baseline (deliberately unvectorized).

    This mirrors the reference implementation the paper benchmarks against in
    Table 5: python loops over events, dict of (snapshot, src, dst) keys.
    """
    k = _coarse_ticks(data, new_gran)
    groups: dict = {}
    for i in range(data.num_edge_events):
        key = (int(data.edge_t[i]) // k, int(data.src[i]), int(data.dst[i]))
        groups.setdefault(key, []).append(i)

    keys = sorted(groups.keys())
    src = np.array([kk[1] for kk in keys], dtype=np.int64)
    dst = np.array([kk[2] for kk in keys], dtype=np.int64)
    t = np.array([kk[0] for kk in keys], dtype=np.int64)
    feats = None
    if data.edge_feats is not None or reduce == "count":
        rows = []
        for kk in keys:
            idx = groups[kk]
            if data.edge_feats is None:
                rows.append(np.array([len(idx)], dtype=np.float32))
                continue
            f = data.edge_feats[idx]
            if reduce == "first":
                r = f[0]
            elif reduce == "last":
                r = f[-1]
            elif reduce == "sum":
                r = f.sum(0)
            elif reduce == "mean":
                r = f.mean(0)
            elif reduce == "max":
                r = f.max(0)
            elif reduce == "count":
                r = np.concatenate([f.sum(0), [np.float32(len(idx))]])
            rows.append(r)
        feats = np.stack(rows).astype(np.float32)

    return DGData.from_arrays(
        src, dst, t, edge_feats=feats,
        static_node_feats=data.static_node_feats,
        granularity=new_gran, num_nodes=data.num_nodes,
    )
