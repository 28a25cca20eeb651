"""Immutable time-sorted COO storage and lightweight graph views (paper §4).

``DGData`` owns the event arrays (struct-of-arrays, time-sorted, with the
timestamp array doubling as a binary-search index). ``DGraph`` is a
lightweight *view*: a (storage, t_lo, t_hi, granularity) tuple that is O(1)
to create and concurrency-safe because the storage is immutable.

Root storage lives in host numpy; batches are moved to the device by the
hook pipeline (``DeviceTransferHook``). Host numpy copy of
``repro.core.graph`` (bit-equal), with discretization delegating to
``core.discretize`` and the DTDG ``SnapshotTensor`` view, whose tensors
``core.loader.snapshot_tensor`` builds on the device. ``DGData.from_csv``
parses in chunks (``iter_csv_chunks``); ``DGData.from_store`` views an
``repro_torch.storage.EventStore`` without copying its columns.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.granularity import TimeDelta


def _as_int64(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.int64))


def _as_f32(x) -> Optional[np.ndarray]:
    if x is None:
        return None
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def _int64_col(strings: np.ndarray) -> np.ndarray:
    """Parse a string column to int64 exactly; float-formatted cells
    ("3.0") fall back through float64 (truncating like the old
    ``genfromtxt`` path did)."""
    try:
        return strings.astype(np.int64)
    except ValueError:
        return strings.astype(np.float64).astype(np.int64)


def iter_csv_chunks(
    path: str,
    src_col: int = 0,
    dst_col: int = 1,
    t_col: int = 2,
    feat_cols: Optional[Sequence[int]] = None,
    delimiter: str = ",",
    skip_header: int = 1,
    chunk_rows: int = 1 << 16,
):
    """Stream a CSV of events as ``{"src", "dst", "t"[, "edge_feats"]}``
    numpy chunks of at most ``chunk_rows`` rows.

    Only one chunk is resident at a time: this is the parser behind both
    the chunked ``DGData.from_csv`` and the out-of-core
    ``repro_torch.storage.MmapStore.from_csv`` converter. Integer id/time
    columns parse straight to int64 (no float64 round-trip), features to
    float32. Blank lines are skipped.
    """
    if chunk_rows <= 0:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    fcols = list(feat_cols) if feat_cols else None
    with open(path) as f:
        for _ in range(skip_header):
            f.readline()
        while True:
            lines = []
            for line in f:
                if line.strip():
                    lines.append(line)
                if len(lines) >= chunk_rows:
                    break
            if not lines:
                return
            cells = np.array([ln.strip().split(delimiter) for ln in lines])
            chunk = {
                "src": _int64_col(cells[:, src_col]),
                "dst": _int64_col(cells[:, dst_col]),
                "t": _int64_col(cells[:, t_col]),
            }
            if fcols:
                chunk["edge_feats"] = cells[:, fcols].astype(np.float32)
            yield chunk


@dataclasses.dataclass(frozen=True)
class DGData:
    """Immutable temporal-graph storage.

    Edge events:  ``(edge_t[i], src[i], dst[i], edge_feats[i])`` sorted by t.
    Node events:  ``(node_t[j], node_ids[j], node_feats[j])`` sorted by t.
    ``static_node_feats`` is the optional ``X in R^{n x d_static}``.
    """

    src: np.ndarray
    dst: np.ndarray
    edge_t: np.ndarray
    edge_feats: Optional[np.ndarray] = None
    node_ids: Optional[np.ndarray] = None
    node_t: Optional[np.ndarray] = None
    node_feats: Optional[np.ndarray] = None
    static_node_feats: Optional[np.ndarray] = None
    granularity: TimeDelta = dataclasses.field(default_factory=TimeDelta.event)
    num_nodes: int = 0
    # Global index of this storage's first edge event in its root storage
    # (0 for unsliced data; set by ``slice_events``). Lets loaders emit
    # *global* event ids for sliced splits, so edge-feature lookups keyed by
    # eid stay correct across train/val/test iteration.
    eid_offset: int = 0

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    @classmethod
    def from_arrays(
        cls,
        src,
        dst,
        edge_t,
        edge_feats=None,
        node_ids=None,
        node_t=None,
        node_feats=None,
        static_node_feats=None,
        granularity: TimeDelta | str = "s",
        num_nodes: Optional[int] = None,
    ) -> "DGData":
        src, dst, edge_t = _as_int64(src), _as_int64(dst), _as_int64(edge_t)
        if not (len(src) == len(dst) == len(edge_t)):
            raise ValueError("src/dst/edge_t length mismatch")
        edge_feats = _as_f32(edge_feats)
        if edge_feats is not None and len(edge_feats) != len(src):
            raise ValueError("edge_feats length mismatch")

        # Stable sort by timestamp preserves intra-timestamp event order.
        order = np.argsort(edge_t, kind="stable")
        src, dst, edge_t = src[order], dst[order], edge_t[order]
        if edge_feats is not None:
            edge_feats = edge_feats[order]

        if node_ids is not None:
            node_ids, node_t = _as_int64(node_ids), _as_int64(node_t)
            node_feats = _as_f32(node_feats)
            norder = np.argsort(node_t, kind="stable")
            node_ids, node_t = node_ids[norder], node_t[norder]
            if node_feats is not None:
                node_feats = node_feats[norder]

        if num_nodes is None:
            hi = 0
            if len(src):
                hi = max(hi, int(src.max()) + 1, int(dst.max()) + 1)
            if node_ids is not None and len(node_ids):
                hi = max(hi, int(node_ids.max()) + 1)
            num_nodes = hi

        static_node_feats = _as_f32(static_node_feats)
        return cls(
            src=src,
            dst=dst,
            edge_t=edge_t,
            edge_feats=edge_feats,
            node_ids=node_ids,
            node_t=node_t,
            node_feats=node_feats,
            static_node_feats=static_node_feats,
            granularity=TimeDelta.coerce(granularity),
            num_nodes=num_nodes,
        )

    @classmethod
    def from_csv(
        cls,
        path: str,
        src_col: int = 0,
        dst_col: int = 1,
        t_col: int = 2,
        feat_cols: Optional[Sequence[int]] = None,
        delimiter: str = ",",
        skip_header: int = 1,
        granularity: TimeDelta | str = "s",
        chunk_rows: int = 1 << 16,
    ) -> "DGData":
        """CSV IO adapter (paper §4: custom adapters via CSV).

        The parse streams in ``chunk_rows``-line chunks
        (``iter_csv_chunks``): id/time columns are parsed straight to
        int64 (event ids stay int64 end-to-end until device staging — no
        float round-trip that could silently lose precision on huge
        streams) and features to float32, so peak parse memory is one
        chunk plus the final columns instead of the whole file's float64
        matrix. For streams that should never be fully resident, convert
        to a store instead: ``repro_torch.storage.MmapStore.from_csv``.
        """
        parts = {"src": [], "dst": [], "t": [], "edge_feats": []}
        for chunk in iter_csv_chunks(
            path, src_col=src_col, dst_col=dst_col, t_col=t_col,
            feat_cols=feat_cols, delimiter=delimiter,
            skip_header=skip_header, chunk_rows=chunk_rows,
        ):
            for k in ("src", "dst", "t"):
                parts[k].append(chunk[k])
            if "edge_feats" in chunk:
                parts["edge_feats"].append(chunk["edge_feats"])
        cat = lambda k, d: (
            np.concatenate(parts[k]) if parts[k] else np.empty((0,), d))
        feats = np.concatenate(parts["edge_feats"]) if parts["edge_feats"] else None
        return cls.from_arrays(
            cat("src", np.int64), cat("dst", np.int64), cat("t", np.int64),
            edge_feats=feats, granularity=granularity,
        )

    @classmethod
    def from_store(cls, store) -> "DGData":
        """Zero-copy ``DGData`` view over an ``EventStore`` backend.

        Columns are aliased, not copied: for ``InMemoryStore`` they are
        the same host arrays ``from_arrays`` would produce (bit-identical
        pipelines); for ``MmapStore`` they are read-only ``np.memmap``
        views, so slicing/splitting/loading downstream reads O(touched
        pages) from disk — the whole training stack runs off a store
        handle without ever materializing the stream (``docs/storage.md``).
        The store guarantees time-sorted columns, so no re-sort happens.
        """
        return cls(
            src=store.src,
            dst=store.dst,
            edge_t=store.edge_t,
            edge_feats=store.edge_feats,
            node_ids=store.node_ids,
            node_t=store.node_t,
            node_feats=store.node_feats,
            static_node_feats=store.static_node_feats,
            granularity=store.granularity,
            num_nodes=int(store.num_nodes),
        )

    def to_store(self):
        """This storage as an ``InMemoryStore`` (columns aliased, not
        copied) — the inverse of ``from_store`` for the default backend."""
        from repro_torch.storage import InMemoryStore

        return InMemoryStore.from_data(self)

    # ------------------------------------------------------------------
    # Basic properties
    # ------------------------------------------------------------------
    @property
    def num_edge_events(self) -> int:
        return len(self.src)

    @property
    def num_node_events(self) -> int:
        return 0 if self.node_ids is None else len(self.node_ids)

    @property
    def edge_feat_dim(self) -> int:
        return 0 if self.edge_feats is None else self.edge_feats.shape[1]

    @property
    def node_feat_dim(self) -> int:
        return 0 if self.node_feats is None else self.node_feats.shape[1]

    @property
    def time_span(self) -> Tuple[int, int]:
        """[min_t, max_t] over all events (edge + node)."""
        ts = [self.edge_t] if len(self.edge_t) else []
        if self.node_t is not None and len(self.node_t):
            ts.append(self.node_t)
        if not ts:
            return (0, 0)
        return (int(min(t[0] for t in ts)), int(max(t[-1] for t in ts)))

    # ------------------------------------------------------------------
    # Splits
    # ------------------------------------------------------------------
    def split(
        self, val_ratio: float = 0.15, test_ratio: float = 0.15
    ) -> Tuple["DGData", "DGData", "DGData"]:
        """Chronological split by edge-event count (TGB convention).

        Boundary timestamps are respected: the split points are snapped so a
        single timestamp never straddles two splits.
        """
        n = self.num_edge_events
        i_val = int(n * (1.0 - val_ratio - test_ratio))
        i_test = int(n * (1.0 - test_ratio))
        # Snap split indices to timestamp boundaries.
        i_val = int(np.searchsorted(self.edge_t, self.edge_t[min(i_val, n - 1)]))
        i_test = int(np.searchsorted(self.edge_t, self.edge_t[min(i_test, n - 1)]))
        t_val = int(self.edge_t[i_val]) if i_val < n else self.time_span[1] + 1
        t_test = int(self.edge_t[i_test]) if i_test < n else self.time_span[1] + 1
        return (
            self.slice_events(0, i_val, t_hi=t_val),
            self.slice_events(i_val, i_test, t_hi=t_test),
            self.slice_events(i_test, n, t_hi=None),
        )

    def slice_events(self, lo: int, hi: int, t_hi: Optional[int] = None) -> "DGData":
        """Sub-storage of edge events [lo, hi); node events filtered by time.

        ``lo == hi`` (an empty window) is valid and yields an empty slice;
        ``lo > hi`` or rows outside ``[0, num_edge_events]`` raise
        ``ValueError`` — silently clamping used to produce empty or
        misaligned feature slices downstream.
        """
        n = self.num_edge_events
        if lo > hi:
            raise ValueError(f"slice_events lo {lo} > hi {hi}")
        if lo < 0 or hi > n:
            raise ValueError(
                f"slice_events window [{lo}, {hi}) out of range [0, {n})")
        t_lo_bound = int(self.edge_t[lo]) if lo < self.num_edge_events and lo < hi else 0
        nsel = slice(0, 0)
        if self.node_ids is not None:
            n_lo = int(np.searchsorted(self.node_t, t_lo_bound, side="left"))
            n_hi = (
                int(np.searchsorted(self.node_t, t_hi, side="left"))
                if t_hi is not None
                else len(self.node_t)
            )
            nsel = slice(n_lo, n_hi)
        return dataclasses.replace(
            self,
            src=self.src[lo:hi],
            dst=self.dst[lo:hi],
            edge_t=self.edge_t[lo:hi],
            edge_feats=None if self.edge_feats is None else self.edge_feats[lo:hi],
            node_ids=None if self.node_ids is None else self.node_ids[nsel],
            node_t=None if self.node_t is None else self.node_t[nsel],
            node_feats=None if self.node_feats is None else self.node_feats[nsel],
            eid_offset=self.eid_offset + lo,
        )

    # ------------------------------------------------------------------
    # Time index (binary search over the cached sorted timestamp array)
    # ------------------------------------------------------------------
    def edge_range(self, t_lo: Optional[int], t_hi: Optional[int]) -> Tuple[int, int]:
        """Edge-event index range with t in [t_lo, t_hi). O(log E)."""
        lo = 0 if t_lo is None else int(np.searchsorted(self.edge_t, t_lo, "left"))
        hi = (
            self.num_edge_events
            if t_hi is None
            else int(np.searchsorted(self.edge_t, t_hi, "left"))
        )
        return lo, hi

    def node_event_range(self, t_lo, t_hi) -> Tuple[int, int]:
        """Node-event index range with t in [t_lo, t_hi). O(log #events)."""
        if self.node_t is None:
            return 0, 0
        lo = 0 if t_lo is None else int(np.searchsorted(self.node_t, t_lo, "left"))
        hi = (
            len(self.node_t)
            if t_hi is None
            else int(np.searchsorted(self.node_t, t_hi, "left"))
        )
        return lo, hi

    # ------------------------------------------------------------------
    # Discretization (delegates; see core/discretize.py and core/loader.py)
    # ------------------------------------------------------------------
    def discretize(
        self,
        granularity: TimeDelta | str,
        reduce: str = "first",
        backend: str = "numpy",
        device="cuda",
    ) -> "DGData":
        """Coarsen to ``granularity`` via ``psi_r`` (``core/discretize.py``):
        on the host with ``backend="numpy"``, on ``device`` with
        ``backend="device"``."""
        from repro_torch.core.discretize import discretize as _disc

        return _disc(self, TimeDelta.coerce(granularity), reduce=reduce,
                     backend=backend, device=device)

    def to_snapshots(
        self,
        granularity: TimeDelta | str,
        capacity: Optional[int] = None,
        device="cuda",
    ) -> "SnapshotTensor":
        """Tensorize this storage into a ``SnapshotTensor`` on ``device``
        (delegates to ``core.loader.snapshot_tensor``)."""
        from repro_torch.core.loader import snapshot_tensor

        return snapshot_tensor(self, granularity, capacity=capacity,
                               device=device)


@dataclasses.dataclass(frozen=True)
class SnapshotTensor:
    """Device-resident DTDG view: the discretized stream as padded tensors.

    Built once per (storage, granularity) by ``core.loader.snapshot_tensor``,
    which collapses duplicate ``(tick, src, dst)`` classes on the device and
    lays the classes out snapshot-major:

      ``src``/``dst`` : (T, capacity) int32, zero where padded
      ``mask``        : (T, capacity) bool edge-validity mask
      ``counts``      : (T,) int32 valid edges per snapshot (empty windows
                        are all-False rows)

    Row ``i`` is the snapshot ``G|_[(t0+i)*k, (t0+i+1)*k)`` of the source
    stream (``k`` = ``ticks`` native ticks per snapshot). Every row has the
    same shape, so a whole epoch runs one step function over the rows.
    """

    src: object
    dst: object
    mask: object
    counts: object
    t0: int
    ticks: int
    unit: TimeDelta
    num_nodes: int

    @property
    def num_snapshots(self) -> int:
        """T: number of snapshot rows (including empty windows)."""
        return int(self.src.shape[0])

    @property
    def capacity(self) -> int:
        """Fixed per-snapshot edge capacity (padded width)."""
        return int(self.src.shape[1])

    def row(self, i: int) -> dict:
        """One snapshot's padded tensors: ``{src, dst, snap_mask}``."""
        return {"src": self.src[i], "dst": self.dst[i],
                "snap_mask": self.mask[i]}

    def row_of_time(self, t: int) -> int:
        """Snapshot row index containing native-granularity time ``t``."""
        return int(t) // self.ticks - self.t0

    def negatives(self, seed: int, num_negatives: int, rows=None):
        """Per-snapshot negative destinations ``(R, capacity, m)`` int32 on
        this view's device for ``rows`` (default: every snapshot); pure in
        ``(seed, m, row)`` (``core.negatives.snapshot_negatives``)."""
        from repro_torch.core.negatives import snapshot_negatives

        if rows is None:
            rows = np.arange(self.num_snapshots)
        return snapshot_negatives(seed, self.num_nodes, self.capacity,
                                  num_negatives, rows, device=self.src.device)


class DGraph:
    """Lightweight, concurrency-safe view over a ``DGData`` storage.

    Tracks time boundaries ``[t_lo, t_hi)`` and the iteration granularity.
    Creating or slicing a view never copies event arrays.
    """

    __slots__ = ("data", "t_lo", "t_hi", "granularity", "device")

    def __init__(
        self,
        data: DGData,
        t_lo: Optional[int] = None,
        t_hi: Optional[int] = None,
        granularity: Optional[TimeDelta | str] = None,
        device: str = "cpu",
    ):
        self.data = data
        span = data.time_span
        self.t_lo = span[0] if t_lo is None else int(t_lo)
        self.t_hi = span[1] + 1 if t_hi is None else int(t_hi)
        g = data.granularity if granularity is None else TimeDelta.coerce(granularity)
        if not g.is_event_ordered and not data.granularity.is_event_ordered:
            if not g.is_coarser_or_equal(data.granularity):
                raise ValueError(
                    f"view granularity {g} must be >= native {data.granularity}"
                )
        self.granularity = g
        self.device = device

    # -- slicing -----------------------------------------------------------
    def slice_time(self, t_lo: int, t_hi: int) -> "DGraph":
        """Temporal sub-graph G|_[t_lo, t_hi). O(1)."""
        return DGraph(
            self.data,
            max(self.t_lo, t_lo),
            min(self.t_hi, t_hi),
            self.granularity,
            self.device,
        )

    # -- statistics ---------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return self.data.num_nodes

    @property
    def num_edge_events(self) -> int:
        lo, hi = self.data.edge_range(self.t_lo, self.t_hi)
        return hi - lo

    @property
    def num_node_events(self) -> int:
        lo, hi = self.data.node_event_range(self.t_lo, self.t_hi)
        return hi - lo

    def edge_slice(self) -> Tuple[int, int]:
        """Edge-event index range [lo, hi) of this view in its storage."""
        return self.data.edge_range(self.t_lo, self.t_hi)

    # -- materialization -----------------------------------------------------
    def materialize(self, lo: Optional[int] = None, hi: Optional[int] = None) -> dict:
        """Raw event arrays for edge-index range [lo, hi) within the view."""
        vlo, vhi = self.edge_slice()
        lo = vlo if lo is None else max(vlo, lo)
        hi = vhi if hi is None else min(vhi, hi)
        d = self.data
        out = {
            "src": d.src[lo:hi],
            "dst": d.dst[lo:hi],
            "time": d.edge_t[lo:hi],
        }
        if d.edge_feats is not None:
            out["edge_feats"] = d.edge_feats[lo:hi]
        if d.node_ids is not None and hi > lo:
            t0 = int(d.edge_t[lo]) if hi > lo else self.t_lo
            t1 = int(d.edge_t[hi - 1]) + 1 if hi > lo else self.t_hi
            nlo, nhi = d.node_event_range(t0, t1)
            out["node_event_ids"] = d.node_ids[nlo:nhi]
            out["node_event_time"] = d.node_t[nlo:nhi]
            if d.node_feats is not None:
                out["node_event_feats"] = d.node_feats[nlo:nhi]
        return out

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"DGraph(nodes={self.num_nodes}, edges={self.num_edge_events}, "
            f"t=[{self.t_lo},{self.t_hi}), gran={self.granularity})"
        )
