"""Pluggable event-storage backends: the ``EventStore`` contract.

Everything upstream of this package (``DGData``, loaders, samplers, the
``tg.Experiment`` front door) consumes a temporal event stream as sorted
columnar arrays — ``src``/``dst``/``edge_t`` plus optional edge/node
features. ``EventStore`` makes the *residence* of those columns pluggable:

  * :class:`~repro_torch.storage.memory.InMemoryStore` wraps host numpy arrays —
    the bit-identical default, zero behavior change vs. raw ``DGData``;
  * :class:`~repro_torch.storage.mmap.MmapStore` memory-maps one ``.npy`` file
    per column from an on-disk directory with a fsync'd JSON manifest, so
    TGB-scale streams iterate with O(window) resident memory.

The contract (``docs/storage.md``) is deliberately small: column
attributes (any ``np.ndarray``-compatible type — ``np.memmap`` included),
``edge_range``/``node_event_range`` binary-search range queries with the
exact ``DGData`` semantics, bounds-checked row windows (``edge_window``),
and resumable windowed iteration (``iter_windows``) whose host batches
feed ``PrefetchLoader`` via :class:`~repro_torch.storage.windows.StoreEventLoader`.
``DGData.from_store`` lifts any backend into the existing array-of-struct
API without copying, which is how the rest of the stack becomes
backend-agnostic.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple, Union

import numpy as np

from repro_torch.core.granularity import TimeDelta


@dataclasses.dataclass(frozen=True)
class EventWindow:
    """One contiguous slice ``[lo, hi)`` of a store's edge-event stream.

    Arrays are host views into the backend's columns (numpy views for
    ``InMemoryStore``, memmap views for ``MmapStore`` — nothing is copied
    until a consumer writes or stages to device). ``eids`` are *global*
    event ids (row indices, int64 end-to-end until device staging).
    ``window`` is the ``(t_lo, t_hi)`` wall-clock bound for time-windowed
    iteration, ``None`` for event-count windows.
    """

    lo: int
    hi: int
    src: np.ndarray
    dst: np.ndarray
    t: np.ndarray
    eids: np.ndarray
    edge_feats: Optional[np.ndarray] = None
    window: Optional[Tuple[int, int]] = None

    def __len__(self) -> int:
        return self.hi - self.lo

    def to_batch(self):
        """This window as a loader-compatible ``core.Batch`` (``src``/
        ``dst``/``time``[/``edge_feats``] data keys; ``eids``/``window``
        meta) — the shape every hook in ``RECIPE_TGB_LINK`` expects."""
        from repro_torch.core.batch import Batch

        raw = {"src": self.src, "dst": self.dst, "time": self.t}
        if self.edge_feats is not None:
            raw["edge_feats"] = self.edge_feats
        return Batch(raw, {"eids": self.eids, "window": self.window})


class WindowIterator:
    """Resumable iterator over a store's event windows.

    Produced by :meth:`EventStore.iter_windows`. The cursor —
    ``state_dict()`` → ``{"row", "tick"}`` — is plain int64 numpy, so it
    rides any checkpoint tree (``distributed/checkpoint``) and resuming
    mid-stream (``iter_windows(..., start=state)``) replays the remaining
    windows bit-identically (see ``tests/test_torch_storage.py``).
    """

    def __init__(self, store: "EventStore", batch_size: Optional[int],
                 time_window: Optional[int], start: Union[None, int, dict],
                 emit_empty: bool, release: bool, telemetry=None):
        if (batch_size is None) == (time_window is None):
            raise ValueError("set exactly one of batch_size / time_window")
        if batch_size is not None and batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if time_window is not None:
            if store.granularity.is_event_ordered:
                raise ValueError(
                    "time_window iteration requires a real-time granularity; "
                    "this store is event-ordered — use batch_size"
                )
            if time_window <= 0:
                raise ValueError(
                    f"time_window must be positive, got {time_window}")
        from repro_torch.obs import NULL

        self._store = store
        self._batch_size = batch_size
        self._ticks = time_window
        self._emit_empty = emit_empty
        self._release = release
        self._telemetry = telemetry if telemetry is not None else NULL
        span = store.time_span
        self._t0, self._t_end = span[0], span[1] + 1
        if isinstance(start, dict):
            self._row = int(start["row"])
            self._tick = int(start["tick"])
        else:
            self._tick = 0
            self._row = 0 if start is None else int(start)
            if self._row:
                if batch_size is None:
                    raise ValueError(
                        "start= as a bare row only applies to batch_size "
                        "iteration; resume time windows from a state_dict")
                if self._row < 0 or self._row > store.num_edge_events:
                    raise ValueError(
                        f"start row {self._row} out of range "
                        f"[0, {store.num_edge_events}]")

    # -- checkpoint contract -------------------------------------------
    def state_dict(self) -> dict:
        """The resume cursor: next unread row (+ next tick for time
        windows), as int64 leaves for checkpoint trees."""
        return {"row": np.int64(self._row), "tick": np.int64(self._tick)}

    def __len__(self) -> int:
        if self._batch_size is not None:
            left = self._store.num_edge_events - self._row
            return -(-left // self._batch_size) if left > 0 else 0
        span = self._t_end - (self._t0 + self._tick * self._ticks)
        return max(int(np.ceil(span / self._ticks)), 0)

    def __iter__(self) -> Iterator[EventWindow]:
        if self._batch_size is not None:
            yield from self._iter_events()
        else:
            yield from self._iter_time()

    def _iter_events(self) -> Iterator[EventWindow]:
        n = self._store.num_edge_events
        while self._row < n:
            lo = self._row
            hi = min(lo + self._batch_size, n)
            w = self._store.edge_window(lo, hi)
            self._row = hi
            self._telemetry.count("storage/windows_read")
            yield w
            if self._release:
                self._store.release()
                self._telemetry.count("storage/windows_released")

    def _iter_time(self) -> Iterator[EventWindow]:
        while True:
            t = self._t0 + self._tick * self._ticks
            if t >= self._t_end:
                return
            t_next = min(t + self._ticks, self._t_end)
            lo, hi = self._store.edge_range(t, t_next)
            self._tick += 1
            self._row = hi
            if hi > lo or self._emit_empty:
                self._telemetry.count("storage/windows_read")
                yield self._store.edge_window(lo, hi, window=(t, t_next))
                if self._release:
                    self._store.release()
                    self._telemetry.count("storage/windows_released")


class EventStore:
    """Base class of the pluggable event-storage backends.

    Subclasses populate the column attributes (``src``/``dst``/``edge_t``
    int64 sorted by time, optional ``edge_feats`` float32, the optional
    node-event columns, ``static_node_feats``) plus ``num_nodes`` and
    ``granularity``; everything else — range queries, bounds-checked
    windows, resumable iteration — is implemented here against the
    contract. Columns may be any ndarray-compatible type; ``np.memmap``
    keeps the backend out-of-core. ``eids`` are implicit row indices
    (``[0, num_edge_events)``, int64) unless the backend stores an
    explicit ``eid`` column — see ``docs/storage.md``.
    """

    src: np.ndarray
    dst: np.ndarray
    edge_t: np.ndarray
    edge_feats: Optional[np.ndarray] = None
    node_ids: Optional[np.ndarray] = None
    node_t: Optional[np.ndarray] = None
    node_feats: Optional[np.ndarray] = None
    static_node_feats: Optional[np.ndarray] = None
    num_nodes: int = 0
    granularity: TimeDelta = TimeDelta.event()
    _eids: Optional[np.ndarray] = None

    # -- derived sizes --------------------------------------------------
    @property
    def num_edge_events(self) -> int:
        """Number of edge events (rows) in the store."""
        return len(self.src)

    @property
    def num_node_events(self) -> int:
        """Number of node events (0 when the backend has none)."""
        return 0 if self.node_ids is None else len(self.node_ids)

    @property
    def edge_feat_dim(self) -> int:
        """Edge-feature width (0 when the store has no edge features)."""
        return 0 if self.edge_feats is None else int(self.edge_feats.shape[1])

    @property
    def node_feat_dim(self) -> int:
        """Node-event feature width (0 when absent)."""
        return 0 if self.node_feats is None else int(self.node_feats.shape[1])

    @property
    def time_span(self) -> Tuple[int, int]:
        """``[min_t, max_t]`` over all events — ``DGData.time_span``
        semantics (O(1): the columns are time-sorted)."""
        ts = [self.edge_t] if len(self.edge_t) else []
        if self.node_t is not None and len(self.node_t):
            ts.append(self.node_t)
        if not ts:
            return (0, 0)
        return (int(min(int(t[0]) for t in ts)),
                int(max(int(t[-1]) for t in ts)))

    # -- range queries (DGData semantics) --------------------------------
    def edge_range(self, t_lo: Optional[int],
                   t_hi: Optional[int]) -> Tuple[int, int]:
        """Edge rows with ``t in [t_lo, t_hi)`` — O(log E) binary search
        over the sorted timestamp column (O(log E) *pages* touched for a
        memmap backend)."""
        lo = 0 if t_lo is None else int(
            np.searchsorted(self.edge_t, t_lo, "left"))
        hi = (self.num_edge_events if t_hi is None
              else int(np.searchsorted(self.edge_t, t_hi, "left")))
        return lo, hi

    def node_event_range(self, t_lo, t_hi) -> Tuple[int, int]:
        """Node-event rows with ``t in [t_lo, t_hi)`` (``(0, 0)`` when the
        backend holds no node events)."""
        if self.node_t is None:
            return 0, 0
        lo = 0 if t_lo is None else int(
            np.searchsorted(self.node_t, t_lo, "left"))
        hi = (len(self.node_t) if t_hi is None
              else int(np.searchsorted(self.node_t, t_hi, "left")))
        return lo, hi

    # -- windows ---------------------------------------------------------
    def edge_window(self, lo: int, hi: int, window=None) -> EventWindow:
        """The bounds-checked row window ``[lo, hi)`` as an
        :class:`EventWindow` (empty windows — ``lo == hi`` — are valid;
        ``lo > hi`` or out-of-range rows raise ``ValueError``)."""
        n = self.num_edge_events
        if lo > hi:
            raise ValueError(f"edge window lo {lo} > hi {hi}")
        if lo < 0 or hi > n:
            raise ValueError(
                f"edge window [{lo}, {hi}) out of range [0, {n})")
        eids = (np.arange(lo, hi, dtype=np.int64) if self._eids is None
                else np.asarray(self._eids[lo:hi], dtype=np.int64))
        return EventWindow(
            lo=int(lo), hi=int(hi),
            src=self.src[lo:hi], dst=self.dst[lo:hi], t=self.edge_t[lo:hi],
            eids=eids,
            edge_feats=(None if self.edge_feats is None
                        else self.edge_feats[lo:hi]),
            window=window,
        )

    def iter_windows(self, batch_size: Optional[int] = None,
                     time_window: Optional[int] = None, *,
                     start: Union[None, int, dict] = None,
                     emit_empty: bool = False,
                     release: bool = False,
                     telemetry=None) -> WindowIterator:
        """Iterate the stream as :class:`EventWindow` host batches.

        Exactly one of ``batch_size`` (fixed event count, CTDG-style) or
        ``time_window`` (fixed span in native granularity ticks,
        DTDG-style; empty windows skipped unless ``emit_empty``) selects
        the mode — the same split ``DGDataLoader`` draws. ``start``
        resumes: a row index, or a :meth:`WindowIterator.state_dict`
        cursor restored from a checkpoint. ``release=True`` calls
        :meth:`release` after each yielded window, bounding a memmap
        backend's resident set by O(window) instead of O(touched stream).
        ``telemetry`` (a ``repro_torch.obs.Telemetry``) counts
        ``storage/windows_read`` / ``storage/windows_released`` per
        window yielded/released (``docs/observability.md``).
        """
        return WindowIterator(self, batch_size, time_window, start,
                              emit_empty, release, telemetry)

    # -- residency -------------------------------------------------------
    def release(self) -> None:
        """Drop any reclaimable residency (no-op for in-memory backends;
        ``MmapStore`` advises the kernel to evict its mapped pages)."""

    # -- bridges ---------------------------------------------------------
    def to_data(self):
        """This store as a zero-copy ``DGData`` view (columns aliased, not
        copied) — the bridge into every existing loader/sampler/pipeline."""
        from repro_torch.core.graph import DGData

        return DGData.from_store(self)
