"""Unified CTDG/DTDG data loading (paper Defs. 3.3-3.4, Fig. 2).

``DGDataLoader`` iterates a ``DGraph`` view either

  * **by events** (CTDG): fixed event-count batches under the event-ordered
    granularity, or
  * **by time** (DTDG): fixed wall-clock windows of the view's (coarser)
    granularity — batches are snapshots ``G|_[t_i, t_i + tau_hat)``; empty
    windows can be emitted or skipped.

Each batch is materialized from storage, passed through the ``HookManager``
pipeline, and returned as a ``Batch``. Host-only copy of the reference's
loader; the reference's ``PrefetchLoader`` (pinned staging buffers and a
side stream) and ``snapshot_tensor`` wait for later slices of the port.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from repro_torch.core.batch import Batch
from repro_torch.core.graph import DGraph
from repro_torch.core.granularity import TimeDelta
from repro_torch.core.hooks import HookManager


class DGDataLoader:
    """Iterate a ``DGraph`` view as hook-processed ``Batch``es.

    CTDG mode (``batch_size``): fixed event-count batches in stream order.
    DTDG mode (``batch_unit``): fixed time windows (snapshots) of a real-
    time granularity coarser-or-equal to the view's native unit. Each
    materialized batch is passed through ``hook_manager`` (when given)
    before being yielded. See ``docs/architecture.md``.
    """

    def __init__(
        self,
        dg: DGraph,
        hook_manager: Optional[HookManager] = None,
        batch_size: Optional[int] = 200,
        batch_unit: Optional[TimeDelta | str] = None,
        drop_last: bool = False,
        emit_empty: bool = False,
        window_ticks: int = 1,
    ):
        """Iterate ``dg``.

        Exactly one of ``batch_size`` (iterate-by-events) or ``batch_unit``
        (iterate-by-time) must be set. ``window_ticks`` scales the time
        window (e.g. unit='h', window_ticks=6 -> 6-hour snapshots).
        """
        if (batch_size is None) == (batch_unit is None):
            raise ValueError("set exactly one of batch_size / batch_unit")
        self.dg = dg
        self.manager = hook_manager
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.emit_empty = emit_empty
        self.window_ticks = window_ticks
        if batch_unit is not None:
            unit = TimeDelta.coerce(batch_unit)
            native = dg.data.granularity
            if native.is_event_ordered:
                raise ValueError(
                    "iterate-by-time requires a real-time native granularity; "
                    "this graph is event-ordered (paper §3)"
                )
            if not unit.is_coarser_or_equal(native):
                raise ValueError(f"batch unit {unit} must be >= native {native}")
            self.batch_unit = unit
            self._ticks = unit.ticks_per(native) * window_ticks
        else:
            self.batch_unit = None
            self._ticks = None

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        """Number of batches (event batches or time windows) to be yielded;
        for time iteration this is an upper bound when windows can be
        empty and ``emit_empty=False``."""
        if self.batch_size is not None:
            n = self.dg.num_edge_events
            full, rem = divmod(n, self.batch_size)
            return full if (self.drop_last or rem == 0) else full + 1
        span = self.dg.t_hi - self.dg.t_lo
        return int(np.ceil(span / self._ticks))

    def __iter__(self) -> Iterator[Batch]:
        if self.batch_size is not None:
            yield from self._iter_events()
        else:
            yield from self._iter_time()

    # -- CTDG: fixed event count ----------------------------------------
    def _iter_events(self) -> Iterator[Batch]:
        lo, hi = self.dg.edge_slice()
        for start in range(lo, hi, self.batch_size):
            stop = min(start + self.batch_size, hi)
            if self.drop_last and stop - start < self.batch_size:
                break
            batch = self._materialize(start, stop)
            yield self._run_hooks(batch)

    # -- DTDG: fixed time window ------------------------------------------
    def _iter_time(self) -> Iterator[Batch]:
        data = self.dg.data
        t = self.dg.t_lo
        while t < self.dg.t_hi:
            t_next = min(t + self._ticks, self.dg.t_hi)
            lo, hi = data.edge_range(t, t_next)
            if hi > lo or self.emit_empty:
                batch = self._materialize(lo, hi, window=(t, t_next))
                yield self._run_hooks(batch)
            t = t_next

    # ------------------------------------------------------------------
    def _materialize(self, lo: int, hi: int, window=None) -> Batch:
        raw = self.dg.materialize(lo, hi)
        meta = {
            # Global event ids (sliced splits carry their root offset), so
            # eid-keyed edge-feature lookups are correct on any split.
            "eids": np.arange(lo, hi, dtype=np.int64)
            + getattr(self.dg.data, "eid_offset", 0),
            "window": window,
            "granularity": self.batch_unit or self.dg.granularity,
        }
        return Batch(raw, meta)

    def _run_hooks(self, batch: Batch) -> Batch:
        if self.manager is None:
            return batch
        return self.manager.execute(batch)
