"""Unified CTDG/DTDG data loading (paper Defs. 3.3-3.4, Fig. 2).

``DGDataLoader`` iterates a ``DGraph`` view either

  * **by events** (CTDG): fixed event-count batches under the event-ordered
    granularity, or
  * **by time** (DTDG): fixed wall-clock windows of the view's (coarser)
    granularity — batches are snapshots ``G|_[t_i, t_i + tau_hat)``; empty
    windows can be emitted or skipped.

Each batch is materialized from storage, passed through the ``HookManager``
pipeline, and returned as a ``Batch``.

``PrefetchLoader`` overlaps batch preparation with the step on the device:
a daemon thread runs the inner loader (materialization and every hook) one
batch or more ahead and stages each batch's host arrays on the device, with
a bounded queue for back-pressure (see its docstring for the CUDA streams).

``snapshot_tensor`` tensorizes a stream into the DTDG ``SnapshotTensor``
view on the device: the discretization core and the snapshot-major layout
run in tensor ops there.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core.batch import Batch
from repro_torch.core.graph import DGData, DGraph, SnapshotTensor
from repro_torch.core.granularity import TimeDelta
from repro_torch.core.hooks import HookManager
from repro_torch.device import resolve_device


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
        on_batch=None,
    ):
        """Iterate ``dg``.

        Exactly one of ``batch_size`` (iterate-by-events) or ``batch_unit``
        (iterate-by-time) must be set. ``window_ticks`` scales the time
        window (e.g. unit='h', window_ticks=6 -> 6-hour snapshots).
        ``on_batch`` (no-arg callable) runs after each batch has been
        hook-processed and handed off: the storage layer passes
        ``MmapStore.release`` here so an epoch over a memory-mapped stream
        keeps O(window) resident pages; hooks and staging copy everything
        they keep, so dropped pages are safe.
        """
        if (batch_size is None) == (batch_unit is None):
            raise ValueError("set exactly one of batch_size / batch_unit")
        self.dg = dg
        self.manager = hook_manager
        self.on_batch = on_batch
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
            if self.on_batch is not None:
                self.on_batch()

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
                if self.on_batch is not None:
                    self.on_batch()
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


class _HostStagingPool:
    """Reused host buffers that batches are staged through on their way to
    the card (the reference's ``_HostStagingPool``).

    One buffer per batch key and slot, the slots rotated round-robin over
    ``depth`` generations (``advance`` once per batch, so every array of a
    batch shares a slot). Buffers are pinned wherever CUDA is present, so
    the host-to-device copy runs asynchronously on the staging stream. A
    slot is rewritten only after the event recorded behind the previous
    copies from it (``note``) has completed: reuse before the copy finished
    is impossible by construction, not by timing.
    """

    def __init__(self, depth: int):
        if depth < 2:
            raise ValueError("staging depth must be >= 2")
        self.depth = depth
        self.pin = torch.cuda.is_available()
        self._slot = 0
        self._bufs = {}
        self._events = {}

    def advance(self) -> None:
        """Rotate to the next slot generation and wait out the copies last
        made from it."""
        self._slot = (self._slot + 1) % self.depth
        event = self._events.pop(self._slot, None)
        if event is not None:
            event.synchronize()

    def stage(self, key: str, arr: np.ndarray) -> torch.Tensor:
        """Copy ``arr`` into this slot's buffer for ``key`` (int64 narrowed
        to int32, as ``stage_batch`` narrows) and return the buffer."""
        np_dtype = np.dtype(np.int32) if arr.dtype == np.int64 else arr.dtype
        dtype = torch.from_numpy(np.empty(0, np_dtype)).dtype
        k = (key, self._slot)
        buf = self._bufs.get(k)
        if buf is None or tuple(buf.shape) != arr.shape or buf.dtype != dtype:
            buf = torch.empty(arr.shape, dtype=dtype, pin_memory=self.pin)
            self._bufs[k] = buf
        np.copyto(buf.numpy(), arr, casting="unsafe")
        return buf

    def note(self, event) -> None:
        """Record the event behind this slot's copies (see ``advance``)."""
        self._events[self._slot] = event


class PrefetchLoader:
    """Stage the next batches while the consumer works on the current one.

    A daemon thread pulls from ``inner`` (which runs the hook pipeline) and
    stages every host numpy array of each batch on ``device`` (int64
    narrowed to int32, as ``stage_batch`` does); tensors already on the
    device pass through. A bounded queue holds at most ``prefetch`` staged
    batches. Hook state stays right because the hooks still run strictly in
    order, just ahead of the consumer.

    On a CUDA device everything the producer does runs on a side stream:
    the device sampler's torch ops inside the hooks, and the copies, which
    go through pinned buffers reused over ``prefetch + 2`` slots
    (``_HostStagingPool``) with ``non_blocking`` transfers. The side stream
    first waits for the consumer's stream (state the consumer set up). Each
    batch carries an event recorded after its work; the consumer's current
    stream waits on it before the batch is yielded, and every CUDA tensor of
    the batch is marked used on that stream (``record_stream``) so the
    caching allocator does not hand its memory back while the consumer's
    kernels may still read it. On the CPU nothing is staged through the
    pool, but the thread runs all the same. In a multi-rank run ``device``
    is the rank's device; a node-sharded sampler's collectives then run in
    each rank's producer thread, in the same order on every rank.

    ``telemetry`` (a ``repro_torch.obs.Telemetry``) sees a ``loader/stage``
    span per producer pass, the ``loader/prefetch_wait`` histogram, the
    ``loader/producer_stall`` / ``loader/consumer_stall`` counters, the
    ``loader/queue_depth`` gauge and the ``loader/batches`` counter, as in
    the reference.

    Errors: an exception in the producer is re-raised in the consumer with
    its traceback, after the batches staged before it. A producer that dies
    without delivering the end of the stream or an error raises
    ``RuntimeError`` instead of blocking forever. ``close()`` ends every
    active iteration cleanly: the consumer checks the stop flag before it
    yields, so nothing more is yielded even when batches are queued.
    """

    _END = object()

    def __init__(self, inner, device="cuda", prefetch: int = 2,
                 telemetry=None):
        if prefetch < 1:
            raise ValueError("prefetch depth must be >= 1")
        from repro_torch.obs import NULL

        self.inner = inner
        self.device = resolve_device(device)
        self.prefetch = prefetch
        self.telemetry = telemetry if telemetry is not None else NULL
        self._active: list = []  # live (stop, thread) pairs, for close()
        self._active_lock = threading.Lock()
        # depth > batches in flight: `prefetch` queued + 1 being consumed
        # + 1 being produced.
        self._pool = (_HostStagingPool(prefetch + 2)
                      if self.device.type == "cuda" else None)

    def __len__(self) -> int:
        return len(self.inner)

    def _stage(self, batch: Batch) -> Batch:
        from repro_torch.core.tg_hooks import stage_batch

        if self._pool is not None:
            self._pool.advance()
        return stage_batch(batch, self.device, pool=self._pool)

    def __iter__(self) -> Iterator[Batch]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        tel = self.telemetry
        cuda = self.device.type == "cuda"
        side = None
        if cuda:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))

        def put_or_stop(item) -> bool:
            """Bounded put that aborts when the consumer has left."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    # Back-pressure: the consumer is the bottleneck here.
                    tel.count("loader/producer_stall")
            return False

        def produce():
            try:
                ctx = (torch.cuda.stream(side) if cuda
                       else contextlib.nullcontext())
                with ctx:
                    for batch in self.inner:
                        with tel.span("loader/stage"):
                            staged = self._stage(batch)
                            ready = None
                            if cuda:
                                ready = torch.cuda.Event()
                                ready.record(side)
                                if self._pool is not None:
                                    self._pool.note(ready)
                        if not put_or_stop((staged, ready)):
                            return
                put_or_stop(self._END)
            except BaseException as e:  # surfaced on the consumer side
                put_or_stop(e)

        thread = threading.Thread(target=produce, daemon=True)
        with self._active_lock:
            self._active.append((stop, thread))
        thread.start()
        try:
            while True:
                wait_t0 = time.perf_counter()
                try:
                    item = q.get(timeout=0.2)
                except queue.Empty:
                    if stop.is_set():  # close() mid-iteration: clean end
                        return
                    if not thread.is_alive():
                        raise RuntimeError(
                            "PrefetchLoader producer thread died without "
                            "signalling end-of-stream or an error")
                    # Starvation: the producer is the bottleneck here.
                    tel.count("loader/consumer_stall")
                    continue
                if stop.is_set():  # close(): nothing queued is yielded
                    return
                if tel.enabled:
                    tel.observe("loader/prefetch_wait",
                                time.perf_counter() - wait_t0)
                    tel.gauge("loader/queue_depth", q.qsize())
                if item is self._END:
                    return
                if isinstance(item, BaseException):
                    # Re-raising the instance keeps the producer-side
                    # traceback (it rode along on __traceback__).
                    raise item
                staged, ready = item
                if ready is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(ready)
                    for key in staged.keys():
                        v = staged[key]
                        if isinstance(v, torch.Tensor) and v.is_cuda:
                            v.record_stream(consumer)
                tel.count("loader/batches")
                yield staged
        finally:
            stop.set()
            with self._active_lock:
                self._active = [a for a in self._active if a[0] is not stop]
            # The producer finishes its current hook pass and leaves; wait
            # for it, so no hook runs after the iteration is over, and order
            # the consumer's stream after everything it enqueued.
            if thread.is_alive():
                thread.join(timeout=30)
            if side is not None:
                torch.cuda.current_stream(self.device).wait_stream(side)

    def close(self) -> None:
        """Stop every producer thread of the active iterations and join
        them. Idempotent: safe to call repeatedly or with no iteration in
        flight; a consumer blocked in ``next()`` sees a clean end."""
        with self._active_lock:
            active = list(self._active)
        for stop, thread in active:
            stop.set()
        for stop, thread in active:
            thread.join(timeout=5)


def _tensorize_snapshots(usrc, udst, uct, count, *, num_rows: int,
                         capacity: int):
    """Scatter tick-major discretized events into ``(T, capacity)`` grids.

    Inputs are the padded outputs of ``discretize_edges_padded`` (or the
    host fallback's classes) with ``uct`` already shifted to zero-based row
    ticks and kept sorted (padding carries a large sentinel beyond
    ``count``), so the per-row extents come from one ``searchsorted``.
    Events beyond a row's ``capacity`` go to a sink slot past the grid and
    are sliced off, as the reference's scatter drops them; callers size
    ``capacity`` to the largest row to make that impossible by construction.
    """
    dev = usrc.device
    g = usrc.shape[0]
    idx = torch.arange(g, dtype=torch.int32, device=dev)
    valid = idx < count
    starts = torch.searchsorted(
        uct, torch.arange(num_rows, dtype=torch.int32, device=dev),
        right=False, out_int32=True)
    row = uct.clamp(0, num_rows - 1).long()
    pos = idx - starts[row]
    ok = valid & (pos < capacity)
    flat = torch.where(ok, row * capacity + pos, num_rows * capacity)
    size = num_rows * capacity

    def grid(fill, dtype, values):
        out = torch.full((size + 1,), fill, dtype=dtype, device=dev)
        return out.index_copy_(0, flat, values)[:size].reshape(num_rows, capacity)

    bounds = torch.cat([starts, count.reshape(1).to(torch.int32)])
    counts = torch.diff(bounds).clamp(0, capacity)
    return (grid(0, torch.int32, usrc), grid(0, torch.int32, udst),
            grid(False, torch.bool, ok), counts)


def snapshot_tensor(
    data: DGData,
    granularity: TimeDelta | str,
    capacity: Optional[int] = None,
    device="cuda",
) -> SnapshotTensor:
    """Tensorize a stream into the ``SnapshotTensor`` view on ``device``.

    The fixed-capacity discretization core (``discretize_edges_padded``)
    collapses duplicate ``(tick, src, dst)`` classes at the target
    granularity on the device, then one scatter (``_tensorize_snapshots``)
    lays them out as padded ``(T, capacity)`` src/dst/mask tensors. The only
    host reads are build-time bookkeeping (the valid count and the per-row
    extents that choose the capacity). Graphs beyond the int32 guard
    (``device_discretize_supported``) are discretized on the host with
    numpy and then laid out on the device the same way.

    ``capacity`` defaults to the largest per-snapshot edge count rounded up
    to a power of two; a smaller value drops each oversized snapshot's tail.
    """
    from repro_torch.core.discretize import (
        _coarse_ticks,
        _host_ticks,
        device_discretize_supported,
        discretize_edges_padded,
    )

    dev = resolve_device(device)
    unit = TimeDelta.coerce(granularity)
    k = _coarse_ticks(data, unit)
    e = data.num_edge_events
    span = data.time_span
    t0, t_end = span[0] // k, span[1] // k
    num_rows = max(int(t_end - t0) + 1, 1)

    def stage(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)

    if e and device_discretize_supported(data, k, edges_only=True):
        t_staged, k_dev = _host_ticks(data.edge_t, k)
        usrc, udst, uct, _, count = discretize_edges_padded(
            stage(data.src), stage(data.dst), stage(t_staged), None,
            k=k_dev, reduce="first", capacity=e, feat_dim=0)
        # Zero-base the row ticks for the scatter (t0 >= 0, so the padded
        # int32-max sentinel shifts without wrapping and stays largest).
        uct = uct - int(t0)
    else:  # int32 guard tripped (or empty stream): host numpy fallback
        disc = data.discretize(unit, reduce="first", backend="numpy")
        usrc, udst = stage(disc.src), stage(disc.dst)
        # Shift in int64 on the host: absolute ticks can exceed int32 (that
        # is why this branch runs), relative ones cannot.
        uct = stage(disc.edge_t - t0)
        count = torch.tensor(disc.num_edge_events, dtype=torch.int32,
                             device=dev)

    g = int(count)
    row_counts = np.bincount(uct[:g].cpu().numpy().astype(np.int64),
                             minlength=num_rows)
    if capacity is None:
        capacity = int(2 ** np.ceil(np.log2(max(row_counts.max(), 1))))
    src_g, dst_g, mask_g, counts = _tensorize_snapshots(
        usrc, udst, uct, count, num_rows=num_rows, capacity=int(capacity))
    return SnapshotTensor(
        src=src_g, dst=dst_g, mask=mask_g, counts=counts,
        t0=int(t0), ticks=int(k), unit=unit, num_nodes=int(data.num_nodes),
    )
