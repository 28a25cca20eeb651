"""``Telemetry`` — spans, counters, gauges, and latency histograms.

One ``Telemetry`` object is the write-side API the instrumented paths
(``train/loop.py``, ``core/loader.py``, ``serve/graph_service.py``,
``repro.storage``) share:

  * ``span(name)``    — a timed section on the monotonic clock. Spans
    nest per thread (a thread-local stack turns ``name`` into the dotted
    ``path``) and emit one ``span`` record at exit; the context manager
    yields a mutable attrs dict so callers can attach results (loss,
    metric, sizes) measured inside the span.
  * ``count(name)``   — monotone counters (queue stalls, shed requests,
    windows read), snapshotted as ``counter`` records by ``flush()``.
  * ``gauge(name)``   — last-value gauges (queue depth, EWMA latency,
    device memory), snapshotted as ``gauge`` records by ``flush()``.
  * ``observe(name)`` — fixed-bucket latency histograms (log-spaced
    edges, ~33% resolution) with p50/p99 read-out, snapshotted as
    ``hist`` records by ``flush()``.

**Disabled is free.** A ``Telemetry`` with no sinks (the default) keeps
``enabled`` False: ``span`` returns a cached ``nullcontext`` and the
other calls return after one attribute check, so instrumented hot loops
pay ~no overhead until someone attaches a sink (bounded by
``tests/test_obs.py``; numbers in ``docs/observability.md``). Sinks can
be attached/detached mid-run — ``TrainLoop`` tees a ``MemorySink``
through whatever the pipeline already has to rebuild its history from
the records it just emitted.

All aggregate state is lock-guarded and spans use thread-local nesting,
so the serving and prefetch daemon threads emit safely into the same
object. ``EwmaGauge`` is the standalone exponentially-weighted average
used by the serving latency breaker (kept bit-identical to the formula
it replaced).
"""

from __future__ import annotations

import bisect
import contextlib
import math
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

from repro_torch.obs.sinks import MemorySink, NullSink, Sink

# Histogram bucket geometry: 8 log-spaced buckets per decade from 100ns
# to 1000s (every latency this codebase can produce), ~33% resolution.
_H_LO, _H_DECADES, _H_PER_DECADE = 1e-7, 10, 8
_H_GROWTH = 10.0 ** (1.0 / _H_PER_DECADE)
_H_EDGES = [_H_LO * _H_GROWTH ** i
            for i in range(1, _H_DECADES * _H_PER_DECADE + 1)]


class Histogram:
    """Fixed-bucket latency histogram with quantile read-out.

    Buckets are log-spaced (8 per decade over ``[1e-7, 1e3]`` seconds,
    upper-edge ratio ~1.33) plus an underflow and an overflow bucket, so
    ``observe`` is O(log #buckets) with zero allocation and a snapshot is
    a short list — the Prometheus histogram idiom. ``quantile`` returns
    the upper edge of the bucket holding the requested rank: an upper
    bound on the true quantile, tight to one bucket ratio (verified
    against ``numpy.quantile`` in ``tests/test_obs.py``).
    """

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self):
        self.counts = [0] * (len(_H_EDGES) + 1)  # [under..., buckets, over]
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, seconds: float) -> None:
        """Record one value (seconds; any nonnegative float works)."""
        x = float(seconds)
        self.counts[bisect.bisect_left(_H_EDGES, x)] += 1
        self.count += 1
        self.sum += x
        self.min = min(self.min, x)
        self.max = max(self.max, x)

    def quantile(self, q: float) -> float:
        """Upper-edge estimate of the ``q`` quantile (0 for empty)."""
        if self.count == 0:
            return 0.0
        target = min(max(int(math.ceil(q * self.count)), 1), self.count)
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target:
                edge = _H_EDGES[i] if i < len(_H_EDGES) else self.max
                return min(edge, self.max)
        return self.max  # pragma: no cover - cum always reaches count

    def snapshot(self, name: str) -> Dict[str, Any]:
        """This histogram as a schema-valid ``hist`` record.

        ``buckets`` lists only the occupied buckets as ``[upper_edge,
        count]`` pairs (overflow keeps the last real edge scaled once
        more), which keeps records short on sparse histograms.
        """
        buckets = [
            [_H_EDGES[i] if i < len(_H_EDGES) else _H_EDGES[-1] * _H_GROWTH,
             c]
            for i, c in enumerate(self.counts) if c
        ]
        return {"kind": "hist", "name": name, "count": self.count,
                "sum": self.sum, "p50": self.quantile(0.5),
                "p99": self.quantile(0.99), "buckets": buckets}


class EwmaGauge:
    """Exponentially-weighted moving average with explicit coefficients.

    ``update`` computes ``decay * prev + alpha * x`` (first sample passes
    through). ``decay`` defaults to ``1 - alpha`` but is an explicit
    parameter so call sites replacing a hand-rolled EWMA (the serving
    latency breaker's ``0.7 * prev + 0.3 * lat``) reproduce their exact
    float sequence, keeping threshold semantics bit-identical.
    """

    __slots__ = ("alpha", "decay", "value")

    def __init__(self, alpha: float = 0.3, decay: Optional[float] = None):
        self.alpha = float(alpha)
        self.decay = (1.0 - self.alpha) if decay is None else float(decay)
        self.value: Optional[float] = None

    def update(self, x: float) -> float:
        """Fold one sample in; returns the new average."""
        self.value = (x if self.value is None
                      else self.decay * self.value + self.alpha * x)
        return self.value


class Telemetry:
    """The write-side telemetry API (see the module docstring).

    ``sink`` seeds the attached-sink list (``None`` or a ``NullSink``
    means disabled); more sinks can be attached/detached at any time and
    every record is fanned out to all of them. One instance is intended
    per pipeline/service; the module-level ``NULL`` singleton is the
    shared disabled default for call sites that only read.
    """

    def __init__(self, sink: Optional[Sink] = None):
        self._sinks: List[Sink] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}
        # Reusable no-op span: one shared scratch dict (callers may write
        # attrs into it; nothing ever reads it back).
        self._null_span = contextlib.nullcontext({})
        if sink is not None:
            self.attach(sink)

    # -- sink management -------------------------------------------------
    @property
    def enabled(self) -> bool:
        """True when at least one (non-null) sink is attached."""
        return bool(self._sinks)

    def attach(self, sink: Sink) -> Sink:
        """Attach a sink (``NullSink`` is ignored); returns it."""
        if not isinstance(sink, NullSink):
            with self._lock:
                self._sinks.append(sink)
        return sink

    def detach(self, sink: Sink) -> None:
        """Detach a previously attached sink (missing sinks are ignored)."""
        with self._lock:
            self._sinks = [s for s in self._sinks if s is not sink]

    def _emit(self, record: Dict[str, Any]) -> None:
        for s in list(self._sinks):
            s.emit(record)

    # -- spans -----------------------------------------------------------
    def span(self, name: str, **attrs):
        """Context manager timing one section on the monotonic clock.

        Yields a mutable attrs dict (seeded with ``**attrs``) that rides
        the emitted ``span`` record; nesting within a thread builds the
        dotted ``path``. Disabled telemetry returns a cached null context
        (yields a scratch dict, records nothing).
        """
        if not self._sinks:
            return self._null_span
        return self._span(name, attrs)

    @contextlib.contextmanager
    def _span(self, name: str, attrs: Dict[str, Any]):
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        path = ".".join([*stack, name])
        stack.append(name)
        t0 = time.monotonic()
        try:
            yield attrs
        finally:
            dur = time.monotonic() - t0
            stack.pop()
            self._emit({"kind": "span", "name": name, "path": path,
                        "t0": t0, "dur_s": dur, "attrs": attrs})

    # -- aggregates ------------------------------------------------------
    def count(self, name: str, n: float = 1) -> None:
        """Add ``n`` to a counter (snapshotted by ``flush``)."""
        if not self._sinks:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        """Set a gauge to its latest value (snapshotted by ``flush``)."""
        if not self._sinks:
            return
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, seconds: float) -> None:
        """Record one latency sample into a histogram."""
        if not self._sinks:
            return
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(seconds)

    def flush(self) -> None:
        """Emit one snapshot record per counter/gauge/histogram.

        Aggregates keep accumulating after a flush (records are
        cumulative snapshots, not deltas); ``reset`` clears them.
        """
        if not self._sinks:
            return
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = [h.snapshot(k) for k, h in self._hists.items()]
        for name, v in sorted(counters.items()):
            self._emit({"kind": "counter", "name": name, "value": v})
        for name, v in sorted(gauges.items()):
            self._emit({"kind": "gauge", "name": name, "value": v})
        for rec in hists:
            self._emit(rec)

    def reset(self) -> None:
        """Clear all counter/gauge/histogram state (sinks stay attached)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    # -- read-side conveniences (tests, reports) -------------------------
    def counter_value(self, name: str, default: float = 0) -> float:
        """Current value of a counter (``default`` when never counted)."""
        with self._lock:
            return self._counters.get(name, default)

    def gauge_value(self, name: str, default: float = 0.0) -> float:
        """Current value of a gauge (``default`` when never set)."""
        with self._lock:
            return self._gauges.get(name, default)

    def histogram(self, name: str) -> Optional[Histogram]:
        """The live histogram for ``name`` (``None`` when never observed)."""
        with self._lock:
            return self._hists.get(name)


#: Shared disabled instance — the default for instrumented call sites
#: that never attach sinks themselves (do not attach sinks to it).
NULL = Telemetry()


def span_report(records: Iterable[Dict[str, Any]], min_pct: float = 0.5,
                markdown: bool = False) -> str:
    """Aggregate ``span`` records into a per-path timing table.

    Sums duration and call count per dotted span path and renders the
    Table-11-style breakdown the old ``utils.prof.Profiler.report``
    printed (percentages against the top-level total; sub-``min_pct``
    rows dropped). ``markdown=True`` renders a GitHub-flavored table for
    ``$GITHUB_STEP_SUMMARY``. Non-span records are ignored, so a whole
    JSONL file can be piped through unfiltered.
    """
    times: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for r in records:
        if r.get("kind") != "span":
            continue
        p = r["path"]
        times[p] = times.get(p, 0.0) + float(r["dur_s"])
        counts[p] = counts.get(p, 0) + 1
    total = max(sum(v for k, v in times.items() if "." not in k), 1e-12)
    rows = []
    for path in sorted(times, key=lambda p: (p.count("."), -times[p])):
        pct = 100.0 * times[path] / total
        if pct < min_pct:
            continue
        depth = path.count(".")
        label = ("&nbsp;&nbsp;" if markdown else "  ") * depth \
            + path.split(".")[-1]
        rows.append((label, counts[path], times[path], pct))
    if markdown:
        lines = ["| section | calls | seconds | % |",
                 "| --- | ---: | ---: | ---: |"]
        lines += [f"| {n} | {c} | {t:.3f} | {p:.1f}% |"
                  for n, c, t, p in rows]
        return "\n".join(lines)
    lines = [f"{'section':<40s}{'calls':>8s}{'seconds':>10s}{'%':>7s}"]
    lines += [f"{n:<40s}{c:>8d}{t:>10.3f}{p:>6.1f}%" for n, c, t, p in rows]
    return "\n".join(lines)


def history_sink() -> MemorySink:
    """A fresh ``MemorySink`` for history/tee use (tiny convenience so
    callers outside ``repro.obs`` don't need two imports)."""
    return MemorySink()
