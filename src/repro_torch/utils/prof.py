"""Performance monitoring utilities (paper §4: "Performance monitoring
utilities ... help identify bottlenecks"; Table 11 runtime breakdown).

**Deprecated** — the port's copy of ``repro.utils.prof``: ``Profiler`` is
a thin shim over the structured telemetry layer
(``repro_torch.obs.Telemetry``); constructing one raises a
``DeprecationWarning``. New code should use ``Telemetry`` spans with a
``MemorySink`` and ``repro_torch.obs.span_report`` for the Table-11-style
breakdown (see ``docs/observability.md`` for the migration recipe). The
shim keeps the historical surface — ``times``/``counts`` per dotted
section path, ``total()``, ``report()``, ``reset()``, nesting, and
``block=True`` waiting for the card's queued work
(``torch.cuda.synchronize``) on section exit — but every
section now flows through ``Telemetry.span``, so a legacy-profiled run
can tee its sections into any sink alongside the rest of the run's
records.
"""

from __future__ import annotations

import contextlib
import warnings
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

from repro_torch.obs import MemorySink, Telemetry, span_report


class Profiler:
    """Deprecated span-accumulating profiler (use
    ``repro_torch.obs.Telemetry``).

    Backed by a private ``Telemetry`` + ``MemorySink``: each ``with
    profiler(name)`` section is a ``Telemetry.span``, and ``times`` /
    ``counts`` aggregate the emitted span records by dotted path —
    identical keys and semantics to the historical dict-accumulating
    implementation.
    """

    def __init__(self, block: bool = False):
        warnings.warn(
            "repro_torch.utils.Profiler is deprecated; use "
            "repro_torch.obs.Telemetry spans with a MemorySink and "
            "repro_torch.obs.span_report (see "
            "docs/observability.md)",
            DeprecationWarning,
            stacklevel=2,
        )
        self._telemetry = Telemetry()
        self._sink = self._telemetry.attach(MemorySink())
        self._block = block

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        with self._telemetry.span(name):
            try:
                yield
            finally:
                if self._block and torch.cuda.is_available():
                    # Inside the span: wait for the card's queued work so
                    # the span's duration includes device time.
                    torch.cuda.synchronize()

    def _aggregate(self):
        times: Dict[str, float] = defaultdict(float)
        counts: Dict[str, int] = defaultdict(int)
        for r in self._sink.records:
            if r.get("kind") == "span":
                times[r["path"]] += r["dur_s"]
                counts[r["path"]] += 1
        return times, counts

    @property
    def times(self) -> Dict[str, float]:
        """Accumulated wall seconds per dotted section path."""
        return self._aggregate()[0]

    @property
    def counts(self) -> Dict[str, int]:
        """Section entry counts per dotted section path."""
        return self._aggregate()[1]

    def total(self) -> float:
        """Summed seconds of top-level (undotted) sections."""
        return sum(v for k, v in self.times.items() if "." not in k)

    def report(self, min_pct: float = 0.5) -> str:
        """Table-11-style percentage breakdown of the recorded sections."""
        return span_report(self._sink.records, min_pct=min_pct)

    def reset(self) -> None:
        """Drop all recorded sections."""
        self._sink.drain()


@contextlib.contextmanager
def profile_section(profiler: Optional[Profiler], name: str):
    """``with profiler(name)`` that no-ops when ``profiler`` is ``None``."""
    if profiler is None:
        yield
    else:
        with profiler(name):
            yield
