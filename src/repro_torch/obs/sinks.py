"""Pluggable telemetry sinks — where ``repro.obs`` records go.

The sink contract is one method: ``emit(record)`` takes a schema-valid
plain-JSON dict (``repro.obs.records``) and must be safe to call from any
thread (the serving and prefetch paths emit from daemon threads). Three
implementations cover every deployment:

  * :class:`NullSink`   — drops everything; the explicit no-op. A
    ``Telemetry`` with no sinks (the default) never even builds records,
    so the disabled path costs one attribute check per call site.
  * :class:`MemorySink` — appends to an in-process list; the test sink
    (and what ``TrainLoop`` tees through to rebuild its history).
  * :class:`FileSink`   — appends one JSON line per record to a file
    (JSONL), flushed per record so a crashed run keeps everything it
    emitted. This is what ``TrainSpec.telemetry`` wires up.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List


class Sink:
    """Base sink: ``emit`` receives schema-valid records, ``close`` is
    called (idempotently) when the owner is done with the sink."""

    def emit(self, record: Dict[str, Any]) -> None:
        """Consume one record (thread-safe in every subclass)."""
        raise NotImplementedError

    def close(self) -> None:
        """Release resources; further ``emit`` calls are undefined."""


class NullSink(Sink):
    """The explicit no-op sink: every record is dropped."""

    def emit(self, record: Dict[str, Any]) -> None:
        """Drop the record."""


class MemorySink(Sink):
    """In-memory sink for tests and history reconstruction.

    ``records`` is the emitted list in arrival order; it is safe to read
    concurrently with emits (appends are atomic under the GIL, and a lock
    guards against torn iteration in ``drain``).
    """

    def __init__(self):
        self.records: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def emit(self, record: Dict[str, Any]) -> None:
        """Append the record."""
        with self._lock:
            self.records.append(record)

    def drain(self) -> List[Dict[str, Any]]:
        """Return all records so far and clear the sink."""
        with self._lock:
            out, self.records = self.records, []
            return out


class FileSink(Sink):
    """Append-mode JSONL sink: one JSON object per line.

    The file is opened lazily on first emit (so building a ``Telemetry``
    from a spec never touches the filesystem until something is actually
    recorded), written under a lock, and flushed per record — a killed
    process keeps every line it wrote. Append mode means several runs (or
    the bench writer and a telemetry writer) can share one trajectory
    file, same as the BENCH_JSON convention.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()
        self._f = None

    def emit(self, record: Dict[str, Any]) -> None:
        """Append ``record`` as one JSON line (flushed immediately)."""
        with self._lock:
            if self._f is None:
                self._f = open(self.path, "a")
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()

    def close(self) -> None:
        """Close the underlying file (idempotent)."""
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __del__(self):  # pragma: no cover - GC-order dependent
        try:
            self.close()
        except Exception:
            pass
