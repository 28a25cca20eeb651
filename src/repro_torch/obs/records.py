"""The typed telemetry record schema shared by every ``repro.obs`` sink.

Every record is one flat JSON object with a ``kind`` discriminator; the
five kinds cover the whole observability surface (``docs/observability.md``
has the field-by-field reference):

  ``span``    — one timed section: dotted ``path`` (nesting), monotonic
                start ``t0``, duration ``dur_s``, free-form ``attrs``;
  ``counter`` — a monotonically accumulated count, snapshotted at flush;
  ``gauge``   — a point-in-time value (queue depth, EWMA latency,
                device memory);
  ``hist``    — a fixed-bucket latency histogram snapshot: ``count``,
                ``sum``, derived ``p50``/``p99``, and the per-bucket
                counts (``buckets``) for offline re-aggregation;
  ``bench``   — a benchmark measurement. Field-compatible with the
                legacy BENCH_JSON rows (``name``/``us``/``derived``/
                ``ts``/``rev``/``backend``/``device_count``), which is
                what lets ``benchmarks/common.py`` emit through this
                layer without touching ``scripts/check_bench_regression``.

``validate`` is the single source of truth for the schema: tests assert
every record a run emits passes it, and ``FileSink`` output round-trips
through it line by line.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

KINDS = ("span", "counter", "gauge", "hist", "bench")

# Required fields (beyond "kind") per record kind, with the accepted types.
_NUM = (int, float)
_REQUIRED: Dict[str, Dict[str, tuple]] = {
    "span": {"name": (str,), "path": (str,), "t0": _NUM, "dur_s": _NUM,
             "attrs": (dict,)},
    "counter": {"name": (str,), "value": _NUM},
    "gauge": {"name": (str,), "value": _NUM},
    "hist": {"name": (str,), "count": (int,), "sum": _NUM, "p50": _NUM,
             "p99": _NUM, "buckets": (list,)},
    "bench": {"name": (str,), "us": _NUM, "derived": (str,), "ts": _NUM},
}


def validate(record: Any) -> Dict[str, Any]:
    """Check one record against the schema; returns it, raises ``ValueError``.

    A valid record is a dict with a known ``kind`` and every
    kind-required field present with the right type. Extra fields are
    allowed (``bench`` records carry ``rev``/``backend``/``device_count``;
    spans may carry anything in ``attrs``) — the schema is a floor, not a
    ceiling, so sinks stay forward-compatible.
    """
    if not isinstance(record, dict):
        raise ValueError(f"record must be a dict, got {type(record).__name__}")
    kind = record.get("kind")
    if kind not in KINDS:
        raise ValueError(f"unknown record kind {kind!r}; have {KINDS}")
    for field, types in _REQUIRED[kind].items():
        if field not in record:
            raise ValueError(f"{kind} record missing field {field!r}: {record}")
        v = record[field]
        if not isinstance(v, types) or isinstance(v, bool):
            raise ValueError(
                f"{kind} record field {field!r} has type "
                f"{type(v).__name__}, expected one of "
                f"{[t.__name__ for t in types]}")
    return record


def bench_record(name: str, value: float, derived: str = "", *,
                 ts: float, rev: Optional[str], backend: Optional[str],
                 device_count: Optional[int]) -> Dict[str, Any]:
    """Build a ``bench`` record with the exact legacy BENCH_JSON fields.

    ``benchmarks/common.py`` routes every ``emit``/``emit_value`` through
    here, so bench rows and telemetry records share one schema; the field
    names and rounding match the pre-obs writer bit-for-bit (only the
    ``kind`` discriminator is new, which the regression gate ignores).
    """
    return validate({
        "kind": "bench",
        "name": name,
        "us": round(float(value), 1),
        "derived": derived,
        "ts": round(float(ts), 3),
        "rev": rev,
        "backend": backend,
        "device_count": device_count,
    })
