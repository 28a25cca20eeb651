"""Time granularity: first-class time units for temporal graphs (paper §3).

A temporal graph has a *native* granularity ``tau``: the coarsest unit that
still discriminates all event timestamps. If real time is unavailable, the
special event-ordered granularity ``TimeDelta.event()`` preserves only order
and is excluded from arithmetic time operations.

Granularities are partially ordered: ``a <= b`` iff ``b`` is coarser, i.e.
one tick of ``b`` spans an integral (>=1) number of ticks of ``a``.

See ``docs/architecture.md`` for how granularity carries the CTDG/DTDG
split through the loader and discretization.
"""

from __future__ import annotations

import dataclasses
from typing import Union

# Seconds per unit. 'r' is the event-ordered pseudo-unit (no real-time span).
_UNIT_SECONDS = {
    "ns": 1e-9,
    "us": 1e-6,
    "ms": 1e-3,
    "s": 1.0,
    "m": 60.0,
    "h": 3600.0,
    "d": 86400.0,
    "w": 7 * 86400.0,
    "y": 365 * 86400.0,
}

_ORDERED_UNIT = "r"


class EventOrderedError(TypeError):
    """Raised when a real-time operation is applied to event-ordered time."""


@dataclasses.dataclass(frozen=True, order=False)
class TimeDelta:
    """A time granularity: ``value`` ticks of ``unit``.

    ``TimeDelta('h')`` is hourly; ``TimeDelta('s', 30)`` is 30-second;
    ``TimeDelta.event()`` is the event-ordered granularity ``tau_event``.
    """

    unit: str
    value: int = 1

    def __post_init__(self) -> None:
        if self.unit != _ORDERED_UNIT and self.unit not in _UNIT_SECONDS:
            raise ValueError(
                f"unknown time unit {self.unit!r}; "
                f"expected one of {sorted(_UNIT_SECONDS)} or {_ORDERED_UNIT!r}"
            )
        if self.value <= 0:
            raise ValueError(f"granularity value must be positive, got {self.value}")
        if self.unit == _ORDERED_UNIT and self.value != 1:
            raise ValueError("event-ordered granularity has no multiple")

    # -- constructors ------------------------------------------------------
    @classmethod
    def event(cls) -> "TimeDelta":
        """The event-ordered pseudo-granularity ``tau_event``."""
        return cls(_ORDERED_UNIT, 1)

    @classmethod
    def coerce(cls, value: Union["TimeDelta", str]) -> "TimeDelta":
        if isinstance(value, TimeDelta):
            return value
        return cls(value)

    # -- properties --------------------------------------------------------
    @property
    def is_event_ordered(self) -> bool:
        return self.unit == _ORDERED_UNIT

    @property
    def seconds(self) -> float:
        """Real-time span of one tick, in seconds."""
        if self.is_event_ordered:
            raise EventOrderedError(
                "event-ordered granularity has no real-time span; "
                "it is excluded from time operations (paper §3)"
            )
        return _UNIT_SECONDS[self.unit] * self.value

    def ticks_per(self, finer: "TimeDelta") -> int:
        """Number of ``finer`` ticks per tick of ``self`` (must be integral)."""
        ratio = self.seconds / finer.seconds
        n = round(ratio)
        if n < 1 or abs(ratio - n) > 1e-9 * max(1.0, n):
            raise ValueError(
                f"{self} is not an integral multiple of {finer} (ratio={ratio})"
            )
        return n

    def is_coarser_or_equal(self, other: "TimeDelta") -> bool:
        """True iff self >= other in the coarseness order (paper: tau_hat >= tau)."""
        if self.is_event_ordered or other.is_event_ordered:
            raise EventOrderedError(
                "event-ordered granularity is not comparable in coarseness"
            )
        return self.seconds >= other.seconds - 1e-12

    # -- comparisons: a <= b  <=>  b is coarser ----------------------------
    def __le__(self, other: "TimeDelta") -> bool:
        return other.is_coarser_or_equal(self)

    def __lt__(self, other: "TimeDelta") -> bool:
        return self <= other and self.seconds < other.seconds

    def __ge__(self, other: "TimeDelta") -> bool:
        return self.is_coarser_or_equal(other)

    def __gt__(self, other: "TimeDelta") -> bool:
        return self >= other and self.seconds > other.seconds

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        if self.is_event_ordered:
            return "TimeDelta(event-ordered)"
        return f"TimeDelta({self.value}{self.unit})"
