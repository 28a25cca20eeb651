"""PyTorch-level observability: profiler trace capture and device-memory
gauges (the port of ``repro.obs.profiler``).

The span/counter layer (``repro_torch.obs.telemetry``) sees host wall-clock
only; the two hooks here reach into the PyTorch runtime for the rest:

  * :func:`trace_capture` wraps a code region in ``torch.profiler.profile``
    (CPU activity, plus CUDA where a card is present) and writes a Chrome
    trace (per-kernel device timelines) under a log directory, the "zoom
    in" tool once a span points at a slow phase;
  * :func:`device_memory_gauges` snapshots every visible CUDA device's
    allocator statistics into gauges under the reference's names
    (``device{i}/bytes_in_use`` etc.). Without CUDA it sets nothing and
    returns ``{}``, as the reference's does on a CPU-only host.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

from repro_torch.obs.telemetry import Telemetry


@contextlib.contextmanager
def trace_capture(logdir: str, telemetry: Optional[Telemetry] = None):
    """Capture a ``torch.profiler`` trace of the enclosed region.

    Writes ``trace.<pid>.<ns>.json`` (Chrome trace format: open it in
    Perfetto or ``chrome://tracing``) under ``logdir`` when the region
    exits. When ``telemetry`` is given, the region also emits a ``profiler/trace``
    span whose attrs carry the log directory, so the JSONL stream records
    that (and where) a trace was taken.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    tel = telemetry if telemetry is not None else Telemetry()
    os.makedirs(str(logdir), exist_ok=True)
    with tel.span("profiler/trace", logdir=str(logdir)):
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(os.path.join(
            str(logdir), f"trace.{os.getpid()}.{time.time_ns()}.json"))


def device_memory_gauges(telemetry: Telemetry,
                         prefix: str = "device") -> Dict[str, float]:
    """Snapshot per-device memory stats into ``telemetry`` gauges.

    For each visible CUDA device ``i`` sets gauges ``{prefix}{i}/{key}``
    under the reference's (XLA allocator) names, mapped from
    ``torch.cuda.memory_stats(i)``:

      ``bytes_in_use``      ``allocated_bytes.all.current`` (=
                            ``torch.cuda.memory_allocated(i)``)
      ``peak_bytes_in_use`` ``allocated_bytes.all.peak`` (=
                            ``torch.cuda.max_memory_allocated(i)``)
      ``bytes_limit``       the device's ``total_memory``
      ``num_allocs``        ``allocation.all.allocated`` (allocations made
                            since the last reset of the counters)
      ``bytes_reserved``    ``reserved_bytes.all.current`` (held by the
                            caching allocator, = ``memory_reserved(i)``)

    Returns the gauges set (empty without CUDA), so callers can log or
    assert on them directly.
    """
    out: Dict[str, float] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        values = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
            "num_allocs": stats.get("allocation.all.allocated", 0),
            "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
        }
        for key, value in values.items():
            name = f"{prefix}{i}/{key}"
            out[name] = float(value)
            telemetry.gauge(name, value)
    return out
