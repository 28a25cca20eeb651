"""Structured telemetry for the port: spans, counters, gauges, histograms.

``records``, ``sinks`` and ``telemetry`` are verbatim copies of the
reference's JAX-free ``repro.obs`` modules (only their imports name this
package), so the port emits the same JSONL records: ``TrainLoop.fit``
rebuilds its history from them, and ``PrefetchLoader`` and the pipeline
instrument through them. ``profiler`` ports the reference's runtime hooks
onto PyTorch: ``torch.profiler`` trace capture and CUDA allocator gauges.
"""

from repro_torch.obs.profiler import device_memory_gauges, trace_capture
from repro_torch.obs.records import bench_record, validate
from repro_torch.obs.sinks import FileSink, MemorySink, NullSink, Sink
from repro_torch.obs.telemetry import (
    NULL,
    EwmaGauge,
    Histogram,
    Telemetry,
    span_report,
)

__all__ = [
    "Telemetry",
    "NULL",
    "EwmaGauge",
    "Histogram",
    "span_report",
    "Sink",
    "NullSink",
    "MemorySink",
    "FileSink",
    "validate",
    "bench_record",
    "trace_capture",
    "device_memory_gauges",
]
