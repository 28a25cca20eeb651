"""Segment sum: the CUDA kernel, its plain version and the ``mode=``
dispatch."""

from repro_torch.kernels.segment_reduce.kernel import (
    LAUNCHES,
    reset_launches,
    segment_sum_kernel,
)
from repro_torch.kernels.segment_reduce.ops import segment_sum
from repro_torch.kernels.segment_reduce.ref import segment_sum_ref

__all__ = ["LAUNCHES", "reset_launches", "segment_sum", "segment_sum_kernel",
           "segment_sum_ref"]
