"""SSD chunk scan (K6) and its backward (K6b): the CUDA kernels, their
plain versions and the ``mode=`` dispatch."""

from repro_torch.kernels.ssd_chunk.kernel import (
    LAUNCHES,
    reset_launches,
    ssd_chunk_bwd_kernel,
    ssd_chunk_kernel,
)
from repro_torch.kernels.ssd_chunk.ops import ssd, ssd_chunk_scan
from repro_torch.kernels.ssd_chunk.ref import (
    ssd_chunk_bwd_ref,
    ssd_chunk_ref,
    ssd_chunk_states_ref,
    ssd_ref,
)

__all__ = ["LAUNCHES", "reset_launches", "ssd", "ssd_chunk_bwd_kernel",
           "ssd_chunk_bwd_ref", "ssd_chunk_kernel", "ssd_chunk_ref",
           "ssd_chunk_scan", "ssd_chunk_states_ref", "ssd_ref"]
