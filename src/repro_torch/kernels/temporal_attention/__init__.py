"""Fused temporal neighbor attention: the CUDA kernel, its plain version
and the ``mode=`` dispatch."""

from repro_torch.kernels.temporal_attention.kernel import (
    LAUNCHES,
    fused_recency_attention_kernel,
    fused_temporal_layer_kernel,
    reset_launches,
)
from repro_torch.kernels.temporal_attention.ops import (
    fused_recency_attention,
    fused_temporal_layer,
)
from repro_torch.kernels.temporal_attention.ref import (
    fused_recency_attention_ref,
    fused_temporal_layer_ref,
)

__all__ = [
    "LAUNCHES",
    "fused_recency_attention",
    "fused_recency_attention_kernel",
    "fused_recency_attention_ref",
    "fused_temporal_layer",
    "fused_temporal_layer_kernel",
    "fused_temporal_layer_ref",
    "reset_launches",
]
