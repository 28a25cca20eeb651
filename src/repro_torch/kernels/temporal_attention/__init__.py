"""Temporal neighbor attention: the CUDA kernels (the fused layer forward
and backward, and the classic path's masked attention and its gradient),
their plain versions and the ``mode=`` dispatch."""

from repro_torch.kernels.temporal_attention.kernel import (
    LAUNCHES,
    fused_recency_attention_kernel,
    fused_temporal_layer_bwd_kernel,
    fused_temporal_layer_kernel,
    reset_launches,
    ta_plan,
    temporal_attention_bwd_kernel,
    temporal_attention_kernel,
)
from repro_torch.kernels.temporal_attention.ops import (
    fused_recency_attention,
    fused_temporal_layer,
    fused_temporal_layer_hop2,
    fused_temporal_layer_per_seed,
    fused_temporal_layer_sharded,
    temporal_attention,
)
from repro_torch.kernels.temporal_attention.ref import (
    fused_recency_attention_ref,
    fused_temporal_layer_bwd_factored_ref,
    fused_temporal_layer_bwd_ref,
    fused_temporal_layer_factored_ref,
    fused_temporal_layer_ref,
    temporal_attention_bwd_ref,
    temporal_attention_ref,
)

__all__ = [
    "LAUNCHES",
    "fused_recency_attention",
    "fused_recency_attention_kernel",
    "fused_recency_attention_ref",
    "fused_temporal_layer",
    "fused_temporal_layer_bwd_factored_ref",
    "fused_temporal_layer_bwd_kernel",
    "fused_temporal_layer_bwd_ref",
    "fused_temporal_layer_factored_ref",
    "fused_temporal_layer_hop2",
    "fused_temporal_layer_kernel",
    "fused_temporal_layer_per_seed",
    "fused_temporal_layer_ref",
    "fused_temporal_layer_sharded",
    "reset_launches",
    "ta_plan",
    "temporal_attention",
    "temporal_attention_bwd_kernel",
    "temporal_attention_bwd_ref",
    "temporal_attention_kernel",
    "temporal_attention_ref",
]
