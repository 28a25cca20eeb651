"""Flash attention: the CUDA kernels (K5, the forward, and K5b, its
gradient), their plain versions and the ``mode=`` dispatch."""

from repro_torch.kernels.flash_attention.kernel import (
    LAUNCHES,
    flash_attention_bwd_kernel,
    flash_attention_kernel,
    reset_launches,
)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref,
    flash_attention_lse_ref,
    flash_attention_ref,
)

__all__ = ["LAUNCHES", "flash_attention", "flash_attention_bwd_kernel",
           "flash_attention_bwd_ref", "flash_attention_kernel",
           "flash_attention_lse_ref", "flash_attention_ref", "reset_launches"]
