"""Flash attention (K5): the CUDA kernel, its plain version and the
``mode=`` dispatch."""

from repro_torch.kernels.flash_attention.kernel import (
    LAUNCHES,
    flash_attention_kernel,
    reset_launches,
)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["LAUNCHES", "flash_attention", "flash_attention_kernel",
           "flash_attention_ref", "reset_launches"]
