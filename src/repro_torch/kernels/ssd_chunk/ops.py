"""Public SSD chunk-scan ops with ``mode=`` dispatch.

``mode`` resolves through ``repro_torch.kernels.use_kernel``: ``"auto"``
runs the CUDA kernel (K6) for CUDA tensors and the plain version for CPU
tensors, ``"ref"`` the plain version anywhere, ``"kernel"`` the kernel
(raising on the CPU). There is no fallback: a CUDA tensor in ``"auto"``
launches the kernel or raises. Forward only, as in the reference.

``ssd`` keeps the reference's single-sequence signature (the kernel with
batch 1 and one group per head; plain version: the exact recurrence);
``ssd_chunk_scan`` is the batched, grouped op the model calls, which also
returns the final state.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk_kernel
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref, ssd_ref


def ssd(x, dt, a, B, C, *, mode: str = "auto"):
    """x: (S, H, P); dt: (S, H); a: (H,); B, C: (S, H, N) -> y (S, H, P).

    (The reference's ``chunk`` sizes the TPU kernel's chunk; the CUDA
    kernel's is fixed: 128 for bfloat16 inputs, 32 for float32 ones. Only
    rounding depends on it.)
    """
    if use_kernel(mode, x):
        y, _ = ssd_chunk_kernel(x[None], dt.float()[None], a.float(), B[None],
                                C[None])
        return y[0]
    y, _ = ssd_ref(x, dt, a, B, C)
    return y.to(x.dtype)


def ssd_chunk_scan(x, dt, a, Bm, Cm, *, mode: str = "auto"):
    """x: (Bsz, S, H, P); dt: (Bsz, S, H); a: (H,); Bm, Cm: (Bsz, S, G, N)
    -> (y (Bsz, S, H, P) in x's dtype, final_state (Bsz, H, P, N) float32),
    from a zero state."""
    if use_kernel(mode, x):
        return ssd_chunk_kernel(x, dt.to(torch.float32), a.to(torch.float32),
                                Bm, Cm)
    return ssd_chunk_ref(x, dt, a, Bm, Cm)
