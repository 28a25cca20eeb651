"""Public flash attention op with ``mode=`` dispatch.

``mode`` resolves through ``repro_torch.kernels.use_kernel``: ``"auto"``
runs the CUDA kernel (K5) for CUDA tensors and the plain version for CPU
tensors, ``"ref"`` the plain version anywhere, ``"kernel"`` the kernel
(raising on the CPU). There is no fallback: a CUDA tensor in ``"auto"``
launches the kernel or raises. Forward only, as in the reference (its
family trains through the plain version).
"""

from __future__ import annotations

from repro_torch.kernels import use_kernel
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    mode: str = "auto", layout: str = "bhsd"):
    """q: (B, H, Sq, D); k, v: (B, Hk, Skv, D) -> (B, H, Sq, D); with
    ``layout="bshd"`` the model's (B, S, H, D) tensors, in and out. (The
    reference's ``block_q``/``block_k`` tile the TPU kernel; the CUDA
    kernel's tiles are fixed per dtype (``kernel.TILES``), so they are not
    taken.)
    """
    if use_kernel(mode, q):
        return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                      layout=layout)
    if layout == "bshd":
        o = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal, window=window)
        return o.transpose(1, 2)
    return flash_attention_ref(q, k, v, causal=causal, window=window)
