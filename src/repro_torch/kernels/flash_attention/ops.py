"""Public flash attention op with ``mode=`` dispatch.

``mode`` resolves through ``repro_torch.kernels.use_kernel``: ``"auto"``
runs the CUDA kernels for CUDA tensors and the plain version for CPU
tensors, ``"ref"`` the plain version anywhere, ``"kernel"`` the kernels
(raising on the CPU). There is no fallback: a CUDA tensor in ``"auto"``
launches a kernel or raises.

On the kernel path a call that needs a gradient (grad mode on and any of q,
k, v requiring one) goes through ``_FlashAttentionFn``: its forward is K5
with the row log-sum-exp, its backward K5b, which recomputes the
probabilities tile by tile. A call without one is K5 alone, one launch and
no log-sum-exp. On the plain path autograd differentiates the plain
version, as the reference's autodiff does its jnp attention.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_kernel,
    flash_attention_kernel,
)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# The launches of the kernel path. Module attributes so that the CPU tests
# can stand the plain versions in for them; nothing else rebinds them.
_FWD = flash_attention_kernel
_BWD = flash_attention_bwd_kernel


class _FlashAttentionFn(torch.autograd.Function):
    """K5 with K5b as its gradient.

    ``forward`` launches K5, which also writes the row log-sum-exp, and
    saves q, k, v, the output and the log-sum-exp (no (Sq, Skv) tensor);
    ``backward`` launches K5b on them and the cotangent (made contiguous,
    as K5b reads it through its strides like any operand).
    """

    @staticmethod
    def forward(ctx, q, k, v, causal, window, layout):
        o, lse = _FWD(q, k, v, causal=causal, window=window, layout=layout,
                      return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.attn = dict(causal=causal, window=window, layout=layout)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _BWD(q, k, v, o, lse, do.contiguous(), **ctx.attn)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    mode: str = "auto", layout: str = "bhsd"):
    """q: (B, H, Sq, D); k, v: (B, Hk, Skv, D) -> (B, H, Sq, D); with
    ``layout="bshd"`` the model's (B, S, H, D) tensors, in and out.
    Differentiable in q, k and v on every path. (The reference's
    ``block_q``/``block_k`` tile the TPU kernel; the CUDA kernels' tiles are
    fixed per dtype (``kernel.TILES``, ``kernel.BWD_TILES``), so they are
    not taken.)
    """
    if use_kernel(mode, q):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _FlashAttentionFn.apply(q, k, v, causal, window, layout)
        return _FWD(q, k, v, causal=causal, window=window, layout=layout)
    if layout == "bshd":
        o = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal, window=window)
        return o.transpose(1, 2)
    return flash_attention_ref(q, k, v, causal=causal, window=window)
