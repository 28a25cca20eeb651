"""Public SSD chunk-scan ops with ``mode=`` dispatch.

``mode`` resolves through ``repro_torch.kernels.use_kernel``: ``"auto"``
runs the CUDA kernels for CUDA tensors and the plain version for CPU
tensors, ``"ref"`` the plain version anywhere, ``"kernel"`` the kernels
(raising on the CPU). There is no fallback: a CUDA tensor in ``"auto"``
launches a kernel or raises.

On the kernel path a call that needs a gradient (grad mode on and an input
that requires one) goes through ``_SSDChunkFn``: its forward is K6, which
then keeps its chunk states and decays (bfloat16: the float32 scratch its
pass 2 leaves, (B, nc, H, P16, N16)) for its backward K6b
(``ssd_chunk_bwd_kernel``), so K6b does not run K6's passes 1-2 again.
Under ``remat`` (non-reentrant ``torch.utils.checkpoint``) the first
forward's saved tensors are dropped and the recompute right before the
layer's backward keeps them, so one layer's states are alive at a time.
Without ``remat`` every layer's states stay alive from its forward to its
backward: 4 x B x chunks x H x P16 x N16 bytes a layer, 201 MB at mamba2-780m's
training shape (B 4, S 4,096, H 48, P 64, N 128), 9.7 GB over its 48
layers, and 26 MB a layer at hymba-1.5b's (H 50, N 16), 0.84 GB over 32.
A call without a gradient is one K6 launch that keeps nothing, as in
serving. On the plain path autograd differentiates the plain version, as
the reference's autodiff does its jnp scan.

``ssd`` keeps the reference's single-sequence signature (the kernels with
batch 1 and one group per head; plain version: the exact recurrence);
``ssd_chunk_scan`` is the batched, grouped op the model calls, which also
returns the final state.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk_bwd_kernel, ssd_chunk_kernel
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref, ssd_ref

# The launches of the kernel path. Module attributes so that the CPU tests
# can stand the plain versions in for them; nothing else rebinds them.
_FWD = ssd_chunk_kernel
_BWD = ssd_chunk_bwd_kernel


class _SSDChunkFn(torch.autograd.Function):
    """K6 with K6b as its gradient.

    ``forward`` launches K6 with ``keep=True`` and saves its inputs (x, dt,
    a, Bm, Cm) and what K6 kept (bfloat16: its chunk states and decays;
    float32: nothing); ``backward`` launches K6b on them, the output's
    cotangent (made contiguous) and the final state's (``None`` in
    training: gradients are not materialized, so an unused final state
    costs nothing). It returns dx, dBm and dCm in the inputs' dtypes, ddt
    and da in float32.
    """

    @staticmethod
    def forward(ctx, x, dt, a, Bm, Cm):
        y, state, kept = _FWD(x, dt, a, Bm, Cm, keep=True)
        ctx.save_for_backward(x, dt, a, Bm, Cm, *(kept or ()))
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, Bm, Cm, *kept = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return _BWD(x, dt, a, Bm, Cm, dy.to(x.dtype).contiguous(),
                    None if dstate is None else dstate.float().contiguous(),
                    kept=tuple(kept) or None)


def _scan(x, dt, a, Bm, Cm):
    """K6, through ``_SSDChunkFn`` when autograd needs its gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a, Bm, Cm)):
        return _SSDChunkFn.apply(x, dt, a, Bm, Cm)
    return _FWD(x, dt, a, Bm, Cm)


def ssd(x, dt, a, B, C, *, mode: str = "auto"):
    """x: (S, H, P); dt: (S, H); a: (H,); B, C: (S, H, N) -> y (S, H, P).

    (The reference's ``chunk`` sizes the TPU kernel's chunk; the CUDA
    kernels' is fixed: 128 for bfloat16 inputs, 32 for float32 ones. Only
    rounding depends on it.)
    """
    if use_kernel(mode, x):
        y, _ = _scan(x[None], dt.float()[None], a.float(), B[None], C[None])
        return y[0]
    y, _ = ssd_ref(x, dt, a, B, C)
    return y.to(x.dtype)


def ssd_chunk_scan(x, dt, a, Bm, Cm, *, mode: str = "auto"):
    """x: (Bsz, S, H, P); dt: (Bsz, S, H); a: (H,); Bm, Cm: (Bsz, S, G, N)
    -> (y (Bsz, S, H, P) in x's dtype, final_state (Bsz, H, P, N) float32),
    from a zero state. Differentiable in every input on every path."""
    if use_kernel(mode, x):
        return _scan(x, dt.to(torch.float32), a.to(torch.float32), Bm, Cm)
    return ssd_chunk_ref(x, dt, a, Bm, Cm)
