"""Public SSD chunk-scan ops with ``mode=`` dispatch.

``mode`` resolves through ``repro_torch.kernels.use_kernel``: ``"auto"``
runs the CUDA kernel (K6) for CUDA tensors and the plain version for CPU
tensors, ``"ref"`` the plain version anywhere, ``"kernel"`` the kernel
(raising on the CPU). There is no fallback: a CUDA tensor in ``"auto"``
launches the kernel or raises. K6 is forward only, as in the reference, and
it writes its outputs through ctypes, out of autograd's sight: so on the
kernel path a call that needs a gradient (grad mode on and an input that
requires one) raises ``NotImplementedError`` rather than return outputs
that silently detach everything upstream. Training the ssm and hybrid
families on the card waits for K6's backward kernel (ROADMAP A6, the next
item); on the CPU the plain version trains by autograd.

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


# The kernel launch. A module attribute so that the CPU tests can stand a
# stub in for it; nothing else rebinds it.
_FWD = ssd_chunk_kernel


def _no_grad_needed(*tensors) -> None:
    """Raise where autograd would need K6's gradient (see the module
    docstring)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "K6 (the SSD chunk-scan kernel) has no backward yet: training the "
            "ssm and hybrid families on the card waits for its backward "
            "kernel (ROADMAP A6, next item). Use mode='ref', or run under "
            "torch.no_grad() for inference.")


def ssd(x, dt, a, B, C, *, mode: str = "auto"):
    """x: (S, H, P); dt: (S, H); a: (H,); B, C: (S, H, N) -> y (S, H, P).

    (The reference's ``chunk`` sizes the TPU kernel's chunk; the CUDA
    kernel's is fixed: 128 for bfloat16 inputs, 32 for float32 ones. Only
    rounding depends on it.)
    """
    if use_kernel(mode, x):
        _no_grad_needed(x, dt, a, B, C)
        y, _ = _FWD(x[None], dt.float()[None], a.float(), B[None], C[None])
        return y[0]
    y, _ = ssd_ref(x, dt, a, B, C)
    return y.to(x.dtype)


def ssd_chunk_scan(x, dt, a, Bm, Cm, *, mode: str = "auto"):
    """x: (Bsz, S, H, P); dt: (Bsz, S, H); a: (H,); Bm, Cm: (Bsz, S, G, N)
    -> (y (Bsz, S, H, P) in x's dtype, final_state (Bsz, H, P, N) float32),
    from a zero state."""
    if use_kernel(mode, x):
        _no_grad_needed(x, dt, a, Bm, Cm)
        return _FWD(x, dt.to(torch.float32), a.to(torch.float32), Bm, Cm)
    return ssd_chunk_ref(x, dt, a, Bm, Cm)
