"""Public segment-sum op with ``mode=`` dispatch.

``mode`` resolves through ``repro_torch.kernels.use_kernel``: ``"auto"``
runs the CUDA kernel for CUDA tensors and the plain version for CPU
tensors, ``"ref"`` the plain version anywhere, ``"kernel"`` the kernel
(raising on the CPU). There is no fallback: a CUDA tensor in ``"auto"``
launches the kernel or raises.

On the kernel path ``segment_sum`` is differentiable in ``data`` through
``_SegmentSumFn``, the counterpart of the reference's custom VJP
(``repro.kernels.segment_reduce.ops._segment_sum_call``): its forward
launches the kernel and saves only the ids; its backward is the gather of
the output's gradient, plain PyTorch as the reference's is plain jnp. The
reference tiles the segment space above 2,048 for the TPU's VMEM; the CUDA
kernel takes any segment count in one launch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.segment_reduce.kernel import segment_sum_kernel
from repro_torch.kernels.segment_reduce.ref import segment_sum_ref

# The forward launch of ``_SegmentSumFn``. A module attribute so that the
# CPU tests can stand the plain version in for it; nothing else rebinds it.
_FWD = segment_sum_kernel


class _SegmentSumFn(torch.autograd.Function):
    """The kernel's segment sum with the reference's gather as its
    gradient: ``d_data[e] = g[seg_ids[e]]`` where the id is kept, 0 where it
    was dropped (the gather clamps the id into range first, as JAX's does)."""

    @staticmethod
    def forward(ctx, data, seg_ids, num_segments):
        ctx.save_for_backward(seg_ids)
        ctx.num_segments = num_segments
        return _FWD(data, seg_ids, num_segments)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        G = ctx.num_segments
        keep = ((ids >= 0) & (ids < G)).to(g.dtype)
        return g[ids.long().clamp(0, max(G - 1, 0))] * keep[:, None], None, None


def segment_sum(data, seg_ids, num_segments: int, *, mode: str = "auto"):
    """data: (E, D) float; seg_ids: (E,) int in any order ->
    (num_segments, D) float32. Rows whose id lies outside
    ``[0, num_segments)`` (the padding id -1) are dropped. Differentiable
    with respect to ``data`` on every path."""
    if not use_kernel(mode, data):
        return segment_sum_ref(data, seg_ids, num_segments)
    return _SegmentSumFn.apply(data.to(torch.float32).contiguous(),
                               seg_ids.to(torch.int32).contiguous(),
                               int(num_segments))
