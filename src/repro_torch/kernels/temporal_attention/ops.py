"""Public fused temporal attention ops with ``mode=`` dispatch.

``fused_temporal_layer``     — the TGAT layer-0 compute over the packed
                               recency buffer, with the time and edge bias
                               folds (kernel ``fused_temporal_layer``).
``fused_recency_attention``  — the ids-only variant (no bias groups).

``mode``:
  * ``"auto"``   — the CUDA kernel for CUDA tensors, the plain PyTorch
                   version for CPU tensors;
  * ``"ref"``    — force the plain version (any device);
  * ``"kernel"`` — force the CUDA kernel; raises on CPU tensors.

There is no fallback: a CUDA tensor in ``"auto"`` launches the kernel or
raises. On the kernel path ``fused_temporal_layer`` is differentiable
through ``_FusedLayerFn``, the counterpart of the reference's custom VJP
(``repro.kernels.temporal_attention.ops._fused_layer_call``): its forward
launches the forward kernel and saves only the operands, its backward
launches the backward kernel, which recomputes the attention. On the CPU
plain autograd differentiates the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.temporal_attention.kernel import (
    fused_recency_attention_kernel,
    fused_temporal_layer_bwd_kernel,
    fused_temporal_layer_kernel,
)
from repro_torch.kernels.temporal_attention.ref import (
    GRAD_NAMES,
    fused_recency_attention_ref,
    fused_temporal_layer_ref,
)

# The two launches of ``_FusedLayerFn``. Module attributes so that the CPU
# tests can stand the plain versions in for them; nothing else rebinds them.
_FWD = fused_temporal_layer_kernel
_BWD = fused_temporal_layer_bwd_kernel

# Names of ``_FusedLayerFn``'s positional arguments, in order. Its backward
# returns a gradient for those in ``GRAD_NAMES`` and None for the rest
# (seeds, seed times, buffer, edge storage).
_ARGS = ("q", "k_table", "v_table", "seeds", "seed_times", "buf", "time_w",
         "time_b", "wt_k", "wt_v", "edge_feats", "we_k", "we_v")


def _use_kernel(mode: str, x: torch.Tensor) -> bool:
    """Resolve a dispatch mode against the operand's device."""
    if mode not in ("auto", "ref", "kernel"):
        raise ValueError(f"unknown kernel dispatch mode {mode!r}")
    if mode == "kernel" and x.device.type != "cuda":
        raise ValueError(
            f"mode='kernel' needs CUDA tensors; got a tensor on {x.device}")
    return mode == "kernel" or (mode == "auto" and x.device.type == "cuda")


class _FusedLayerFn(torch.autograd.Function):
    """The fused layer with the backward kernel as its gradient.

    ``forward`` launches the forward kernel and saves only its operands;
    ``backward`` launches the backward kernel on the stream current inside
    ``backward`` (autograd runs it on the forward's stream) and reshapes each
    gradient to its operand's shape. No (S, K, ...) tensor is saved: the
    backward recomputes the attention from the operands.
    """

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        kw = dict(zip(_ARGS, args))
        return _FWD(**kw)

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        kw = dict(zip(_ARGS, args))
        grads = _BWD(g.contiguous(), **kw)
        return tuple(
            grads[name].reshape(x.shape).to(x.dtype)
            if name in GRAD_NAMES and x is not None else None
            for name, x in kw.items())


def fused_temporal_layer(q, k_table, v_table, seeds, seed_times, buf, *,
                         time_w=None, time_b=None, wt_k=None, wt_v=None,
                         edge_feats=None, we_k=None, we_v=None,
                         mode: str = "auto"):
    """Fused TGAT/TGN-style layer attention over the packed recency buffer.

    For each seed ``s`` with packed buffer row ``buf[seeds[s]]``:

      k[s, j] = k_table[id_j] + phi(t_s - t_j) @ wt_k
                + edge_feats[eid_j] @ we_k        (v analogously)
      out[s]  = softmax((q[s] * scale) . k[s]) @ v[s]   over valid slots

    Shapes as in ``ref.fused_temporal_layer_ref``; seeds, seed times and
    the buffer are narrowed to contiguous int32 here, as the reference
    casts them.
    """
    kw = dict(time_w=time_w, time_b=time_b, wt_k=wt_k, wt_v=wt_v,
              edge_feats=edge_feats, we_k=we_k, we_v=we_v)
    if not _use_kernel(mode, q):
        return fused_temporal_layer_ref(q, k_table, v_table, seeds,
                                        seed_times, buf, **kw)
    seeds = seeds.to(torch.int32).contiguous()
    if seed_times is not None:
        seed_times = seed_times.to(torch.int32).contiguous()
    kw = {k: None if v is None else v.contiguous() for k, v in kw.items()}
    return _FusedLayerFn.apply(
        q.contiguous(), k_table.contiguous(), v_table.contiguous(), seeds,
        seed_times, buf.to(torch.int32).contiguous(),
        *(kw[name] for name in _ARGS[6:]))


def fused_recency_attention(q, k_table, v_table, seeds, buf_ids, *,
                            mode: str = "auto"):
    """q: (S, H, D); k_table, v_table: (N, H, D); seeds: (S,);
    buf_ids: (Nb, K) resident buffer id rows -> (S, H, D)."""
    if not _use_kernel(mode, q):
        return fused_recency_attention_ref(q, k_table, v_table, seeds, buf_ids)
    return fused_recency_attention_kernel(
        q.contiguous(), k_table.contiguous(), v_table.contiguous(),
        seeds.to(torch.int32).contiguous(),
        buf_ids.to(torch.int32).contiguous())
