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
raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.temporal_attention.kernel import (
    fused_recency_attention_kernel,
    fused_temporal_layer_kernel,
)
from repro_torch.kernels.temporal_attention.ref import (
    fused_recency_attention_ref,
    fused_temporal_layer_ref,
)


def _use_kernel(mode: str, x: torch.Tensor) -> bool:
    """Resolve a dispatch mode against the operand's device."""
    if mode not in ("auto", "ref", "kernel"):
        raise ValueError(f"unknown kernel dispatch mode {mode!r}")
    if mode == "kernel" and x.device.type != "cuda":
        raise ValueError(
            f"mode='kernel' needs CUDA tensors; got a tensor on {x.device}")
    return mode == "kernel" or (mode == "auto" and x.device.type == "cuda")


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
    return fused_temporal_layer_kernel(
        q.contiguous(), k_table.contiguous(), v_table.contiguous(), seeds,
        seed_times, buf.to(torch.int32).contiguous(),
        **{k: None if v is None else v.contiguous() for k, v in kw.items()})


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
