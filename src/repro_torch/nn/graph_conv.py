"""Graph convolution over COO edge lists (snapshot/DTDG models).

Port of ``repro.nn.graph_conv``. Message passing is a segment reduction over
a snapshot's fixed-size (padded) edge list; every aggregation goes through
``repro_torch.kernels.segment_reduce.segment_sum`` (the CUDA kernel for CUDA
tensors, its plain version on the CPU; ``mode`` as in that op). Padding
edges carry id 0 and weight 0, as in the reference, so the kernel sees raw,
unsorted ids.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.segment_reduce import segment_sum
from repro_torch.nn.linear import dense, dense_init


def segment_agg(values, seg_ids, num_segments: int, *, mode: str = "auto"):
    """Segment-sum ``values`` (E,) or (E, D) by ``seg_ids`` into
    ``num_segments`` rows; differentiable with respect to ``values``."""
    if values.dim() == 1:
        return segment_sum(values[:, None], seg_ids, num_segments,
                           mode=mode)[:, 0]
    return segment_sum(values, seg_ids, num_segments, mode=mode)


def gcn_layer_init(gen, d_in: int, d_out: int, device="cpu"):
    """Init one GCN layer (a dense transform)."""
    return {"lin": dense_init(gen, d_in, d_out, device=device)}


def gcn_layer(params, x, src, dst, edge_mask, num_nodes: int, *,
              mode: str = "auto"):
    """Symmetric-normalized GCN layer.

    x: (N, d_in); src/dst: (E,) int; edge_mask: (E,) bool (padding).
    Self-loops enter through the degree normalization and the identity term
    (Kipf & Welling's renormalization), as in the reference: four segment
    sums, two of width 1 (the degrees) and two of the layer's width.
    """
    w = edge_mask.to(x.dtype)
    deg = (segment_agg(w, src, num_nodes, mode=mode)
           + segment_agg(w, dst, num_nodes, mode=mode)
           + 1.0)  # self loop
    dinv = torch.rsqrt(deg)
    h = dense(params["lin"], x)
    s, d = src.long(), dst.long()
    coeff = (dinv[s] * dinv[d] * w)[:, None]
    agg = segment_agg(coeff * h[d], src, num_nodes, mode=mode)
    agg = agg + segment_agg(coeff * h[s], dst, num_nodes, mode=mode)
    return agg + dinv[:, None] ** 2 * h  # self-loop term


def gcn_init(gen, dims, device="cpu"):
    """Init a GCN stack with layer widths ``dims``."""
    return {f"layer_{i}": gcn_layer_init(gen, dims[i], dims[i + 1], device)
            for i in range(len(dims) - 1)}


def gcn(params, x, src, dst, edge_mask, num_nodes: int, act=torch.relu, *,
        mode: str = "auto"):
    """Multi-layer GCN forward over one padded snapshot edge list."""
    n = len(params)
    for i in range(n):
        x = gcn_layer(params[f"layer_{i}"], x, src, dst, edge_mask, num_nodes,
                      mode=mode)
        if i < n - 1:
            x = act(x)
    return x
