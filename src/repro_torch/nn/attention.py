"""Multi-head attention primitives for the TG model zoo.

``mha`` is plain multi-head attention (any number of queries);
``seed_neighbor_attention`` is the classic path over a pre-gathered
``(S, K, Dkv)`` neighbor tensor, one query per seed, whose attention core
runs in the hand-written CUDA kernel ``temporal_attention`` on the GPU;
``fused_seed_neighbor_attention`` is its fused twin over the device
sampler's packed buffer, whose attention runs in the fused layer's kernel
(``kernels.temporal_attention``); ``fused_final_hop_attention`` is 2-layer
TGAT's final hop over per-seed tables of computed frontier embeddings.
"""

from __future__ import annotations

import math

import torch

from repro_torch.nn.linear import dense, dense_init

NEG_INF = -1e9


def mha_init(gen, d_q: int, d_kv: int, d_model: int, num_heads: int,
             device="cpu"):
    """Init q/k/v/o dense params for multi-head attention with separate
    query (d_q) and key/value (d_kv) input widths."""
    if d_model % num_heads:
        raise ValueError(f"d_model {d_model} not divisible by heads {num_heads}")
    return {
        "q": dense_init(gen, d_q, d_model, device=device),
        "k": dense_init(gen, d_kv, d_model, device=device),
        "v": dense_init(gen, d_kv, d_model, device=device),
        "o": dense_init(gen, d_model, d_model, device=device),
    }


def _split_heads(x, h):
    *lead, d = x.shape
    return x.reshape(*lead, h, d // h)


def mha(params, q_in, kv_in, mask=None, num_heads: int = 2):
    """q_in: (..., Lq, Dq); kv_in: (..., Lk, Dkv); mask: (..., Lq, Lk) bool.

    Returns (..., Lq, d_model).
    """
    h = num_heads
    q = _split_heads(dense(params["q"], q_in), h)  # (..., Lq, H, dh)
    k = _split_heads(dense(params["k"], kv_in), h)
    v = _split_heads(dense(params["v"], kv_in), h)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("...qhd,...khd->...hqk", q, k) * scale
    if mask is not None:
        logits = torch.where(mask[..., None, :, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    if mask is not None:
        # Rows with no valid key: zero output instead of uniform garbage.
        any_valid = mask[..., None, :, :].any(-1, keepdim=True)
        w = torch.where(any_valid, w, 0.0)
    out = torch.einsum("...hqk,...khd->...qhd", w, v)
    *lead, Lq, H, dh = out.shape
    return dense(params["o"], out.reshape(*lead, Lq, H * dh))


def seed_neighbor_attention(params, seed_feat, nbr_feat, nbr_mask,
                            num_heads: int = 2, mode: str = "auto"):
    """TGAT-style: one query (the seed) attends over its K neighbors.

    seed_feat: (S, Dq); nbr_feat: (S, K, Dkv); nbr_mask: (S, K) bool.
    Returns (S, d_model). The projections are ``mha``'s; the masked
    attention is ``temporal_attention`` (``mode`` forwarded: the CUDA kernel
    for CUDA tensors under "auto"). It masks with -1e30 where ``mha`` masks
    with -1e9: the same weights for a seed with a valid neighbor, and exact
    zeros for one without, in both.
    """
    from repro_torch.kernels.temporal_attention import temporal_attention

    h = num_heads
    q = _split_heads(dense(params["q"], seed_feat), h)  # (S, H, dh)
    k = _split_heads(dense(params["k"], nbr_feat), h)   # (S, K, H, dh)
    v = _split_heads(dense(params["v"], nbr_feat), h)
    out = temporal_attention(q, k, v, nbr_mask, mode=mode)
    S, H, dh = out.shape
    return dense(params["o"], out.reshape(S, H * dh))


def fused_seed_neighbor_attention(params, node_kv_in, q_in, seeds, seed_times,
                                  buf, time_params, d_edge: int = 0,
                                  edge_table=None, num_heads: int = 2,
                                  mode: str = "auto", node_axis=None,
                                  buf_rows=None):
    """Fused twin of ``seed_neighbor_attention`` over the packed buffer.

    The kv projection ``concat([node, edge, time]) @ W`` is split by input
    rows of ``W`` into ``[node | edge | time]``: the node term becomes an
    (N, H, Dh) table (dense bias folded in), while the edge-feature and
    Bochner time-encoding terms are added per neighbor slot by
    ``fused_temporal_layer`` — inside the CUDA kernel on the GPU, so the
    ``(S, K, H, Dh)`` gather never lands in device memory.

    node_kv_in: (N, d_node); q_in: (S, Dq) query inputs (projected here);
    seeds/seed_times: (S,); buf: (Nb, K, 3); time_params: ``time_encode``
    params; edge_table: (E, d_edge) edge-feature storage (or None).
    ``mode`` is forwarded to ``fused_temporal_layer``. With ``node_axis``
    (the node axis's process group) and ``buf_rows`` the attention runs
    through ``fused_temporal_layer_sharded``: ``buf`` is then this rank's
    ``(buf_rows + 1, K, 3)`` block of the node-partitioned buffer, and the
    output is summed over the group. Returns (S, d_model).
    """
    from repro_torch.kernels.temporal_attention import (
        fused_temporal_layer,
        fused_temporal_layer_sharded,
    )

    d_model = params["o"]["w"].shape[0]
    h = num_heads
    dh = d_model // h
    d_node = node_kv_in.shape[-1]
    wk, wv = params["k"], params["v"]
    k_tab = (node_kv_in @ wk["w"][:d_node] + wk["b"]).reshape(-1, h, dh)
    v_tab = (node_kv_in @ wv["w"][:d_node] + wv["b"]).reshape(-1, h, dh)
    use_edge = bool(d_edge) and edge_table is not None
    we_k = wk["w"][d_node:d_node + d_edge] if use_edge else None
    we_v = wv["w"][d_node:d_node + d_edge] if use_edge else None
    wt_k = wk["w"][d_node + d_edge:]
    wt_v = wv["w"][d_node + d_edge:]
    q = _split_heads(dense(params["q"], q_in), h)  # (S, H, Dh)
    kw = dict(time_w=time_params["w"], time_b=time_params["b"], wt_k=wt_k,
              wt_v=wt_v, edge_feats=edge_table if use_edge else None,
              we_k=we_k, we_v=we_v, mode=mode)
    if node_axis is not None:
        kw.update(group=node_axis, rows_per_shard=buf_rows)
    layer = (fused_temporal_layer if node_axis is None
             else fused_temporal_layer_sharded)
    att = layer(q, k_tab, v_tab, seeds.to(torch.int32),
                seed_times.to(torch.int32), buf, **kw)
    return dense(params["o"], att.reshape(-1, d_model))


def fused_final_hop_attention(params, nbr_kv_in, q_in, seed_times, nbr_times,
                              nbr_eids, nbr_mask, time_params,
                              d_edge: int = 0, edge_table=None,
                              num_heads: int = 2, mode: str = "auto"):
    """2-layer TGAT's final hop, fused: each seed attends over its own K
    computed hop-1 embeddings.

    The frontier rows are projected flat into per-seed (S * K, H, Dh) k/v
    tables (dense bias folded in) and handed to
    ``fused_temporal_layer_per_seed``, which adds the edge and time terms
    per slot (in the CUDA kernel on the GPU), so no (S, K, ·) float tensor
    is built, forward or backward.

    nbr_kv_in: (S * K, d_node) frontier embeddings (row ``s*K + j`` is seed
    s's j-th neighbor); q_in: (S, Dq) query inputs (projected here);
    seed_times: (S,); nbr_times/nbr_eids/nbr_mask: (S, K); time_params:
    ``time_encode`` params; edge_table: (E, d_edge) edge-feature storage (or
    None). ``mode`` is forwarded. Returns (S, d_model).
    """
    from repro_torch.kernels.temporal_attention import (
        fused_temporal_layer_per_seed,
    )

    d_model = params["o"]["w"].shape[0]
    h = num_heads
    dh = d_model // h
    d_node = nbr_kv_in.shape[-1]
    wk, wv = params["k"], params["v"]
    k_rows = (nbr_kv_in @ wk["w"][:d_node] + wk["b"]).reshape(-1, h, dh)
    v_rows = (nbr_kv_in @ wv["w"][:d_node] + wv["b"]).reshape(-1, h, dh)
    use_edge = bool(d_edge) and edge_table is not None
    we_k = wk["w"][d_node:d_node + d_edge] if use_edge else None
    we_v = wv["w"][d_node:d_node + d_edge] if use_edge else None
    wt_k = wk["w"][d_node + d_edge:]
    wt_v = wv["w"][d_node + d_edge:]
    q = _split_heads(dense(params["q"], q_in), h)  # (S, H, Dh)
    att = fused_temporal_layer_per_seed(
        q, k_rows, v_rows, seed_times.to(torch.int32),
        nbr_times.to(torch.int32), nbr_mask,
        nbr_eids=nbr_eids if use_edge else None,
        time_w=time_params["w"], time_b=time_params["b"],
        wt_k=wt_k, wt_v=wt_v, edge_feats=edge_table if use_edge else None,
        we_k=we_k, we_v=we_v, mode=mode,
    )
    return dense(params["o"], att.reshape(-1, d_model))
