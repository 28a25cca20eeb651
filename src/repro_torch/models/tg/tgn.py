"""TGN (Rossi et al., 2020): memory-based temporal graph network.

Twin of ``repro.models.tg.tgn``. The evolving per-node memory is explicit
state ``{"memory": (N, dm) float32, "last_update": (N,) int32}`` threaded
through the pipeline. Per batch (predict-then-update):

  1. embed the seeds with temporal attention over their neighbors, node
     features = memory ‖ learned embedding;
  2. score links;
  3. build messages [mem_src ‖ mem_dst ‖ phi(dt) ‖ edge_feat] for both
     endpoints, keep each node's *last* message, GRU-update the memory.

The embedding runs the fused layer when the batch carries the device
sampler's packed buffer (``nbr_buf``; K1, and K2 in the backward, on the
GPU) and the classic pre-gathered path otherwise (the host sampler; its
attention is K3 on the GPU), as ``tgat.embed`` does. As in the reference,
whose jitted step takes the state as an input and returns the new state as
an auxiliary output, no gradient reaches the memory update: ``link_scores``
computes the new state outside the autograd graph, so the GRU's gradients
are zero.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.tg.common import (
    all_node_features,
    classic_mode,
    fused_mode,
    link_decoder_init,
    link_logits,
    node_feature_init,
    node_features,
)
from repro_torch.nn.attention import (
    fused_seed_neighbor_attention,
    mha_init,
    seed_neighbor_attention,
)
from repro_torch.nn.mlp import mlp, mlp_init
from repro_torch.nn.recurrent import gru, gru_init
from repro_torch.nn.time_encode import time_encode, time_encode_init


@dataclasses.dataclass(frozen=True)
class TGNConfig:
    num_nodes: int
    d_edge: int = 0
    d_static: int = 0
    d_model: int = 100
    d_time: int = 100
    d_memory: int = 100
    num_heads: int = 2
    k: int = 10


def init(cfg: TGNConfig, generator: torch.Generator, device="cpu"):
    """Random parameters with the reference's distributions, drawn from
    ``generator`` in the reference's order (nodes, time encoding, attention,
    merge MLP, GRU, decoder)."""
    g = generator
    d_msg = 2 * cfg.d_memory + cfg.d_time + cfg.d_edge
    d_kv = cfg.d_memory + cfg.d_model + cfg.d_edge + cfg.d_time
    return {
        "nodes": node_feature_init(g, cfg.num_nodes, cfg.d_static,
                                   cfg.d_model, device),
        "time": time_encode_init(g, cfg.d_time, device=device),
        "attn": mha_init(g, cfg.d_memory + cfg.d_model + cfg.d_time, d_kv,
                         cfg.d_model, cfg.num_heads, device),
        "merge": mlp_init(g, [cfg.d_model + cfg.d_memory + cfg.d_model,
                              cfg.d_model, cfg.d_model], device=device),
        "gru": gru_init(g, d_msg, cfg.d_memory, device=device),
        "decoder": link_decoder_init(g, cfg.d_model, device=device),
    }


def init_state(cfg: TGNConfig, device="cpu"):
    """Empty memory: zeros, and every node last updated at time 0."""
    return {
        "memory": torch.zeros((cfg.num_nodes, cfg.d_memory),
                              dtype=torch.float32, device=device),
        "last_update": torch.zeros((cfg.num_nodes,), dtype=torch.int32,
                                   device=device),
    }


def _zero_time(params, seed_t):
    return time_encode(params["time"],
                       torch.zeros(seed_t.shape, dtype=torch.float32,
                                   device=seed_t.device))


def _embed_fused(params, cfg: TGNConfig, state, batch, static_feats, mode,
                 node_axis=None, buf_rows=None):
    """Device-sampling embed: attention over the packed buffer. The kv
    input's node-level slice is ``memory ‖ node features`` — both (N, ·)
    tables — so the whole node term of the k/v projections is an (N, H, Dh)
    table; the time and edge terms are folded in by the fused layer."""
    seeds, seed_t = batch["seed_nodes"], batch["seed_times"]
    edge_table = batch.get("edge_feat_table") if cfg.d_edge else None
    mem = state["memory"]
    h_all = all_node_features(params["nodes"], static_feats)
    node_kv = torch.cat([mem, h_all], dim=-1)  # (N, d_mem + d_model)
    safe = torch.clamp(seeds, min=0).long()
    m_seed, h_seed = mem[safe], h_all[safe]
    q_in = torch.cat([m_seed, h_seed, _zero_time(params, seed_t)], dim=-1)
    att = fused_seed_neighbor_attention(
        params["attn"], node_kv, q_in, seeds, seed_t, batch["nbr_buf"],
        params["time"], d_edge=cfg.d_edge, edge_table=edge_table,
        num_heads=cfg.num_heads, mode=mode, node_axis=node_axis,
        buf_rows=buf_rows,
    )
    return mlp(params["merge"], torch.cat([att, m_seed, h_seed], dim=-1))


def embed(params, cfg: TGNConfig, state, batch, static_feats=None,
          fused=None, node_axis=None, buf_rows=None):
    """Temporal-attention embedding of the batch seeds over node memory.

    ``fused``, ``node_axis`` and ``buf_rows`` behave as in ``tgat.embed``
    (``models.tg.common.fused_mode`` and ``classic_mode``).
    """
    mode = fused_mode(fused, batch)
    if mode is not None:
        return _embed_fused(params, cfg, state, batch, static_feats, mode,
                            node_axis, buf_rows)

    seeds, seed_t = batch["seed_nodes"], batch["seed_times"]
    nbr_ids, nbr_t = batch["nbr_ids"], batch["nbr_times"]
    mem = state["memory"]
    h_seed = node_features(params["nodes"], seeds, static_feats)
    m_seed = mem[torch.clamp(seeds, min=0).long()]
    h_nbr = node_features(params["nodes"], nbr_ids, static_feats)
    m_nbr = torch.where((nbr_ids >= 0)[..., None],
                        mem[torch.clamp(nbr_ids, min=0).long()], 0.0)
    q = torch.cat([m_seed, h_seed, _zero_time(params, seed_t)], dim=-1)
    dt = (seed_t.to(torch.int32)[:, None] - nbr_t.to(torch.int32)).float()
    kv = [m_nbr, h_nbr, time_encode(params["time"], dt)]
    if cfg.d_edge and "nbr_feats" in batch:
        kv.insert(2, batch["nbr_feats"])
    att = seed_neighbor_attention(params["attn"], q, torch.cat(kv, dim=-1),
                                  batch["nbr_mask"], num_heads=cfg.num_heads,
                                  mode=classic_mode(fused))
    return mlp(params["merge"], torch.cat([att, m_seed, h_seed], dim=-1))


def update_memory(params, cfg: TGNConfig, state, batch):
    """GRU memory update with last-message-per-node aggregation.

    The reference's ``jax.ops.segment_max`` over event indices is a
    ``scatter_reduce_("amax")`` into -1: a node no valid event touches keeps
    -1 and its memory and ``last_update``; otherwise the largest index in
    the stacked ``[src copies | dst copies]`` wins, as in the reference, so
    a node's dst copy of an event beats its src copy of a later event.
    The GRU runs over every node, as in the reference, and the result is
    kept where a node was touched.
    """
    src, dst, t = batch["src"], batch["dst"], batch["time"]
    mask = batch.get("batch_mask")
    if mask is None:
        mask = torch.ones(src.shape, dtype=torch.bool, device=src.device)
    edge_feats = batch.get("edge_feats")
    B = src.shape[0]
    mem, last = state["memory"], state["last_update"]

    nodes = torch.cat([src, dst]).long()  # (2B,)
    other = torch.cat([dst, src]).long()
    tt = torch.cat([t, t]).to(torch.int32)
    mm = torch.cat([mask, mask]).to(torch.bool)
    dt = (tt - last[nodes]).float()
    parts = [mem[nodes], mem[other], time_encode(params["time"], dt)]
    if cfg.d_edge:
        ef = (torch.zeros((B, cfg.d_edge), dtype=torch.float32,
                          device=src.device)
              if edge_feats is None else edge_feats.to(torch.float32))
        parts.append(torch.cat([ef, ef], dim=0))
    msgs = torch.cat(parts, dim=-1)  # (2B, d_msg)

    idx = torch.arange(2 * B, device=src.device)
    idx = torch.where(mm, idx, -1)
    seg_last = torch.full((cfg.num_nodes,), -1, dtype=idx.dtype,
                          device=src.device)
    seg_last.scatter_reduce_(0, nodes, idx, reduce="amax")  # (N,)
    touched = seg_last >= 0
    pick = torch.clamp(seg_last, min=0)

    new_mem_all = gru(params["gru"], msgs[pick], mem)
    new_mem = torch.where(touched[:, None], new_mem_all, mem)
    new_last = torch.where(touched, tt[pick].to(last.dtype), last)
    return {"memory": new_mem, "last_update": new_last}


def link_scores(params, cfg: TGNConfig, state, batch, batch_size: int,
                static_feats=None, fused=None, node_axis=None, buf_rows=None):
    """Returns ``((pos (B,), neg (B, Nn)), new_state)``; the new state is
    computed outside the autograd graph (the reference's auxiliary
    output)."""
    h = embed(params, cfg, state, batch, static_feats, fused=fused,
              node_axis=node_axis, buf_rows=buf_rows)
    logits = link_logits(params["decoder"], h, batch_size)
    with torch.no_grad():
        new_state = update_memory(params, cfg, state, batch)
    return logits, new_state
