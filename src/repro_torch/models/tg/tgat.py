"""TGAT (da Xu et al., 2020): temporal graph attention.

Each layer computes a seed embedding by attending over the seed's temporal
neighborhood; keys/values are [neighbor embedding || edge features ||
Bochner time encoding of (t_seed - t_nbr)]. Two layers consume the 2-hop
block produced by the recency neighbor hook (``num_hops=2``).

When the batch carries the device sampler's packed buffer (``nbr_buf``),
``embed`` computes every attention with the fused layer — node-level k/v
tables plus in-kernel time/edge bias folds, the hand-written CUDA kernel on
the GPU — so no ``(S, K, H, Dh)`` neighbor tensor exists in device memory:
two layers embed the hop-1 frontier over the buffer too and run the final
hop over per-seed tables of the computed frontier rows
(``fused_final_hop_attention``). Without the buffer (the host sampler), or
with ``fused=False``, the classic pre-gathered path runs, its masked
attention in the CUDA kernel ``temporal_attention`` on the GPU.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.tg.common import (
    all_node_features,
    classic_mode,
    fused_mode,
    gather_rows,
    link_decoder_init,
    link_logits,
    node_feature_init,
    node_features,
)
from repro_torch.nn.attention import (
    fused_final_hop_attention,
    fused_seed_neighbor_attention,
    mha_init,
    seed_neighbor_attention,
)
from repro_torch.nn.mlp import mlp, mlp_init
from repro_torch.nn.time_encode import time_encode, time_encode_init


@dataclasses.dataclass(frozen=True)
class TGATConfig:
    num_nodes: int
    d_edge: int = 0
    d_static: int = 0
    d_model: int = 100
    d_time: int = 100
    num_heads: int = 2
    num_layers: int = 2  # 1 or 2
    k: int = 20


def init(cfg: TGATConfig, generator: torch.Generator, device="cpu"):
    """Random parameters with the reference's distributions (glorot-normal
    dense weights, zero biases, N(0, 0.02) node embeddings, N(0, 0.1)
    time-encoding parameters), drawn from ``generator``."""
    if cfg.num_layers not in (1, 2):
        raise ValueError(f"TGAT num_layers must be 1 or 2, got {cfg.num_layers}")
    g = generator
    d_kv = cfg.d_model + cfg.d_edge + cfg.d_time
    params = {
        "nodes": node_feature_init(g, cfg.num_nodes, cfg.d_static,
                                   cfg.d_model, device),
        "time": time_encode_init(g, cfg.d_time, device=device),
        "decoder": link_decoder_init(g, cfg.d_model, device=device),
    }
    for l in range(cfg.num_layers):
        params[f"attn_{l}"] = mha_init(g, cfg.d_model + cfg.d_time, d_kv,
                                       cfg.d_model, cfg.num_heads, device)
        params[f"merge_{l}"] = mlp_init(
            g, [cfg.d_model + cfg.d_model, cfg.d_model, cfg.d_model],
            device=device)
    return params


def _layer(params, l, cfg, h_seed, seed_t, h_nbr, nbr_t, nbr_feats, nbr_mask,
           mode="auto"):
    """One classic TGAT layer. h_seed: (S,d); h_nbr: (S,K,d); returns (S,d).
    ``mode`` is the attention's (``temporal_attention``) dispatch."""
    q = torch.cat([h_seed, _time_zero(params, seed_t)], dim=-1)
    dt = (seed_t.to(torch.int32)[:, None] - nbr_t.to(torch.int32)).float()
    enc = time_encode(params["time"], dt)
    kv = [h_nbr, enc] if nbr_feats is None else [h_nbr, nbr_feats, enc]
    kv = torch.cat(kv, dim=-1)
    att = seed_neighbor_attention(params[f"attn_{l}"], q, kv, nbr_mask,
                                  num_heads=cfg.num_heads, mode=mode)
    return mlp(params[f"merge_{l}"], torch.cat([att, h_seed], dim=-1))


def _time_zero(params, seed_t):
    """The time encoding of a zero delta, one row per seed (the query's
    time part)."""
    return time_encode(params["time"],
                       torch.zeros(seed_t.shape, dtype=torch.float32,
                                   device=seed_t.device))


def _fused_layer0(params, cfg, h_all, h_seed, seeds, seed_t, buf, edge_table,
                  mode, node_axis=None, buf_rows=None):
    """Layer-0 attention for ``seeds`` straight off the packed buffer: the
    node term from the (N, d_model) table, the time and edge terms folded
    in by the fused layer (the shard-aware one with ``node_axis``)."""
    att = fused_seed_neighbor_attention(
        params["attn_0"], h_all,
        torch.cat([h_seed, _time_zero(params, seed_t)], dim=-1),
        seeds, seed_t, buf, params["time"], d_edge=cfg.d_edge,
        edge_table=edge_table, num_heads=cfg.num_heads, mode=mode,
        node_axis=node_axis, buf_rows=buf_rows,
    )
    return mlp(params["merge_0"], torch.cat([att, h_seed], dim=-1))


def _embed_fused(params, cfg: TGATConfig, batch, static_feats, mode,
                 node_axis=None, buf_rows=None):
    """Every attention through the fused layer (device sampler).

    One layer is one fused call over the buffer. Two layers also embed the
    hop-1 frontier through layer 0 (padded slots, id -1, give zero rows;
    each frontier node queries the buffer at its own interaction time) and
    run the final hop over the seeds' own computed frontier rows
    (``fused_final_hop_attention``): three fused calls a forward. With
    ``node_axis``/``buf_rows`` both buffer reads (the seeds' and the hop-2
    frontier's) run shard-aware over this rank's block; the final hop reads
    no buffer and stays unsharded, as in the reference.
    """
    seeds, seed_t = batch["seed_nodes"], batch["seed_times"]
    buf = batch["nbr_buf"]
    edge_table = batch.get("edge_feat_table") if cfg.d_edge else None
    h_all = all_node_features(params["nodes"], static_feats)  # (N, d_model)
    h_seed = gather_rows(h_all, seeds.long())
    h1 = _fused_layer0(params, cfg, h_all, h_seed, seeds, seed_t, buf,
                       edge_table, mode, node_axis, buf_rows)
    if cfg.num_layers == 1:
        return h1

    nbr_ids, nbr_t = batch["nbr_ids"], batch["nbr_times"]
    f_nodes = nbr_ids.reshape(-1)
    f_t = nbr_t.reshape(-1)
    h_f = gather_rows(h_all, torch.clamp(f_nodes, min=0).long())
    h_f = torch.where((f_nodes >= 0)[:, None], h_f, 0.0)
    h_f1 = _fused_layer0(params, cfg, h_all, h_f, f_nodes, f_t, buf,
                         edge_table, mode, node_axis, buf_rows)
    att = fused_final_hop_attention(
        params["attn_1"], h_f1,
        torch.cat([h1, _time_zero(params, seed_t)], dim=-1),
        seed_t, nbr_t, batch["nbr_eids"], batch["nbr_mask"], params["time"],
        d_edge=cfg.d_edge, edge_table=edge_table, num_heads=cfg.num_heads,
        mode=mode,
    )
    return mlp(params["merge_1"], torch.cat([att, h1], dim=-1))


def embed(params, cfg: TGATConfig, batch, static_feats=None, fused=None,
          node_axis=None, buf_rows=None):
    """Embed all S seeds; two layers read the hop-2 tensors (``nbr2_*``).

    ``fused`` selects the path (``models.tg.common.fused_mode``):
    ``None``/"auto" fuses whenever the batch has ``nbr_buf``; ``False``
    forces the classic pre-gathered path; "ref"/"kernel" force the plain
    version or the kernel of the path the batch allows. ``node_axis`` (the
    node axis's process group) and ``buf_rows`` run the fused layer
    shard-aware, ``nbr_buf`` being this rank's block of a node-sharded
    buffer (``docs/sharding.md``).
    """
    mode = fused_mode(fused, batch)
    if mode is not None:
        return _embed_fused(params, cfg, batch, static_feats, mode,
                            node_axis, buf_rows)

    cmode = classic_mode(fused)
    seeds, seed_t = batch["seed_nodes"], batch["seed_times"]
    nbr_ids, nbr_t = batch["nbr_ids"], batch["nbr_times"]
    nbr_mask = batch["nbr_mask"]
    nbr_feats = batch.get("nbr_feats") if cfg.d_edge else None
    h_seed0 = node_features(params["nodes"], seeds, static_feats)
    h_nbr0 = node_features(params["nodes"], nbr_ids, static_feats)
    if cfg.num_layers == 1:
        return _layer(params, 0, cfg, h_seed0, seed_t, h_nbr0, nbr_t,
                      nbr_feats, nbr_mask, mode=cmode)

    # Layer 0 embeds the hop-1 frontier over its hop-2 neighborhoods.
    S, K = nbr_ids.shape
    h_f0 = node_features(params["nodes"], nbr_ids.reshape(-1), static_feats)
    h_f_nbr0 = node_features(params["nodes"], batch["nbr2_ids"], static_feats)
    f_feats = batch.get("nbr2_feats") if cfg.d_edge else None
    h_f1 = _layer(params, 0, cfg, h_f0, nbr_t.reshape(-1), h_f_nbr0,
                  batch["nbr2_times"], f_feats, batch["nbr2_mask"], mode=cmode)
    # The seeds through layer 0 over their own hop-1 block.
    h_seed1 = _layer(params, 0, cfg, h_seed0, seed_t, h_nbr0, nbr_t,
                     nbr_feats, nbr_mask, mode=cmode)
    # Layer 1: the seeds over their frontier's layer-0 embeddings.
    return _layer(params, 1, cfg, h_seed1, seed_t, h_f1.reshape(S, K, -1),
                  nbr_t, nbr_feats, nbr_mask, mode=cmode)


def link_scores(params, cfg: TGATConfig, batch, batch_size: int,
                static_feats=None, fused=None, node_axis=None, buf_rows=None):
    """(pos (B,), neg (B, Nn)) link logits for a batch."""
    h = embed(params, cfg, batch, static_feats, fused=fused,
              node_axis=node_axis, buf_rows=buf_rows)
    return link_logits(params["decoder"], h, batch_size)
