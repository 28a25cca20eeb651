"""TGAT (da Xu et al., 2020): temporal graph attention.

Each layer computes a seed embedding by attending over the seed's temporal
neighborhood; keys/values are [neighbor embedding || edge features ||
Bochner time encoding of (t_seed - t_nbr)].

When the batch carries the device sampler's packed buffer (``nbr_buf``),
``embed`` computes the layer's attention with ``fused_temporal_layer`` —
node-level k/v tables plus in-kernel time/edge bias folds, the hand-written
CUDA kernel on the GPU — so the ``(S, K, H, Dh)`` neighbor tensors never
exist in device memory. Without the buffer (the host sampler), or with
``fused=False``, the classic pre-gathered path runs, its masked attention in
the CUDA kernel ``temporal_attention`` on the GPU. The port covers ``num_layers=1``; two layers need
the hop-2 and final-hop kernel variants (ROADMAP A, 2-layer TGAT).
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
from repro_torch.nn.time_encode import time_encode, time_encode_init


@dataclasses.dataclass(frozen=True)
class TGATConfig:
    num_nodes: int
    d_edge: int = 0
    d_static: int = 0
    d_model: int = 100
    d_time: int = 100
    num_heads: int = 2
    num_layers: int = 2  # only 1 is ported
    k: int = 20


def _require_one_layer(cfg: TGATConfig) -> None:
    if cfg.num_layers != 1:
        raise NotImplementedError(
            f"TGAT num_layers={cfg.num_layers}: the port carries 1-layer TGAT; "
            "2-layer TGAT waits for the hop-2 and final-hop fused variants "
            "(ROADMAP A, '2-layer TGAT')"
        )


def init(cfg: TGATConfig, generator: torch.Generator, device="cpu"):
    """Random parameters with the reference's distributions (glorot-normal
    dense weights, zero biases, N(0, 0.02) node embeddings, N(0, 0.1)
    time-encoding parameters), drawn from ``generator``."""
    _require_one_layer(cfg)
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
    dt_seed = time_encode(params["time"],
                          torch.zeros(seed_t.shape, dtype=torch.float32,
                                      device=seed_t.device))
    q = torch.cat([h_seed, dt_seed], dim=-1)
    dt = (seed_t.to(torch.int32)[:, None] - nbr_t.to(torch.int32)).float()
    enc = time_encode(params["time"], dt)
    kv = [h_nbr, enc] if nbr_feats is None else [h_nbr, nbr_feats, enc]
    kv = torch.cat(kv, dim=-1)
    att = seed_neighbor_attention(params[f"attn_{l}"], q, kv, nbr_mask,
                                  num_heads=cfg.num_heads, mode=mode)
    return mlp(params[f"merge_{l}"], torch.cat([att, h_seed], dim=-1))


def _embed_fused(params, cfg: TGATConfig, batch, static_feats, mode):
    """Layer-0 attention for every seed straight off the packed buffer."""
    seeds, seed_t = batch["seed_nodes"], batch["seed_times"]
    edge_table = batch.get("edge_feat_table") if cfg.d_edge else None
    h_all = all_node_features(params["nodes"], static_feats)  # (N, d_model)
    h_seed = h_all[seeds.long()]
    dt0 = time_encode(params["time"],
                      torch.zeros(seed_t.shape, dtype=torch.float32,
                                  device=seed_t.device))
    att = fused_seed_neighbor_attention(
        params["attn_0"], h_all, torch.cat([h_seed, dt0], dim=-1),
        seeds, seed_t, batch["nbr_buf"], params["time"], d_edge=cfg.d_edge,
        edge_table=edge_table, num_heads=cfg.num_heads, mode=mode,
    )
    return mlp(params["merge_0"], torch.cat([att, h_seed], dim=-1))


def embed(params, cfg: TGATConfig, batch, static_feats=None, fused=None):
    """Embed all S seeds.

    ``fused`` selects the path (``models.tg.common.fused_mode``):
    ``None``/"auto" fuses whenever the batch has ``nbr_buf``; ``False``
    forces the classic pre-gathered path; "ref"/"kernel" force the plain
    version or the kernel of the path the batch allows.
    """
    _require_one_layer(cfg)
    mode = fused_mode(fused, batch)
    if mode is not None:
        return _embed_fused(params, cfg, batch, static_feats, mode)

    seeds, seed_t = batch["seed_nodes"], batch["seed_times"]
    nbr_ids, nbr_t = batch["nbr_ids"], batch["nbr_times"]
    nbr_feats = batch.get("nbr_feats") if cfg.d_edge else None
    h_seed0 = node_features(params["nodes"], seeds, static_feats)
    h_nbr0 = node_features(params["nodes"], nbr_ids, static_feats)
    return _layer(params, 0, cfg, h_seed0, seed_t, h_nbr0, nbr_t, nbr_feats,
                  batch["nbr_mask"], mode=classic_mode(fused))


def link_scores(params, cfg: TGATConfig, batch, batch_size: int,
                static_feats=None, fused=None):
    """(pos (B,), neg (B, Nn)) link logits for a batch."""
    h = embed(params, cfg, batch, static_feats, fused=fused)
    return link_logits(params["decoder"], h, batch_size)
