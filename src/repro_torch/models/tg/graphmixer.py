"""GraphMixer (Cong et al., 2023): an MLP-Mixer over each seed's recent
neighbors.

Twin of ``repro.models.tg.graphmixer``. Per seed, the tokens are its K
sampled interactions, each ``[edge features || fixed time encoding of
dt]`` projected to ``d_model``; mixer layers alternate token mixing (an MLP
across the K axis) and channel mixing, each behind a layer norm and a
residual. The masked mean of the tokens, plus a node encoder (the seed's
own features and the mean of its neighbors'), feeds the link decoder.

The time encoding is the fixed log-spaced one (``w_0 = 1``, so theta is
dt itself: up to ~2.6e6 rad on wikipedia); its arrays still sit in the
parameter tree and train, as in the reference. GELU is JAX's default, the
tanh approximation. Everything here is plain PyTorch: the reference runs
no Pallas kernel in this model.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.tg.common import (
    link_decoder_init,
    link_logits,
    node_feature_init,
    node_features,
)
from repro_torch.nn.linear import dense, dense_init
from repro_torch.nn.mlp import gelu, mlp, mlp_init
from repro_torch.nn.norm import layer_norm, layer_norm_init
from repro_torch.nn.time_encode import time_encode, time_encode_init


@dataclasses.dataclass(frozen=True)
class GraphMixerConfig:
    num_nodes: int
    d_edge: int = 0
    d_static: int = 0
    d_model: int = 128
    d_time: int = 100
    num_layers: int = 2
    k: int = 20
    token_expansion: float = 0.5
    channel_expansion: float = 4.0


def init(cfg: GraphMixerConfig, generator: torch.Generator, device="cpu"):
    """Random parameters with the reference's distributions and layout
    (``tok_proj`` over ``[edge || time]``, per layer ``ln_tok``,
    ``mix_tok`` over the K axis, ``ln_ch`` and ``mix_ch``)."""
    g = generator
    d_tok = cfg.d_model
    params = {
        "nodes": node_feature_init(g, cfg.num_nodes, cfg.d_static,
                                   cfg.d_model, device),
        "time": time_encode_init(g, cfg.d_time, device=device,
                                 learnable=False),
        "tok_proj": dense_init(g, cfg.d_edge + cfg.d_time, d_tok,
                               device=device),
        "decoder": link_decoder_init(g, cfg.d_model, device=device),
    }
    dt_hidden = max(4, int(cfg.k * cfg.token_expansion))
    dc_hidden = int(d_tok * cfg.channel_expansion)
    for l in range(cfg.num_layers):
        params[f"ln_tok_{l}"] = layer_norm_init(d_tok, device)
        params[f"mix_tok_{l}"] = mlp_init(g, [cfg.k, dt_hidden, cfg.k],
                                          device=device)
        params[f"ln_ch_{l}"] = layer_norm_init(d_tok, device)
        params[f"mix_ch_{l}"] = mlp_init(g, [d_tok, dc_hidden, d_tok],
                                         device=device)
    return params


def embed(params, cfg: GraphMixerConfig, batch, static_feats=None):
    """Embed all S seeds of the batch: (S, d_model)."""
    seeds, seed_t = batch["seed_nodes"], batch["seed_times"]
    nbr_ids, nbr_t, nbr_mask = batch["nbr_ids"], batch["nbr_times"], batch["nbr_mask"]
    maskf = nbr_mask.to(torch.float32)[..., None]

    dt = (seed_t.to(torch.int32)[:, None] - nbr_t.to(torch.int32)).float()
    enc = time_encode(params["time"], dt)  # (S, K, d_time)
    if cfg.d_edge and "nbr_feats" in batch:
        tok_in = torch.cat([batch["nbr_feats"], enc], dim=-1)
    else:
        tok_in = enc
    tok = dense(params["tok_proj"], tok_in) * maskf  # (S, K, d)

    for l in range(cfg.num_layers):
        t_ln = layer_norm(params[f"ln_tok_{l}"], tok)
        mixed = mlp(params[f"mix_tok_{l}"], t_ln.transpose(-1, -2), act=gelu)
        tok = tok + mixed.transpose(-1, -2)
        c_ln = layer_norm(params[f"ln_ch_{l}"], tok)
        tok = tok + mlp(params[f"mix_ch_{l}"], c_ln, act=gelu)

    denom = torch.clamp(nbr_mask.sum(-1, keepdim=True).to(torch.float32),
                        min=1.0)
    pooled = (tok * maskf).sum(-2) / denom  # (S, d)

    # Node encoder: own features + mean of the neighbors' features.
    h_self = node_features(params["nodes"], seeds, static_feats)
    h_nbrs = node_features(params["nodes"], nbr_ids, static_feats)
    h_nbrs = (h_nbrs * maskf).sum(-2) / denom
    return pooled + h_self + h_nbrs


def link_scores(params, cfg: GraphMixerConfig, batch, batch_size: int,
                static_feats=None):
    """(pos (B,), neg (B, Nn)) link logits for a batch."""
    h = embed(params, cfg, batch, static_feats)
    return link_logits(params["decoder"], h, batch_size)
