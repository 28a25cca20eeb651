"""DyGFormer (Yu et al., 2023): a transformer over both endpoints' first-hop
interaction sequences, with neighbor co-occurrence encoding.

Twin of ``repro.models.tg.dygformer``. For a candidate pair (u, v), each
endpoint's K sampled interactions become per-position features
``[node emb || edge feat || time enc || co-occurrence emb]``; ``patch_size``
consecutive positions fold into one token; a pre-norm transformer
(``nn.attention.mha``, plain PyTorch as the reference's einsums) runs over
the ``2 K / patch_size`` tokens, and each side's masked token mean gives
(h_u, h_v). The co-occurrence counts (how often a position's neighbor
appears in u's and in v's sequence) are integer counts from equality
matrices, so both packages count them alike; padding ids (-1) equal each
other and the masks keep them out.

The encoding is pair-dependent: a negative is its own pass over
``(u repeated, negative)``. A negative whose inputs equal the positive
destination's (the same node at the same time with the same sampled
neighborhood) takes the positive's logit, so it is the exact tie MRR
defines (ROADMAP C, "MRR ties"); the reference's two passes of different
shapes may round such a pair apart.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.tg.common import (
    link_decoder,
    link_decoder_init,
    node_feature_init,
    node_features,
)
from repro_torch.nn.attention import mha, mha_init
from repro_torch.nn.linear import dense, dense_init
from repro_torch.nn.mlp import gelu, mlp, mlp_init
from repro_torch.nn.norm import layer_norm, layer_norm_init
from repro_torch.nn.time_encode import time_encode, time_encode_init


@dataclasses.dataclass(frozen=True)
class DyGFormerConfig:
    num_nodes: int
    d_edge: int = 0
    d_static: int = 0
    d_model: int = 172
    d_time: int = 100
    d_cooc: int = 50
    num_heads: int = 2
    num_layers: int = 2
    k: int = 32
    patch_size: int = 1


def init(cfg: DyGFormerConfig, generator: torch.Generator, device="cpu"):
    """Random parameters with the reference's distributions and layout."""
    if cfg.k % cfg.patch_size:
        raise ValueError(f"DyGFormer needs k ({cfg.k}) divisible by "
                         f"patch_size ({cfg.patch_size})")
    g = generator
    d_feat = cfg.d_model + cfg.d_edge + cfg.d_time + cfg.d_cooc
    d_tok = d_feat * cfg.patch_size
    params = {
        "nodes": node_feature_init(g, cfg.num_nodes, cfg.d_static,
                                   cfg.d_model, device),
        "time": time_encode_init(g, cfg.d_time, device=device),
        "cooc": mlp_init(g, [2, cfg.d_cooc, cfg.d_cooc], device=device),
        "patch_proj": dense_init(g, d_tok, cfg.d_model, device=device),
        "out_ln": layer_norm_init(cfg.d_model, device),
        "decoder": link_decoder_init(g, cfg.d_model, device=device),
    }
    for l in range(cfg.num_layers):
        params[f"ln1_{l}"] = layer_norm_init(cfg.d_model, device)
        params[f"attn_{l}"] = mha_init(g, cfg.d_model, cfg.d_model,
                                       cfg.d_model, cfg.num_heads, device)
        params[f"ln2_{l}"] = layer_norm_init(cfg.d_model, device)
        params[f"mlp_{l}"] = mlp_init(
            g, [cfg.d_model, 4 * cfg.d_model, cfg.d_model], device=device)
    return params


def cooc_counts(a_ids, b_ids, a_mask, b_mask):
    """For each position of a: (its neighbor's count in a, in b), float32
    (P, K, 2); zero at masked positions of a."""
    eq_aa = (a_ids[:, :, None] == a_ids[:, None, :]) & a_mask[:, None, :]
    eq_ab = (a_ids[:, :, None] == b_ids[:, None, :]) & b_mask[:, None, :]
    am = a_mask.to(torch.float32)
    ca = eq_aa.sum(-1).to(torch.float32) * am
    cb = eq_ab.sum(-1).to(torch.float32) * am
    return torch.stack([ca, cb], dim=-1)


def _side_features(params, cfg, side, cooc):
    """One endpoint's patched tokens: (P, K / patch_size, d_model)."""
    ids, mask = side["ids"], side["mask"]
    h = node_features(params["nodes"], ids)  # (P, K, d_model)
    dt = (side["t_ref"].to(torch.int32)[:, None]
          - side["times"].to(torch.int32)).float()
    enc = time_encode(params["time"], dt)
    cooc_emb = mlp(params["cooc"], cooc, act=torch.relu)
    parts = [h, enc, cooc_emb]
    if cfg.d_edge:
        parts.insert(1, side["feats"])
    x = torch.cat(parts, dim=-1) * mask.to(torch.float32)[..., None]
    P, K, D = x.shape
    ps = cfg.patch_size
    return dense(params["patch_proj"], x.reshape(P, K // ps, ps * D))


def embed_pairs(params, cfg: DyGFormerConfig, u, v):
    """u, v: dicts of ``ids/times/mask`` (P, K), ``t_ref`` (P,) and, with
    edge features, ``feats`` (P, K, d_edge). Returns (h_u, h_v), (P,
    d_model) each."""
    K = u["ids"].shape[1]
    if K % cfg.patch_size:
        raise ValueError(f"DyGFormer needs K ({K}) divisible by patch_size "
                         f"({cfg.patch_size})")
    cu = cooc_counts(u["ids"], v["ids"], u["mask"], v["mask"])
    cv = cooc_counts(v["ids"], u["ids"], v["mask"], u["mask"])
    x = torch.cat([_side_features(params, cfg, u, cu),
                   _side_features(params, cfg, v, cv)], dim=1)  # (P, 2K/ps, d)

    P, ps = x.shape[0], cfg.patch_size
    tok_mask = torch.cat([u["mask"].reshape(P, -1, ps).any(-1),
                          v["mask"].reshape(P, -1, ps).any(-1)], dim=1)
    attn_mask = tok_mask[:, None, :] & tok_mask[:, :, None]

    for l in range(cfg.num_layers):
        h = layer_norm(params[f"ln1_{l}"], x)
        x = x + mha(params[f"attn_{l}"], h, h, attn_mask,
                    num_heads=cfg.num_heads)
        h = layer_norm(params[f"ln2_{l}"], x)
        x = x + mlp(params[f"mlp_{l}"], h, act=gelu)
    x = layer_norm(params["out_ln"], x)

    half = x.shape[1] // 2
    mu = tok_mask[:, :half, None].to(x.dtype)
    mv = tok_mask[:, half:, None].to(x.dtype)
    h_u = (x[:, :half] * mu).sum(1) / torch.clamp(mu.sum(1), min=1.0)
    h_v = (x[:, half:] * mv).sum(1) / torch.clamp(mv.sum(1), min=1.0)
    return h_u, h_v


def _gather_side(batch, sel, cfg):
    """The rows ``sel`` of the batch's seed-aligned tensors, as a side."""
    side = {"ids": batch["nbr_ids"][sel], "times": batch["nbr_times"][sel],
            "mask": batch["nbr_mask"][sel], "t_ref": batch["seed_times"][sel]}
    if cfg.d_edge and "nbr_feats" in batch:
        side["feats"] = batch["nbr_feats"][sel]
    return side


def _same_inputs(batch, a, b):
    """(len(a),) bool: seed rows a and b have identical model inputs (node,
    query time and every neighbor slot)."""
    same = ((batch["seed_nodes"][a] == batch["seed_nodes"][b])
            & (batch["seed_times"][a] == batch["seed_times"][b]))
    for name in ("nbr_ids", "nbr_times", "nbr_eids", "nbr_mask"):
        same = same & (batch[name][a] == batch[name][b]).all(-1)
    return same


def link_scores(params, cfg: DyGFormerConfig, batch, batch_size: int):
    """Pos logits (B,) and neg logits (B, Nn) with pair-dependent encoding.
    Seed layout ``[src (B) | dst (B) | neg (B*Nn)]``: negative j of positive
    i sits at ``2B + i*Nn + j``."""
    B = batch_size
    S = batch["seed_nodes"].shape[0]
    n_neg = (S - 2 * B) // B
    dev = batch["seed_nodes"].device

    idx_src = torch.arange(B, device=dev)
    idx_dst = torch.arange(B, 2 * B, device=dev)
    u = _gather_side(batch, idx_src, cfg)
    v = _gather_side(batch, idx_dst, cfg)
    h_u, h_v = embed_pairs(params, cfg, u, v)
    pos = link_decoder(params["decoder"], h_u, h_v)

    neg = None
    if n_neg > 0:
        idx_neg = torch.arange(2 * B, S, device=dev)
        u_rep = {k: val.repeat_interleave(n_neg, dim=0) for k, val in u.items()}
        w = _gather_side(batch, idx_neg, cfg)
        h_ur, h_w = embed_pairs(params, cfg, u_rep, w)
        neg = link_decoder(params["decoder"], h_ur, h_w).reshape(B, n_neg)
        same = _same_inputs(batch, idx_neg,
                            idx_dst.repeat_interleave(n_neg)).reshape(B, n_neg)
        neg = torch.where(same, pos[:, None], neg)
    return pos, neg
