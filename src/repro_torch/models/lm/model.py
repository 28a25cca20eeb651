"""The LM model of the port: parameter specs, caches, prefill and decode for
the dense, ssm and hybrid families — the serving half of the reference's
``models/lm/model.py``, in PyTorch.

Parameters keep the reference's stacked ``(L, ...)`` leaves; the
reference's ``lax.scan`` over layers is a Python loop that takes layer
``i``'s views (``remat`` and ``scan_layers`` mean nothing in eager
PyTorch). Caches keep the reference's layout too (every leaf stacked over
layers, ``idx`` and ``slot_pos`` int32): ``prefill`` fills a fresh cache and
``decode_step`` updates the cache it is given in place and returns it (the
reference returns a new pytree; in place saves a copy of every cache per
token).

The prefill runs the two TPU kernels on the card: every attention through
K5 and every SSD mixer through K6 when ``mode`` is "auto" (the default) and
the tensors are on CUDA; ``mode="ref"`` runs the reference's plain
algorithms. The decode step is plain PyTorch, as the reference's is jnp.

Entry points:
  param_specs(cfg)                       -> Spec tree
  init(cfg, generator, device)           -> params
  prefill(params, cfg, batch, ...)       -> (last logits, cache)
  prefill_layer(layer_p, cfg, x, c, pos) -> one layer's output (fills c)
  decode_step(params, cfg, cache, tok)   -> (logits, cache)
  init_cache(cfg, batch, max_len, ...)   -> cache

The MoE, audio and vlm families, and the training path (``forward``,
``loss_fn``), are not ported yet: they raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import layers as L
from repro_torch.models.lm.params import Spec, materialize, spec_map

FAMILIES = ("dense", "ssm", "hybrid")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not ported yet; the "
            f"port carries {', '.join(FAMILIES)}")


# ======================================================================
# Param specs
# ======================================================================
def _stack(specs, n: int):
    """Prepend a stacked 'layers' axis to every Spec in a subtree."""
    return spec_map(lambda s: Spec((n,) + s.shape, ("layers",) + s.axes,
                                   s.init, s.scale), specs)


def _block_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """One decoder block's params, per family."""
    _check_family(cfg)
    fam = cfg.family
    if fam == "ssm":
        return {"norm": L.norm_specs(cfg), "ssd": L.ssd_specs(cfg)}
    s: Dict[str, Any] = {
        "norm1": L.norm_specs(cfg),
        "attn": L.attention_specs(cfg),
        "norm2": L.norm_specs(cfg),
    }
    s["mlp"] = L.mlp_specs(cfg)
    if fam == "hybrid":
        s["ssd"] = L.ssd_specs(cfg)
        s["attn_norm"] = L.norm_specs(cfg)
        s["ssd_norm"] = L.norm_specs(cfg)
    return s


def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """The model's Spec tree (the reference's layout and order)."""
    _check_family(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    specs: Dict[str, Any] = {
        "embed": Spec((V, d), ("vocab", "embed_fsdp"), "normal", 0.02),
        "final_norm": L.norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        specs["head"] = Spec((d, V), ("embed_fsdp", "vocab"), "fan_in")
    specs["blocks"] = _stack(_block_specs(cfg), cfg.num_layers)
    return specs


def init(cfg: ArchConfig, generator: torch.Generator, device=None):
    """Random parameters in ``cfg.param_dtype``, drawn from ``generator``
    (on ``device``; the generator's device by default)."""
    return materialize(param_specs(cfg), generator, getattr(torch, cfg.param_dtype),
                       device)


def _layer(tree, i: int):
    """Layer ``i``'s views of a tree of stacked leaves."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ======================================================================
# Embedding and head
# ======================================================================
def _embed_tokens(params, cfg: ArchConfig, tokens):
    emb = params["embed"]
    return emb.to(L.cdtype(cfg))[tokens.long()]


def _lm_head(params, cfg: ArchConfig, x):
    x = L.norm(cfg, params["final_norm"], x)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ w.to(x.dtype)


# ======================================================================
# KV / SSM caches
# ======================================================================
def _attn_cache_shapes(cfg: ArchConfig, batch: int, max_len: int):
    Hk, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
    W = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shapes = {
        "k": ((batch, W, Hk, Dh), ("batch", "cache_seq", "kv_heads", None)),
        "v": ((batch, W, Hk, Dh), ("batch", "cache_seq", "kv_heads", None)),
        "idx": ((), ()),
    }
    if cfg.sliding_window:
        shapes["slot_pos"] = ((W,), (None,))
    return shapes


def _ssm_cache_shapes(cfg: ArchConfig, batch: int):
    di = cfg.d_inner_ssm
    G, N = cfg.ssm_groups, cfg.ssm_state
    conv_ch = di + 2 * G * N
    return {
        "conv": ((batch, cfg.conv_kernel - 1, conv_ch), ("batch", None, "heads")),
        "ssm": ((batch, cfg.ssm_heads, cfg.ssm_head_dim, N),
                ("batch", "heads", None, "state")),
    }


def _layer_cache_shapes(cfg: ArchConfig, batch: int, max_len: int):
    fam = cfg.family
    out: Dict[str, Any] = {}
    if fam == "ssm":
        out["ssd"] = _ssm_cache_shapes(cfg, batch)
    elif fam == "hybrid":
        out["attn"] = _attn_cache_shapes(cfg, batch, max_len)
        out["ssd"] = _ssm_cache_shapes(cfg, batch)
    else:
        out["attn"] = _attn_cache_shapes(cfg, batch, max_len)
    return out


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """Empty caches, every leaf stacked over the layers: attention k/v
    zeros (window-sized ring under a sliding window), ``idx`` 0 and
    ``slot_pos`` -1 (int32), SSM conv and state zeros, in the compute
    dtype."""
    _check_family(cfg)
    nl = cfg.num_layers
    cdt = L.cdtype(cfg)

    def rec(node, name):
        if isinstance(node, tuple) and len(node) == 2 and isinstance(node[0], tuple):
            shape = (nl,) + node[0]
            if name == "slot_pos":
                return torch.full(shape, -1, dtype=torch.int32, device=device)
            if name == "idx":
                return torch.zeros(shape, dtype=torch.int32, device=device)
            return torch.zeros(shape, dtype=cdt, device=device)
        return {k: rec(v, k) for k, v in node.items()}

    return rec(_layer_cache_shapes(cfg, batch, max_len), "")


# ======================================================================
# Prefill + decode
# ======================================================================
def prefill(params, cfg: ArchConfig, batch, max_len: Optional[int] = None,
            *, kv_block=1024, mode: str = "auto"):
    """Run the full prompt, return (last-token logits (B, V), filled cache).

    For attention layers the cache is filled with the prefill K/V (the last
    W positions, ring-aligned, under a sliding window of W < S); for SSM
    layers with the final state of the mixer's scan and the conv's last
    K - 1 inputs. ``mode`` selects K5/K6 ("auto" on CUDA) or the plain
    algorithms ("ref").
    """
    _check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    max_len = max_len or S + 1
    x = _embed_tokens(params, cfg, tokens)
    positions = torch.arange(S, device=tokens.device)
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    for i in range(cfg.num_layers):
        x = prefill_layer(_layer(params["blocks"], i), cfg, x, _layer(cache, i),
                          positions, kv_block=kv_block, mode=mode)
    logits = _lm_head(params, cfg, x[:, -1:, :])
    return logits[:, 0], cache


def prefill_layer(layer_p, cfg: ArchConfig, x, layer_c, positions, *,
                  kv_block=1024, mode: str = "auto"):
    """One decoder layer of the prefill (the reference's per-family scan
    body): returns the layer's output and fills the layer's cache views
    ``layer_c`` in place. ``layer_p`` is the layer's parameters."""
    p = L.cast_tree(layer_p, L.cdtype(cfg))
    fam = cfg.family
    S = x.shape[1]

    def fill_attn(c, k, v):
        W = c["k"].shape[1]
        if cfg.sliding_window and W < S:
            # last W positions, ring-aligned so slot = pos % W
            pos = torch.arange(S - W, S, device=x.device)
            slot = pos % W
            c["k"].index_copy_(1, slot, k[:, S - W:].to(c["k"].dtype))
            c["v"].index_copy_(1, slot, v[:, S - W:].to(c["v"].dtype))
            c["slot_pos"].index_copy_(0, slot, pos.to(torch.int32))
        else:
            c["k"][:, :S] = k.to(c["k"].dtype)
            c["v"][:, :S] = v.to(c["v"].dtype)
            if cfg.sliding_window:
                c["slot_pos"][:S] = torch.arange(S, dtype=torch.int32, device=x.device)
        c["idx"].fill_(S)

    def fill_ssd(c, st):
        c["conv"].copy_(st["conv"])
        c["ssm"].copy_(st["ssm"])

    if fam == "ssm":
        y, st = _ssd_block_with_state(p["ssd"], cfg, L.norm(cfg, p["norm"], x), mode=mode)
        fill_ssd(layer_c["ssd"], st)
        return x + y
    h = L.norm(cfg, p["norm1"], x)
    a, (k, v) = L.self_attention(p["attn"], cfg, h, positions,
                                 window=cfg.sliding_window, kv_block=kv_block,
                                 mode=mode)
    if fam == "hybrid":
        s, st = _ssd_block_with_state(p["ssd"], cfg, h, mode=mode)
        x = x + 0.5 * (L.norm(cfg, p["attn_norm"], a) + L.norm(cfg, p["ssd_norm"], s))
        fill_ssd(layer_c["ssd"], st)
    else:
        x = x + a
    x = x + L.mlp_block(p["mlp"], cfg, L.norm(cfg, p["norm2"], x))
    fill_attn(layer_c["attn"], k, v)
    return x


def _ssd_block_with_state(p, cfg: ArchConfig, h, chunk: int = 256,
                          mode: str = "auto"):
    """ssd_block variant that also returns the final SSM + conv state."""
    zxbcdt = h @ p["in_proj"].to(h.dtype)
    z, xh, Bm, Cm, dt, A, xbc = L._ssd_inputs(p, cfg, h, zxbcdt)
    conv_tail = xbc[:, -(cfg.conv_kernel - 1):, :]
    y, state = L.ssd_mix(cfg, xh, dt, A, Bm, Cm, chunk=chunk,
                         return_state=True, mode=mode)
    out = L._ssd_out(p, cfg, y, xh, z)
    cdt = L.cdtype(cfg)
    return out, {"conv": conv_tail.to(cdt), "ssm": state.to(cdt)}


def decode_step(params, cfg: ArchConfig, cache, tokens):
    """One decode step. tokens: (B,) int. Returns (logits (B, V), cache),
    the cache updated in place."""
    _check_family(cfg)
    fam = cfg.family
    cdt = L.cdtype(cfg)
    x = _embed_tokens(params, cfg, tokens[:, None])

    def attn_step(p, x, c):
        if cfg.sliding_window:
            return L.cached_swa_attention(p["attn"], cfg, x, c, cfg.sliding_window)
        return L.cached_self_attention(p["attn"], cfg, x, c)

    def ssd_step(p, h, c):
        y, st = L.ssd_decode(p["ssd"], cfg, h, c)
        c["conv"].copy_(st["conv"])
        c["ssm"].copy_(st["ssm"])
        return y

    for i in range(cfg.num_layers):
        p = L.cast_tree(_layer(params["blocks"], i), cdt)
        c = _layer(cache, i)
        if fam == "ssm":
            x = x + ssd_step(p, L.norm(cfg, p["norm"], x), c["ssd"])
            continue
        h = L.norm(cfg, p["norm1"], x)
        a, _ = attn_step(p, h, c["attn"])
        if fam == "hybrid":
            s = ssd_step(p, h, c["ssd"])
            x = x + 0.5 * (L.norm(cfg, p["attn_norm"], a) + L.norm(cfg, p["ssd_norm"], s))
        else:
            x = x + a
        x = x + L.mlp_block(p["mlp"], cfg, L.norm(cfg, p["norm2"], x))

    logits = _lm_head(params, cfg, x)
    return logits[:, 0], cache
