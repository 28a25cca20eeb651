"""The LM model of the port: parameter specs, the training forward and
loss, caches, prefill and decode for the dense, ssm and hybrid families —
the reference's ``models/lm/model.py``, in PyTorch.

Parameters keep the reference's stacked ``(L, ...)`` leaves; the
reference's ``lax.scan`` over layers is a Python loop that takes layer
``i``'s views (``scan_layers`` means nothing in eager PyTorch). Under
``cfg.remat`` each layer of the training forward goes through
``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
reference's ``jax.checkpoint``: the backward recomputes the layer. Caches
keep the reference's layout too (every leaf stacked over layers, ``idx``
and ``slot_pos`` int32): ``prefill`` fills a fresh cache and
``decode_step`` updates the cache it is given in place and returns it (the
reference returns a new pytree; in place saves a copy of every cache per
token).

The training forward and the prefill run the two TPU kernels on the card:
every attention through K5 and every SSD mixer through K6 when ``mode`` is
"auto" (the default) and the tensors are on CUDA; ``mode="ref"`` runs the
reference's plain algorithms. Attention trains on the card through K5 and
its gradient kernel K5b; K6 has no gradient kernel yet, so a gradient
through the SSD mixer on the card raises (the ssm and hybrid families train
on the CPU, or with ``mode="ref"``). The decode step is plain PyTorch, as
the reference's is jnp.

Entry points:
  param_specs(cfg)                       -> Spec tree
  init(cfg, generator, device)           -> params
  forward(params, cfg, tokens, ...)      -> (logits (B, S, V), aux)
  loss_fn(params, cfg, batch, ...)       -> scalar CE loss
  prefill(params, cfg, batch, ...)       -> (last logits, cache)
  prefill_layer(layer_p, cfg, x, c, pos) -> one layer's output (fills c)
  decode_step(params, cfg, cache, tok)   -> (logits, cache)
  init_cache(cfg, batch, max_len, ...)   -> cache

The MoE, audio and vlm families are not ported yet (ROADMAP A6): they raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import layers as L
from repro_torch.models.lm.params import Spec, materialize, spec_map

FAMILIES = ("dense", "ssm", "hybrid")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not ported yet "
            f"(ROADMAP A6); the port carries {', '.join(FAMILIES)}")


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
    """The token rows of the embedding in the compute dtype, gathered by
    ``F.embedding``: its CUDA backward sorts the ids and sums each id's run
    in parallel, where indexing's walks a row's duplicates one after
    another (a synthetic batch of 16,384 tokens names each of at most 64
    rows hundreds of times)."""
    return F.embedding(tokens.long(), params["embed"].to(L.cdtype(cfg)))


def _lm_head(params, cfg: ArchConfig, x):
    x = L.norm(cfg, params["final_norm"], x)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ w.to(x.dtype)


# ======================================================================
# Blocks and the training forward
# ======================================================================
def _decoder_block(p, cfg: ArchConfig, x, positions, *, kv_block=1024,
                   mode: str = "auto"):
    """One decoder layer of the training forward (the reference's per-family
    block): pre-norm attention (hybrid: attention and the SSD mixer side by
    side, their normed outputs averaged; ssm: the mixer alone), then the
    MLP."""
    fam = cfg.family
    if fam == "ssm":
        return x + L.ssd_block(p["ssd"], cfg, L.norm(cfg, p["norm"], x), mode=mode)
    h = L.norm(cfg, p["norm1"], x)
    a, _ = L.self_attention(p["attn"], cfg, h, positions,
                            window=cfg.sliding_window, kv_block=kv_block,
                            mode=mode)
    if fam == "hybrid":
        s = L.ssd_block(p["ssd"], cfg, h, mode=mode)
        x = x + 0.5 * (L.norm(cfg, p["attn_norm"], a) + L.norm(cfg, p["ssd_norm"], s))
    else:
        x = x + a
    return x + L.mlp_block(p["mlp"], cfg, L.norm(cfg, p["norm2"], x))


def _scan_blocks(blocks, cfg: ArchConfig, x, positions, *, kv_block=1024,
                 mode: str = "auto"):
    """The decoder stack over layer ``i``'s views of the stacked leaves ->
    (hidden, aux). Each layer's parameters are cast to the compute dtype
    when it differs from theirs; under ``cfg.remat`` the layer (cast
    included) is checkpointed. ``aux`` is the MoE balance loss, zero for
    the families the port carries."""
    def body(x, layer_p):
        if cfg.param_dtype != cfg.compute_dtype:
            layer_p = L.cast_tree(layer_p, x.dtype)
        return _decoder_block(layer_p, cfg, x, positions, kv_block=kv_block,
                              mode=mode)

    for i in range(cfg.num_layers):
        layer_p = _layer(blocks, i)
        if cfg.remat:
            x = checkpoint(body, x, layer_p, use_reentrant=False)
        else:
            x = body(x, layer_p)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _forward_hidden(params, cfg: ArchConfig, tokens, *, frontend=None,
                    kv_block=1024, mode: str = "auto"):
    """Causal forward up to (but excluding) the LM head -> (hidden, aux)."""
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(
            f"the {cfg.family} family's forward ({cfg.name}: its encoder or "
            f"cross-attention blocks) is not ported yet (ROADMAP A6)")
    _check_family(cfg)
    x = _embed_tokens(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    return _scan_blocks(params["blocks"], cfg, x, positions, kv_block=kv_block,
                        mode=mode)


def forward(params, cfg: ArchConfig, tokens, *, frontend=None, kv_block=1024,
            mode: str = "auto"):
    """Causal forward over full sequences -> (logits (B, S, V), aux).
    ``frontend`` (the audio and vlm families' stub embeddings) is taken for
    the reference's signature; those families raise."""
    x, aux = _forward_hidden(params, cfg, tokens, frontend=frontend,
                             kv_block=kv_block, mode=mode)
    return _lm_head(params, cfg, x), aux


def _ce_sum(params, cfg: ArchConfig, x, labels):
    """Cross-entropy sum from hidden states: the logits stay in the compute
    dtype and only the reductions run in float32 (no float32 (B, S, V)
    logits are kept)."""
    logits = _lm_head(params, cfg, x)
    m = logits.detach().amax(-1)
    z = torch.exp((logits - m[..., None]).float()).sum(-1)
    logz = m.float() + torch.log(z)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold.float()).sum()


def loss_fn(params, cfg: ArchConfig, batch, *, kv_block=1024,
            ce_chunks: int = 0, mode: str = "auto"):
    """Mean next-token cross-entropy over ``batch["tokens"]`` against
    ``batch["labels"]`` (+ 0.01 x the MoE aux loss, zero here).

    ``ce_chunks > 0`` (dividing S): the LM head and the cross-entropy run
    per sequence chunk, each chunk checkpointed, so only one (B, S /
    chunks, V) block of logits is live at a time, in the forward and in the
    backward; the chunks' sums are added in order, as the reference's scan
    does.
    """
    tokens, labels = batch["tokens"], batch["labels"]
    B, S = tokens.shape
    x, aux = _forward_hidden(params, cfg, tokens, frontend=batch.get("frontend"),
                             kv_block=kv_block, mode=mode)
    if ce_chunks and S % ce_chunks == 0:
        Sc = S // ce_chunks
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(ce_chunks):
            part = slice(c * Sc, (c + 1) * Sc)
            total = total + checkpoint(_ce_sum, params, cfg, x[:, part],
                                       labels[:, part], use_reentrant=False)
        return total / (B * S) + 0.01 * aux
    return _ce_sum(params, cfg, x, labels) / (B * S) + 0.01 * aux


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
