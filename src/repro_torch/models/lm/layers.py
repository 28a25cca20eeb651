"""LM building blocks of the port: GQA attention (flash-style blocked
softmax, sliding window, KV cache), SwiGLU/GELU MLPs and the Mamba2 SSD
mixer — the parts of the reference's ``models/lm/layers.py`` that the dense,
ssm and hybrid families use, in PyTorch.

Each block has ``<block>_specs(cfg)`` + ``<block>(params, cfg, ...)`` as in
the reference, with the same names and layouts. The reference's ``shard``
annotations are dropped (one card, no mesh). The two TPU kernels of the
prefill and the training forward are reached here: ``self_attention`` and
``ssd_mix`` take ``mode``, and on a CUDA tensor with ``mode="auto"`` (or
``"kernel"``) attention runs K5 (``kernels.flash_attention``, both of the
reference's routes, the window as K5's mask; differentiable, its gradient
the kernel K5b) and the SSD scan runs K6 (``kernels.ssd_chunk``;
differentiable, its gradient the kernel K6b); a CUDA tensor launches the
kernel or raises. A training step on the card thus runs, per layer, K5 and
K5b (dense), K6 and K6b (ssm), or both pairs (hybrid; under remat each
forward kernel twice). ``mode="ref"``, and any CPU tensor, runs the
reference's own algorithms in torch (``flash_attention``,
``swa_flash_attention``, chunked ``ssd_mix``), differentiated by autograd.
The decode step stays plain PyTorch, as the reference's is plain jnp:
decode attention over a cache with a fill level is not K5's contract.

The cached decode functions update the cache dict they are given in place
(the new key and value rows, ``slot_pos`` and ``idx``) and return it; the
reference returns a new pytree. In place saves a copy of every cache per
token and keeps the index on the device (no host sync).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import use_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.models.lm.params import Spec

NEG_INF = -2.0e38


def cdtype(cfg: ArchConfig) -> torch.dtype:
    """The config's compute dtype as a torch dtype."""
    return getattr(torch, cfg.compute_dtype)


def cast_tree(params, dtype):
    """Every leaf of a nested dict cast to ``dtype`` (no copy when it is
    already of that dtype)."""
    if isinstance(params, dict):
        return {k: cast_tree(v, dtype) for k, v in params.items()}
    return params.to(dtype)


# ======================================================================
# Norms
# ======================================================================
def rms_norm_spec(dim: int) -> Spec:
    """Spec of an RMSNorm scale (ones)."""
    return Spec((dim,), (None,), init="ones")


def rms_norm(scale, x, eps: float = 1e-6):
    """RMSNorm in float32, cast back to x's dtype."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * scale.float()).to(x.dtype)


def norm_specs(cfg: ArchConfig, dim: Optional[int] = None):
    """The family's norm: RMSNorm (LayerNorm, the audio family's, is not
    carried yet)."""
    if cfg.family == "audio":
        raise NotImplementedError("LayerNorm (the audio family) is not ported yet")
    return rms_norm_spec(dim or cfg.d_model)


def norm(cfg: ArchConfig, p, x):
    """Apply the family's norm."""
    if cfg.family == "audio":
        raise NotImplementedError("LayerNorm (the audio family) is not ported yet")
    return rms_norm(p, x, cfg.norm_eps)


# ======================================================================
# RoPE
# ======================================================================
def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D) with D even; positions: scalar, (S,) or (B, S)
    (ints or a tensor on x's device)."""
    B, S, H, D = x.shape
    half = D // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    freqs = torch.as_tensor(freqs, device=x.device)
    pos = torch.as_tensor(positions, device=x.device).float()
    pos = torch.atleast_1d(pos)
    if pos.dim() == 1:
        pos = pos[None, :]
    ang = pos[..., None] * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


# ======================================================================
# Flash-style blocked attention (plain; K5 is the card's path)
# ======================================================================
def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset=0, kv_len=None, kv_block: int = 1024):
    """Online-softmax attention, O(S * kv_block) memory.

    q: (B, Sq, H, D); k, v: (B, Skv, Hk, D) with H % Hk == 0.
    ``window`` > 0 enables sliding-window masking (kvpos > qpos - window).
    ``q_offset`` is the absolute position of q[0] (decode/prefill chunks).
    ``kv_len`` optionally masks positions >= kv_len (cache fill level).
    Returns (B, Sq, H, D).
    """
    B, Sq, H, D = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    scale = 1.0 / np.sqrt(D)
    dev = q.device

    pad = (-Skv) % kv_block
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nb = (Skv + pad) // kv_block

    qg = q.reshape(B, Sq, Hk, G, D).float() * scale
    qpos = q_offset + torch.arange(Sq, device=dev)
    limit = Skv if kv_len is None else kv_len

    m = torch.full((B, Sq, Hk, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, Hk, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, Hk, G, D), dtype=torch.float32, device=dev)
    for j in range(nb):
        kj = k[:, j * kv_block:(j + 1) * kv_block]
        vj = v[:, j * kv_block:(j + 1) * kv_block]
        s = torch.einsum("bqhgd,bthd->bqhgt", qg, kj.float())
        kvpos = j * kv_block + torch.arange(kv_block, device=dev)
        allow = torch.ones((Sq, kv_block), dtype=torch.bool, device=dev)
        if causal:
            allow &= kvpos[None, :] <= qpos[:, None]
        if window:
            allow &= kvpos[None, :] > qpos[:, None] - window
        allow &= kvpos[None, :] < limit
        s = torch.where(allow[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgt,bthd->bqhgd", p, vj.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def swa_flash_attention(q, k, v, *, window: int, kv_block: int = 1024):
    """Sliding-window attention with block skipping.

    For q block i (size = kv_block), only kv positions in
    [(i*B - window), (i+1)*B) can be visible, i.e. at most 2 kv blocks when
    window <= kv_block. We walk q blocks and slice exactly that kv span —
    attention work drops from O(Sq * Skv) to O(Sq * (B + window)).
    """
    B, Sq, H, D = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    scale = 1.0 / np.sqrt(D)
    assert window <= kv_block and Sq == Skv
    dev = q.device

    pad = (-Sq) % kv_block
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    Sp = Sq + pad
    nq = Sp // kv_block
    span = 2 * kv_block  # kv slice covering the window + the diagonal block

    outs = []
    for i in range(nq):
        qi = q[:, i * kv_block:(i + 1) * kv_block]
        # jax.lax.dynamic_slice clamps the start so the span fits
        start = min(max(i * kv_block - kv_block, 0), Sp - span) if Sp >= span else 0
        kj = k[:, start:start + span]
        vj = v[:, start:start + span]
        qg = qi.reshape(B, kv_block, Hk, G, D).float() * scale
        s = torch.einsum("bqhgd,bthd->bqhgt", qg, kj.float())
        qpos = i * kv_block + torch.arange(kv_block, device=dev)
        kvpos = start + torch.arange(kj.shape[1], device=dev)
        allow = ((kvpos[None, :] <= qpos[:, None])
                 & (kvpos[None, :] > qpos[:, None] - window)
                 & (kvpos[None, :] < Skv))
        s = torch.where(allow[None, :, None, None, :], s, NEG_INF)
        mx = s.amax(-1, keepdim=True)
        p = torch.exp(s - mx)
        o = torch.einsum("bqhgt,bthd->bqhgd", p, vj.float())
        o = o / torch.clamp(p.sum(-1)[..., None], min=1e-30)
        outs.append(o.reshape(B, kv_block, H, D).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :Sq]


def _attend_cache(qg, k_cache, v_cache, allow):
    """Softmax attention of grouped queries over a KV cache in the
    reference's ``preferred_element_type`` form. qg: (B, Hk, G, D); k_cache,
    v_cache: (B, T, Hk, D); allow: (T,) bool. The scores and the weighted
    sum accumulate in float32 from their operands' own dtype; the
    probabilities are cast to the cache's dtype before the weighted sum.
    Returns (B, Hk, G, D) float32.

    Both products are batched GEMMs over views of the cache, one per batch
    row with its kv heads as the batch (``k_cache[b].permute(1, 2, 0)`` is
    a strided (Hk, D, T) operand, no copy). On the card each GEMM reads the
    cache in its storage dtype with float32 output; the CPU has no
    mixed-dtype GEMM, so there the operands go through float32 copies (the
    same numbers: bf16 products are exact in float32).
    """
    if qg.is_cuda:
        def mm(a, b):
            return torch.bmm(a, b, out_dtype=torch.float32)
    else:
        def mm(a, b):
            return torch.bmm(a.float(), b.float())
    rows = range(qg.shape[0])
    s = torch.stack([mm(qg[b], k_cache[b].permute(1, 2, 0)) for b in rows])
    s = torch.where(allow[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    return torch.stack([mm(p[b], v_cache[b].transpose(0, 1)) for b in rows])


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     fast: bool = True):
    """Single-position attention over a cache. q: (B, 1, H, D);
    k/v_cache: (B, Smax, Hk, D); cache_len: current length (an int or a
    0-d tensor).

    ``fast=True`` follows the reference's mixed-precision form: q scaled in
    its own dtype, the cache's products accumulated in float32, the
    probabilities cast to the cache's dtype before the weighted sum
    (``_attend_cache``: on the card the cache is read in its storage dtype,
    never copied).
    """
    B, _, H, D = q.shape
    Smax, Hk = k_cache.shape[1], k_cache.shape[2]
    G = H // Hk
    scale = 1.0 / np.sqrt(D)
    pos = torch.arange(Smax, device=q.device)
    allow = pos < cache_len
    if window:
        allow &= pos > cache_len - 1 - window
    if fast:
        qg = q.reshape(B, Hk, G, D) * torch.tensor(scale, dtype=q.dtype)
        out = _attend_cache(qg, k_cache, v_cache, allow)
        return out.reshape(B, 1, H, D).to(q.dtype)
    qg = q.reshape(B, Hk, G, D).float() * scale
    s = torch.einsum("bhgd,bthd->bhgt", qg, k_cache.float())
    s = torch.where(allow[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", p, v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


# ======================================================================
# Attention block (self-attention w/ optional cache)
# ======================================================================
def attention_specs(cfg: ArchConfig, d_model: Optional[int] = None):
    """Specs of one attention block (wq, wk, wv, wo; biases; qk-norm)."""
    d = d_model or cfg.d_model
    H, Hk, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    s = {
        "wq": Spec((d, H, Dh), ("embed_fsdp", "heads", "head_dim"), "fan_in"),
        "wk": Spec((d, Hk, Dh), ("embed_fsdp", "kv_heads", "head_dim"), "fan_in"),
        "wv": Spec((d, Hk, Dh), ("embed_fsdp", "kv_heads", "head_dim"), "fan_in"),
        "wo": Spec((H, Dh, d), ("heads", "head_dim", "embed_fsdp"), "fan_in"),
    }
    if cfg.attn_bias:
        s["bq"] = Spec((H, Dh), ("heads", "head_dim"), "zeros")
        s["bk"] = Spec((Hk, Dh), ("kv_heads", "head_dim"), "zeros")
        s["bv"] = Spec((Hk, Dh), ("kv_heads", "head_dim"), "zeros")
        s["bo"] = Spec((d,), (None,), "zeros")
    if cfg.qk_norm:
        s["q_norm"] = Spec((Dh,), (None,), "ones")
        s["k_norm"] = Spec((Dh,), (None,), "ones")
    return s


def _qkv(p, cfg: ArchConfig, x, positions, rope: bool):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if cfg.attn_bias:
        q, k, v = q + p["bq"].to(dt), k + p["bk"].to(dt), v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(p, cfg: ArchConfig, o, dt):
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(dt))
    if cfg.attn_bias:
        out = out + p["bo"].to(dt)
    return out


def self_attention(p, cfg: ArchConfig, x, positions, *, causal=True,
                   rope=True, window=0, kv_block=1024, mode: str = "auto"):
    """Full-sequence self-attention (train / prefill). Returns (out, (k, v)).

    On a CUDA tensor with ``mode`` "auto" or "kernel" the attention is K5
    (either reference route: the window is K5's mask, and K5 skips the
    tiles it excludes), its gradient K5b; otherwise the reference's route:
    the block-skipping
    ``swa_flash_attention`` when the window fits a kv block and the sequence
    spans more than two, else ``flash_attention``."""
    q, k, v = _qkv(p, cfg, x, positions, rope)
    if use_kernel(mode, q):
        o = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                   layout="bshd", mode=mode)
    elif (causal and window and window <= kv_block
          and q.shape[1] == k.shape[1] and q.shape[1] > 2 * kv_block):
        o = swa_flash_attention(q, k, v, window=window, kv_block=kv_block)
    else:
        o = flash_attention(q, k, v, causal=causal, window=window,
                            kv_block=kv_block)
    return _out_proj(p, cfg, o, x.dtype), (k, v)


def cached_self_attention(p, cfg: ArchConfig, x, cache, *, window=0):
    """Single-token decode. x: (B, 1, d); cache: {k, v, idx}, updated in
    place (the new row at ``idx``, then ``idx + 1``) and returned."""
    idx = cache["idx"]
    q, k_new, v_new = _qkv(p, cfg, x, idx, rope=True)
    at = idx.reshape(1).long()
    cache["k"].index_copy_(1, at, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(1, at, v_new.to(cache["v"].dtype))
    o = decode_attention(q, cache["k"], cache["v"], idx + 1, window=window)
    cache["idx"].add_(1)
    return _out_proj(p, cfg, o, x.dtype), cache


def cached_swa_attention(p, cfg: ArchConfig, x, cache, window: int):
    """Single-token decode with a ring-buffer sliding-window cache of size W.

    cache: {"k","v": (B, W, Hk, D), "slot_pos": (W,), "idx": scalar},
    updated in place and returned. Keys are stored post-RoPE at absolute
    positions, so ring overwrites are safe.
    """
    idx = cache["idx"]
    W = cache["k"].shape[1]
    q, k_new, v_new = _qkv(p, cfg, x, idx, rope=True)
    slot = (idx % W).reshape(1).long()
    cache["k"].index_copy_(1, slot, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v_new.to(cache["v"].dtype))
    cache["slot_pos"].index_copy_(0, slot, idx.reshape(1).to(cache["slot_pos"].dtype))
    k_cache, v_cache, slot_pos = cache["k"], cache["v"], cache["slot_pos"]

    B, _, H, D = q.shape
    Hk = k_cache.shape[2]
    G = H // Hk
    scale = 1.0 / np.sqrt(D)
    qg = q.reshape(B, Hk, G, D) * torch.tensor(scale, dtype=q.dtype)
    allow = (slot_pos >= 0) & (slot_pos <= idx) & (slot_pos > idx - window)
    o = _attend_cache(qg, k_cache, v_cache, allow)
    o = o.reshape(B, 1, H, D).to(x.dtype)
    cache["idx"].add_(1)
    return _out_proj(p, cfg, o, x.dtype), cache


# ======================================================================
# MLP (SwiGLU / GELU)
# ======================================================================
def mlp_specs(cfg: ArchConfig, d_ff: Optional[int] = None):
    """Specs of the MLP: SwiGLU (wi, wg, wo) or GELU with biases."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "silu":
        return {
            "wi": Spec((d, f), ("embed_fsdp", "mlp"), "fan_in"),
            "wg": Spec((d, f), ("embed_fsdp", "mlp"), "fan_in"),
            "wo": Spec((f, d), ("mlp", "embed_fsdp"), "fan_in"),
        }
    return {
        "wi": Spec((d, f), ("embed_fsdp", "mlp"), "fan_in"),
        "bi": Spec((f,), ("mlp",), "zeros"),
        "wo": Spec((f, d), ("mlp", "embed_fsdp"), "fan_in"),
        "bo": Spec((d,), (None,), "zeros"),
    }


def mlp_block(p, cfg: ArchConfig, x):
    """SwiGLU (``silu``) or tanh-approximated GELU MLP (``jax.nn.gelu``'s
    default)."""
    dt = x.dtype
    if cfg.act == "silu":
        h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wi"].to(dt))
        return h @ p["wo"].to(dt)
    h = F.gelu(x @ p["wi"].to(dt) + p["bi"].to(dt), approximate="tanh")
    return h @ p["wo"].to(dt) + p["bo"].to(dt)


# ======================================================================
# Mamba2 SSD mixer (chunked state-space duality; Dao & Gu 2024)
# ======================================================================
def ssd_specs(cfg: ArchConfig):
    """Specs of the Mamba2 mixer."""
    d = cfg.d_model
    di = cfg.d_inner_ssm
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    conv_ch = di + 2 * G * N
    d_in_proj = 2 * di + 2 * G * N + H
    return {
        "in_proj": Spec((d, d_in_proj), ("embed_fsdp", "heads"), "fan_in"),
        "conv_w": Spec((cfg.conv_kernel, conv_ch), ("conv", "heads"), "fan_in"),
        "conv_b": Spec((conv_ch,), ("heads",), "zeros"),
        "a_log": Spec((H,), ("heads",), "ones"),
        "D": Spec((H,), ("heads",), "ones"),
        "dt_bias": Spec((H,), ("heads",), "zeros"),
        "norm": Spec((di,), (None,), "ones"),
        "out_proj": Spec((di, d), ("heads", "embed_fsdp"), "fan_in"),
    }


def _causal_conv(w, b, x):
    """Depthwise causal conv. x: (B, S, C); w: (K, C)."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    return out + b


def _segsum(a):
    """Log-decay matrix: L[..., i, j] = sum a[j+1..i] for i >= j else -inf.

    a: (..., Q). Returns (..., Q, Q).
    """
    Q = a.shape[-1]
    cs = torch.cumsum(a, -1)
    diff = cs[..., :, None] - cs[..., None, :]  # sum (j, i]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -math.inf)


def ssd_mix(cfg: ArchConfig, xh, dt, A, Bm, Cm, chunk: int = 256,
            init_state=None, return_state: bool = False, mode: str = "auto"):
    """Chunked SSD. xh: (B, S, H, P); dt: (B, S, H); A: (H,) (negative);
    Bm, Cm: (B, S, G, N). Returns (B, S, H, P) [, final_state (B, H, P, N)].

    On a CUDA tensor with ``mode`` "auto" or "kernel" the scan is K6, and
    ``chunk`` is the kernel's own (bfloat16: the same chunk-parallel
    algorithm in chunks of 128, its products on the tensor cores with
    float32 sums and float32 operands as two bfloat16 terms; float32: a
    sequential walk in chunks of 32 on the CUDA cores); where autograd needs
    its gradient, the backward kernel K6b gives it (``ssd_ops._SSDChunkFn``).
    Groups are broadcast in the kernels; no ``init_state``: the prefill and
    the training step start from zeros, and a CUDA call with one raises.
    Otherwise the reference's
    algorithm: matmul-heavy einsums in the INPUT dtype with float32 decay
    math, B/C broadcast to heads through a split (G, H/G) head axis, and the
    inter-chunk recurrence in float32.
    """
    if use_kernel(mode, xh):
        if init_state is not None:
            raise NotImplementedError("the SSD kernel starts from a zero state")
        y, final_state = ssd_ops.ssd_chunk_scan(xh, dt, A, Bm, Cm, mode=mode)
        if return_state:
            return y, final_state.to(xh.dtype)
        return y
    Bsz, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Hg = H // G
    ct = xh.dtype
    pad = (-S) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    Sp = S + pad
    nc = Sp // chunk

    xc = xh.reshape(Bsz, nc, chunk, G, Hg, P)
    dtc = dt.reshape(Bsz, nc, chunk, H).float()
    Bc = Bm.reshape(Bsz, nc, chunk, G, N)
    Cc = Cm.reshape(Bsz, nc, chunk, G, N)

    a = dtc * A  # (B, nc, Q, H) log-decay per step, f32
    a_hc = torch.movedim(a, -1, 2).reshape(Bsz, nc, G, Hg, Sp // nc)
    L = torch.exp(_segsum(a_hc)).to(ct)  # (B, nc, G, Hg, Q, Q)

    xdt = xc * dtc.reshape(Bsz, nc, chunk, G, Hg)[..., None].to(ct)

    # Intra-chunk (diagonal blocks): Y_d = (C B^T o L) (dt x)
    cb = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)  # (B,nc,G,Q,Q)
    y_diag = torch.einsum("bcgqk,bcghqk,bckghp->bcqghp", cb, L, xdt)

    # Chunk states: S_c = sum_j exp(cum_end - cum_j) * B_j (dt x)_j^T
    cum = torch.cumsum(a_hc, -1)  # (B,nc,G,Hg,Q) f32
    decay_to_end = torch.exp(cum[..., -1:] - cum).to(ct)
    states = torch.einsum("bcghq,bcqgn,bcqghp->bcghpn",
                          decay_to_end, Bc, xdt)  # (B,nc,G,Hg,P,N)

    # Inter-chunk recurrence over nc; the carried state stays f32.
    chunk_decay = torch.exp(cum[..., -1])  # (B, nc, G, Hg) f32
    if init_state is None:
        s = torch.zeros((Bsz, G, Hg, P, N), dtype=torch.float32, device=xh.device)
    else:
        s = init_state.reshape(Bsz, G, Hg, P, N).float()
    prev = []
    for c in range(nc):
        prev.append(s.to(ct))
        s = s * chunk_decay[:, c][..., None, None] + states[:, c].float()
    prev_states = torch.stack(prev, dim=1)  # (B,nc,G,Hg,P,N)

    # Off-diagonal contribution: Y_off = (C . S_prev) * exp(cum)
    state_decay = torch.exp(cum).to(ct)  # (B,nc,G,Hg,Q)
    y_off = torch.einsum("bcqgn,bcghpn,bcghq->bcqghp",
                         Cc, prev_states, state_decay)

    y = (y_diag + y_off).reshape(Bsz, Sp, H, P)[:, :S]
    if return_state:
        return y, s.reshape(Bsz, H, P, N).to(ct)
    return y


def _ssd_inputs(p, cfg: ArchConfig, x, zxbcdt):
    """Split the in-projection, run the causal conv and the activations:
    (z, xh (B, S, H, P), Bm, Cm (B, S, G, N), dt (B, S, H) f32, A (H,) f32,
    xbc before the conv)."""
    B, S, _ = x.shape
    di = cfg.d_inner_ssm
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    dt_ = x.dtype
    z, xbc_raw, dt_raw = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
    xbc = F.silu(_causal_conv(p["conv_w"].to(dt_), p["conv_b"].to(dt_), xbc_raw))
    xh, Bm, Cm = torch.split(xbc, [di, G * N, G * N], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())  # (B,S,H)
    A = -torch.exp(p["a_log"].float())  # (H,)
    return (z, xh.reshape(B, S, H, P), Bm.reshape(B, S, G, N),
            Cm.reshape(B, S, G, N), dt, A, xbc_raw)


def _ssd_out(p, cfg: ArchConfig, y, xh, z):
    B, S = y.shape[:2]
    dt_ = xh.dtype
    y = y + xh * p["D"].to(dt_)[None, None, :, None]
    y = y.reshape(B, S, cfg.d_inner_ssm)
    y = rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["out_proj"].to(dt_)


def ssd_block(p, cfg: ArchConfig, x, *, chunk: int = 256, mode: str = "auto"):
    """Full mamba2 mixer block (train/prefill). x: (B, S, d)."""
    zxbcdt = x @ p["in_proj"].to(x.dtype)  # (B,S, 2di+2GN+H)
    z, xh, Bm, Cm, dt, A, _ = _ssd_inputs(p, cfg, x, zxbcdt)
    y = ssd_mix(cfg, xh, dt, A, Bm, Cm, chunk=chunk, mode=mode)
    return _ssd_out(p, cfg, y, xh, z)


def ssd_decode(p, cfg: ArchConfig, x, state):
    """Single-token SSD step. x: (B, 1, d);
    state: {"conv": (B, K-1, conv_ch), "ssm": (B, H, P, N)}. Returns (out,
    new state); the state dict given is not modified."""
    B, _, d = x.shape
    di = cfg.d_inner_ssm
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    dt_ = x.dtype

    zxbcdt = x[:, 0] @ p["in_proj"].to(dt_)  # (B, ...)
    z, xbc, dt_raw = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)

    conv_buf = torch.cat([state["conv"], xbc[:, None, :]], 1)  # (B,K,C)
    w = p["conv_w"].to(dt_)
    xbc = F.silu(torch.einsum("bkc,kc->bc", conv_buf, w) + p["conv_b"].to(dt_))
    new_conv = conv_buf[:, 1:]

    xh, Bm, Cm = torch.split(xbc, [di, G * N, G * N], dim=-1)
    xh = xh.reshape(B, H, P).float()
    Bm = Bm.reshape(B, G, N).float()
    Cm = Cm.reshape(B, G, N).float()
    rep = H // G
    Bh = torch.repeat_interleave(Bm, rep, dim=1)  # (B,H,N)
    Ch = torch.repeat_interleave(Cm, rep, dim=1)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())  # (B,H)
    A = -torch.exp(p["a_log"].float())
    decay = torch.exp(dt * A)  # (B,H)

    ssm = state["ssm"].float()  # (B,H,P,N)
    ssm = ssm * decay[..., None, None] + torch.einsum("bh,bhn,bhp->bhpn", dt, Bh, xh)
    y = torch.einsum("bhpn,bhn->bhp", ssm, Ch) + xh * p["D"].float()[None, :, None]
    y = y.reshape(B, di).to(dt_)
    y = rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = (y @ p["out_proj"].to(dt_))[:, None, :]
    return out, {"conv": new_conv, "ssm": ssm.to(state["ssm"].dtype)}


def ssd_init_state(cfg: ArchConfig, batch: int, dtype, device=None):
    """Zero conv and SSM state of one mixer."""
    di = cfg.d_inner_ssm
    G, N = cfg.ssm_groups, cfg.ssm_state
    conv_ch = di + 2 * G * N
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, conv_ch), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, N),
                           dtype=dtype, device=device),
    }
