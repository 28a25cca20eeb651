"""Plain PyTorch flash attention: the versions the CPU runs and the card's
kernels are held against. ``flash_attention_ref`` is a copy of the
reference's oracle (``repro.kernels.flash_attention.ref.flash_attention_ref``);
``flash_attention_lse_ref`` adds the row log-sum-exp that K5 writes for the
backward, and ``flash_attention_bwd_ref`` is the plain version of K5b, the
gradient that the reference leaves to autodiff."""

from __future__ import annotations

import math

import torch


def _allow(Sq, Skv, causal, window, device):
    """(Sq, Skv) bool: key t visible from query i (K5's mask)."""
    qpos = torch.arange(Sq, device=device)
    kpos = torch.arange(Skv, device=device)
    allow = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        allow &= kpos[None, :] <= qpos[:, None] + (Skv - Sq)
    if window:
        allow &= kpos[None, :] > qpos[:, None] + (Skv - Sq) - window
    return allow


def _scores(q, k, causal, window, scale):
    """Masked float32 scores (B, Hk, G, Sq, Skv), the mask and the scale."""
    B, H, Sq, D = q.shape
    Hk, Skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hk, H // Hk, Sq, D).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    allow = _allow(Sq, Skv, causal, window, q.device)
    return torch.where(allow, s, -1e30), allow, scale


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: float | None = None):
    """q: (B, H, Sq, D); k, v: (B, Hk, Skv, D). Returns (B, H, Sq, D).

    GQA: H % Hk == 0 (query-head groups share a kv head). Key t is visible
    from query i when t <= i + (Skv - Sq) (causal) and t > i + (Skv - Sq) -
    window (window > 0); masked scores are -1e30. Scores, softmax and the
    weighted sum are float32; the output has q's dtype.
    """
    B, H, Sq, D = q.shape
    s, _, _ = _scores(q, k, causal, window, scale)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)


def flash_attention_lse_ref(q, k, v, *, causal: bool = True, window: int = 0,
                            scale: float | None = None):
    """``flash_attention_ref`` and the float32 log-sum-exp of each row's
    visible scaled scores, (B, H, Sq): what K5 returns when asked for it."""
    B, H, Sq, D = q.shape
    s, _, _ = _scores(q, k, causal, window, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype), lse.reshape(B, H, Sq)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int = 0, scale: float | None = None,
                            layout: str = "bhsd"):
    """The gradient of flash attention from the forward's output and row
    log-sum-exp (K5b's plain version), in float32:

        P = exp(S scale - lse) on visible pairs, 0 on masked ones
        D = rowsum(dO * O);  dV = P^T dO;  dP = dO V^T;  dS = P (dP - D)
        dQ = scale dS K;     dK = scale dS^T Q

    dk and dv are summed over the G query heads of each kv head. q, o, do:
    (B, H, Sq, D) and k, v: (B, Hk, Skv, D) with ``layout="bhsd"``, or the
    model's (B, S, H, D) tensors with ``"bshd"``; lse (B, H, Sq) float32.
    Returns (dq, dk, dv) in the layout and dtypes of q, k and v.
    """
    if layout == "bshd":
        dq, dk, dv = flash_attention_bwd_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            o.transpose(1, 2), lse, do.transpose(1, 2), causal=causal,
            window=window, scale=scale)
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)
    B, H, Sq, D = q.shape
    Hk = k.shape[1]
    G = H // Hk
    s, allow, scale = _scores(q, k, causal, window, scale)
    p = torch.where(allow, torch.exp(s - lse.reshape(B, Hk, G, Sq, 1).float()), 0.0)
    dog = do.reshape(B, Hk, G, Sq, D).float()
    delta = (dog * o.reshape(B, Hk, G, Sq, D).float()).sum(-1, keepdim=True)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, v.float())
    ds = p * (dp - delta)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds,
                      q.reshape(B, Hk, G, Sq, D).float()) * scale
    return (dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
