"""Plain PyTorch flash attention: the version the CPU runs and the card's
kernel (K5) is held against. A copy of the reference's oracle
(``repro.kernels.flash_attention.ref.flash_attention_ref``)."""

from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: float | None = None):
    """q: (B, H, Sq, D); k, v: (B, Hk, Skv, D). Returns (B, H, Sq, D).

    GQA: H % Hk == 0 (query-head groups share a kv head). Key t is visible
    from query i when t <= i + (Skv - Sq) (causal) and t > i + (Skv - Sq) -
    window (window > 0); masked scores are -1e30. Scores, softmax and the
    weighted sum are float32; the output has q's dtype.
    """
    B, H, Sq, D = q.shape
    Hk, Skv = k.shape[1], k.shape[2]
    G = H // Hk
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hk, G, Sq, D).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    allow = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        allow &= kpos[None, :] <= qpos[:, None] + (Skv - Sq)
    if window:
        allow &= kpos[None, :] > qpos[:, None] + (Skv - Sq) - window
    s = torch.where(allow, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)
