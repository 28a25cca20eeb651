"""Plain PyTorch versions of the fused temporal attention kernels.

Materializing twins of ``repro.kernels.temporal_attention.ref``: they build
every intermediate the CUDA kernel keeps in shared memory — the gathered
(S, K, H, D) node-level k/v rows, the Bochner time bias
``phi(t_seed - t_nbr) @ wt`` and the edge bias ``edge_feats[eid] @ we`` —
then run a masked softmax attention. ``ops.fused_temporal_layer`` takes
them for CPU tensors (the CPU tests), ``chip_smoke.py`` holds the kernels
against them on the card. ``fused_temporal_layer_bwd_ref`` is the plain
version of the backward kernel: autograd through the forward's plain
version, in the backward kernel's dict layout.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def fused_temporal_layer_ref(
    q, k_table, v_table, seeds, seed_times, buf, *,
    time_w=None, time_b=None, wt_k=None, wt_v=None,
    edge_feats=None, we_k=None, we_v=None, scale: float | None = None,
):
    """Fused gather + bias fold + attention over the packed buffer.

    q: (S, H, D); k_table/v_table: (N, H, D); seeds/seed_times: (S,) int32
    (seeds < 0 give zero rows); buf: (Nb, K, 3) int32 packed rows
    (neighbor id, time, edge id; id -1 = empty slot, eid -1 = featureless).
    The time group (``time_w``, ``time_b``, ``wt_k``, ``wt_v``) and the edge
    group (``edge_feats``, ``we_k``, ``we_v``) are each optional. Returns
    (S, H, D); a row whose slots are all masked is exactly zero.
    """
    S, H, D = q.shape
    K = buf.shape[1]
    seeds = seeds.long()
    rows = buf[torch.clamp(seeds, min=0)]            # (S, K, 3)
    ids = rows[..., 0]
    mask = (ids >= 0) & (seeds >= 0)[:, None]
    sid = torch.clamp(ids, min=0).long()
    k = k_table[sid].reshape(S, K, H * D).float()
    v = v_table[sid].reshape(S, K, H * D).float()
    if wt_k is not None:
        # Delta in int32 first, then cast: never subtract times in float.
        dt = (seed_times.to(torch.int32)[:, None] - rows[..., 1]).float()
        phi = torch.cos(dt[..., None] * time_w.reshape(-1)
                        + time_b.reshape(-1))                 # (S, K, d_time)
        k = k + phi @ wt_k.reshape(wt_k.shape[0], H * D)
        v = v + phi @ wt_v.reshape(wt_v.shape[0], H * D)
    if we_k is not None:
        eids = rows[..., 2]
        e = edge_feats[torch.clamp(eids, min=0).long()].float()
        e = e * (eids >= 0)[..., None]                        # featureless
        k = k + e @ we_k.reshape(we_k.shape[0], H * D)
        v = v + e @ we_v.reshape(we_v.shape[0], H * D)
    k = k.reshape(S, K, H, D)
    v = v.reshape(S, K, H, D)

    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qs = q.float() * scale
    s = torch.einsum("shd,skhd->shk", qs, k)
    s = torch.where(mask[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None, None], p, 0.0)
    return torch.einsum("shk,skhd->shd", p, v).to(q.dtype)


# Differentiable operands of the fused layer, in the backward's dict order.
GRAD_NAMES = ("q", "k_table", "v_table", "time_w", "time_b", "wt_k", "wt_v",
              "we_k", "we_v")


def fused_temporal_layer_bwd_ref(
    g, q, k_table, v_table, seeds, seed_times, buf, *,
    time_w=None, time_b=None, wt_k=None, wt_v=None,
    edge_feats=None, we_k=None, we_v=None, scale: float | None = None,
):
    """Gradients of ``fused_temporal_layer_ref`` for the cotangent ``g``
    (S, H, D), by ``torch.autograd.grad``. Returns the backward kernel's
    dict of float32 gradients: ``q``, ``k_table``, ``v_table`` in their
    shapes, ``time_w``/``time_b`` as (1, d_time) and the projection slices
    as (d, H*D), for the groups that are present."""
    diff = dict(q=q, k_table=k_table, v_table=v_table, time_w=time_w,
                time_b=time_b, wt_k=wt_k, wt_v=wt_v, we_k=we_k, we_v=we_v)
    diff = {k: v.detach().float().requires_grad_(True)
            for k, v in diff.items() if v is not None}
    with torch.enable_grad():
        out = fused_temporal_layer_ref(
            seeds=seeds, seed_times=seed_times, buf=buf,
            edge_feats=edge_feats, scale=scale,
            **{k: diff.get(k) for k in GRAD_NAMES})
        grads = torch.autograd.grad(out, list(diff.values()), g.float(),
                                    allow_unused=True)
    out = {}
    for (name, x), dx in zip(diff.items(), grads):
        dx = torch.zeros_like(x) if dx is None else dx
        out[name] = dx.reshape(1, -1) if name in ("time_w", "time_b") else dx
    return out


def fused_recency_attention_ref(q, k_table, v_table, seeds, buf_ids, *,
                                scale: float | None = None):
    """Ids-only variant: attention over ``buf_ids[seeds]`` (-1 = empty
    slot) with no time or edge bias. Returns (S, H, D)."""
    nbr = buf_ids[seeds.long()]
    mask = nbr >= 0
    safe = torch.clamp(nbr, min=0).long()
    k = k_table[safe].float()
    v = v_table[safe].float()
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("shd,skhd->shk", q.float(), k) * scale
    s = torch.where(mask[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None, None], p, 0.0)
    return torch.einsum("shk,skhd->shd", p, v).to(q.dtype)
