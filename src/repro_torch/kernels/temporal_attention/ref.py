"""Plain PyTorch versions of the temporal attention kernels.

``temporal_attention_ref`` is the twin of
``repro.kernels.temporal_attention.ref.temporal_attention_ref``: masked
seed -> K-neighbor attention over pre-gathered keys and values;
``temporal_attention_bwd_ref`` is its gradient in the backward kernel's
formulas (what the tests and ``chip_smoke.py`` hold K3b against). The rest are
materializing twins of ``repro.kernels.temporal_attention.ref``: they build
every intermediate the CUDA kernel keeps in shared memory — the gathered
(S, K, H, D) node-level k/v rows, the Bochner time bias
``phi(t_seed - t_nbr) @ wt`` and the edge bias ``edge_feats[eid] @ we`` —
then run a masked softmax attention. ``ops.fused_temporal_layer`` takes
them for CPU tensors (the CPU tests), ``chip_smoke.py`` holds the kernels
against them on the card. ``fused_temporal_layer_bwd_ref`` is the plain
version of the backward kernel: autograd through the forward's plain
version, in the backward kernel's dict layout. Both are what the kernels
are held against on the card.

``fused_temporal_layer_factored_ref`` and
``fused_temporal_layer_bwd_factored_ref`` are the kernels' decomposition
step by step, in plain PyTorch: the bias groups factor per seed, so each
weight matrix is crossed once per seed (``U = W_k q``), the slot pass works
with a slot's features ``x_j = [phi_j ; e_j]`` only, the weighted feature
sums ``Z``/``A`` are projected back once per seed, and the weight gradients
reduce over S rows of those sums. Nothing on the main path calls them; the
CPU tests hold them against the JAX package.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def temporal_attention_ref(q, k, v, mask, *, scale: float | None = None):
    """Seed-to-neighborhood attention (the classic TGAT/TGN layer core).

    q: (S, H, D) seed queries; k, v: (S, K, H, D) per-seed neighbor keys and
    values; mask: (S, K) bool neighbor validity. Scores in float32, scaled by
    1/sqrt(D) unless ``scale`` is given. Returns (S, H, D) in q's dtype; a
    row with no valid neighbor is exactly zero.
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("shd,skhd->shk", q.float(), k.float()) * scale
    s = torch.where(mask[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None, None], p, 0.0)
    return torch.einsum("shk,skhd->shd", p, v.float()).to(q.dtype)


def temporal_attention_bwd_ref(g, q, k, v, mask, *, scale: float | None = None):
    """Gradients of ``temporal_attention_ref`` for the cotangent ``g`` (S, H,
    D), by the formulas the backward kernel (K3b) computes, in float32: p
    the masked softmax of (q . k) * scale, dp = g . v, delta = sum_j p dp,
    ds = p (dp - delta), dq = scale sum_j ds k, dk = scale ds q, dv = p g.
    Returns ``(dq, dk, dv)`` in q's dtype; masked slots and rows with no
    valid slot give exact zeros (p is exactly 0 there)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    s = torch.einsum("shd,skhd->shk", qf, kf) * scale
    s = torch.where(mask[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None, None], p, 0.0)
    dp = torch.einsum("shd,skhd->shk", gf, vf)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = scale * torch.einsum("shk,skhd->shd", ds, kf)
    dk = scale * torch.einsum("shk,shd->skhd", ds, qf)
    dv = torch.einsum("shk,shd->skhd", p, gf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


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


def _slot_features(seeds, seed_times, buf, time_w, time_b, edge_feats,
                   d_time, d_edge):
    """The kernels' view of a seed's slots: the packed rows, the valid-slot
    mask, the neighbor ids, and the slot features x = [phi ; e] (S, K, X)
    with theta and dt of the time rows (None without the time group)."""
    seeds = seeds.long()
    rows = buf[torch.clamp(seeds, min=0)]            # (S, K, 3)
    ids = rows[..., 0]
    mask = (ids >= 0) & (seeds >= 0)[:, None]
    S, K = ids.shape
    parts, theta, dt = [], None, None
    if d_time:
        # Delta in int32 first, then cast; theta rounded per operation.
        dt = (seed_times.to(torch.int32)[:, None] - rows[..., 1]).float()
        theta = dt[..., None] * time_w.reshape(-1) + time_b.reshape(-1)
        parts.append(torch.cos(theta))
    if d_edge:
        eids = rows[..., 2]
        e = edge_feats[torch.clamp(eids, min=0).long()].float()
        parts.append(e * (eids >= 0)[..., None])
    x = torch.cat(parts, -1) if parts else torch.zeros((S, K, 0), device=buf.device)
    return mask, torch.clamp(ids, min=0).long(), x, theta, dt


def _stacked(w_time, w_edge, like):
    """[w_time ; w_edge] as (X, H, D), H and D those of ``like`` (X = 0
    without either group)."""
    _, H, D = like.shape
    parts = [w.reshape(w.shape[0], H, D).float()
             for w in (w_time, w_edge) if w is not None]
    return torch.cat(parts, 0) if parts else like.new_zeros((0, H, D), dtype=torch.float32)


def _masked_softmax(s, mask):
    s = torch.where(mask[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.where(mask.any(-1)[:, None, None], p, 0.0)


def fused_temporal_layer_factored_ref(
    q, k_table, v_table, seeds, seed_times, buf, *,
    time_w=None, time_b=None, wt_k=None, wt_v=None,
    edge_feats=None, we_k=None, we_v=None, scale: float | None = None,
):
    """``fused_temporal_layer_ref`` in the kernel's factored form: U, the
    slot pass, Z and the back-projection. Arguments and result as there."""
    S, H, D = q.shape
    d_time = wt_k.shape[0] if wt_k is not None else 0
    d_edge = we_k.shape[0] if we_k is not None else 0
    mask, sid, x, _, _ = _slot_features(seeds, seed_times, buf, time_w,
                                        time_b, edge_feats, d_time, d_edge)
    wk, wv = _stacked(wt_k, we_k, q), _stacked(wt_v, we_v, q)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qs = q.float() * scale
    U = torch.einsum("ihd,shd->shi", wk, qs)              # once per seed
    s = (torch.einsum("shd,skhd->shk", qs, k_table[sid].float())
         + torch.einsum("shi,ski->shk", U, x))            # the slot pass
    p = _masked_softmax(s, mask)
    Z = torch.einsum("shk,ski->shi", p, x)
    out = (torch.einsum("shk,skhd->shd", p, v_table[sid].float())
           + torch.einsum("shi,ihd->shd", Z, wv))         # back-projection
    return out.to(q.dtype)


def fused_temporal_layer_bwd_factored_ref(
    g, q, k_table, v_table, seeds, seed_times, buf, *,
    time_w=None, time_b=None, wt_k=None, wt_v=None,
    edge_feats=None, we_k=None, we_v=None, scale: float | None = None,
):
    """The backward kernel's decomposition, in the dict layout of
    ``fused_temporal_layer_bwd_ref``: U_k, U_v; the slot pass (scores, dp,
    p, ds); A_k = sum_j ds_j x_j and A_v = sum_j p_j x_j; dq with its
    back-projection; dphi from U_k and U_v; the table rows; the weight
    gradients as sums over the S rows of A."""
    S, H, D = q.shape
    N = k_table.shape[0]
    d_time = wt_k.shape[0] if wt_k is not None else 0
    d_edge = we_k.shape[0] if we_k is not None else 0
    mask, sid, x, theta, dt = _slot_features(
        seeds, seed_times, buf, time_w, time_b, edge_feats, d_time, d_edge)
    wk, wv = _stacked(wt_k, we_k, q), _stacked(wt_v, we_v, q)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qs, g = q.float() * scale, g.float()
    kt, vt = k_table[sid].float(), v_table[sid].float()   # (S, K, H, D)
    Uk = torch.einsum("ihd,shd->shi", wk, qs)
    Uv = torch.einsum("ihd,shd->shi", wv, g)
    s = (torch.einsum("shd,skhd->shk", qs, kt)
         + torch.einsum("shi,ski->shk", Uk, x))
    dp = (torch.einsum("shd,skhd->shk", g, vt)
          + torch.einsum("shi,ski->shk", Uv, x))
    p = _masked_softmax(s, mask)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))        # zero where masked
    Ak = torch.einsum("shk,ski->shi", ds, x)
    Av = torch.einsum("shk,ski->shi", p, x)
    dq = scale * (torch.einsum("shk,skhd->shd", ds, kt)
                  + torch.einsum("shi,ihd->shd", Ak, wk))
    valid = mask.reshape(-1)
    flat = sid.reshape(-1)[valid]
    dk = q.new_zeros((N, H, D), dtype=torch.float32).index_add_(
        0, flat, torch.einsum("shk,shd->skhd", ds, qs).reshape(-1, H, D)[valid])
    dv = q.new_zeros((N, H, D), dtype=torch.float32).index_add_(
        0, flat, torch.einsum("shk,shd->skhd", p, g).reshape(-1, H, D)[valid])
    dWk = torch.einsum("shi,shd->ihd", Ak, qs).reshape(-1, H * D)
    dWv = torch.einsum("shi,shd->ihd", Av, g).reshape(-1, H * D)
    grads = {"q": dq.to(q.dtype), "k_table": dk, "v_table": dv}
    if d_time:
        dphi = (torch.einsum("shk,shi->ski", ds, Uk[..., :d_time])
                + torch.einsum("shk,shi->ski", p, Uv[..., :d_time]))
        dtheta = -torch.sin(theta) * dphi                 # (S, K, d_time)
        grads.update(time_w=(dtheta * dt[..., None]).sum((0, 1)).reshape(1, -1),
                     time_b=dtheta.sum((0, 1)).reshape(1, -1),
                     wt_k=dWk[:d_time], wt_v=dWv[:d_time])
    if d_edge:
        grads.update(we_k=dWk[d_time:], we_v=dWv[d_time:])
    return grads
