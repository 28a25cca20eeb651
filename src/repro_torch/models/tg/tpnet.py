"""TPNet (Lu et al., 2024): temporal walk matrices by random feature
propagation with time decay.

Twin of ``repro.models.tg.tpnet``. Each node u keeps L+1 random-feature
rows ``R_l[u]``; ``R_0`` is the fixed gaussian ``r0`` (a parameter, drawn by
the reference's ``init`` and brought in through ``convert.params_from_jax``)
and never changes. A batch of events updates layers 1..L in order, each
reading the layer below as this batch has already left it (``update_state``).
The link logit of (u, v) is an MLP over the signed-log (L+1)^2 matrix of
decayed inner products ``<R_i[u], R_j[v]>``.

State ``{"R": (L+1, N, d) float32, "last": (N,) int32}`` is threaded by the
pipeline as TGN's memory is: ``link_scores`` returns the new state computed
outside the autograd graph (the reference's auxiliary output), so only the
score MLP gets gradients (``r0`` reaches the scores through the state only).
TPNet samples no neighbors and runs no kernel: its segment sums and maxima
are torch scatters, as the reference's are ``jax.ops`` outside Pallas.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.nn.mlp import mlp, mlp_init


@dataclasses.dataclass(frozen=True)
class TPNetConfig:
    num_nodes: int
    d_rp: int = 32  # random-feature dimension (paper: log(2E))
    num_rp_layers: int = 2
    time_decay: float = 1e-6
    d_hidden: int = 64


def init(cfg: TPNetConfig, generator: torch.Generator, device="cpu"):
    """``r0`` ~ N(0, 1) / sqrt(d_rp) (N, d_rp) and the score MLP."""
    L = cfg.num_rp_layers
    r0 = torch.randn((cfg.num_nodes, cfg.d_rp), generator=generator,
                     dtype=torch.float32) / math.sqrt(cfg.d_rp)
    return {"r0": r0.to(device),
            "score": mlp_init(generator, [(L + 1) ** 2, cfg.d_hidden,
                                          cfg.d_hidden, 1], device=device)}


def init_state(params, cfg: TPNetConfig):
    """``R`` zeros with layer 0 set to ``r0``; every node last seen at 0."""
    r0 = params["r0"].detach()
    R = torch.zeros((cfg.num_rp_layers + 1, cfg.num_nodes, cfg.d_rp),
                    dtype=torch.float32, device=r0.device)
    R[0] = r0
    return {"R": R, "last": torch.zeros((cfg.num_nodes,), dtype=torch.int32,
                                        device=r0.device)}


def _decay(cfg, dt):
    return torch.exp(-cfg.time_decay * torch.clamp(dt.to(torch.float32),
                                                   min=0.0))


def scores_pairwise(params, cfg: TPNetConfig, state, u, v, t):
    """Link logits for node pairs at times t; u, v, t of one shape."""
    R, last = state["R"], state["last"]
    u, v = u.long(), v.long()
    t = t.to(torch.int32)  # the reference's dtypes: int32 times and last
    du = _decay(cfg, t - last[u])[..., None]
    dv = _decay(cfg, t - last[v])[..., None]
    Ru = R[:, u, :] * du  # (L+1, ..., d)
    Rv = R[:, v, :] * dv
    inner = torch.einsum("i...d,j...d->...ij", Ru, Rv)
    # Signed log compression keeps the walk-count features well-scaled.
    inner = torch.sign(inner) * torch.log1p(torch.abs(inner))
    feats = inner.reshape(*inner.shape[:-2], -1)
    return mlp(params["score"], feats, act=torch.relu)[..., 0]


def update_state(params, cfg: TPNetConfig, state, src, dst, t, mask=None):
    """One decay per node per batch and scatter-added contributions, in the
    reference's order: layer l reads layer l-1 as already updated by this
    batch. A node's decay is the largest decay over its valid events (the
    reference's ``segment_max``; its comment says "max dt", its code takes
    the max of the decay). A node no valid event touches keeps its rows:
    the reference's ``segment_max`` gives -inf there and never reads it;
    here the untouched entries keep 0 and are not read either. Padded
    events (``mask`` False) neither decay nor add; ``last`` takes the
    largest valid time per node."""
    R, last = state["R"], state["last"]
    src, dst = src.long(), dst.long()
    t = t.to(torch.int32)
    if mask is None:
        mask = torch.ones(src.shape, dtype=torch.bool, device=src.device)
    N = cfg.num_nodes
    nodes = torch.cat([src, dst])
    other = torch.cat([dst, src])
    tt = torch.cat([t, t])
    mm = torch.cat([mask, mask]).to(torch.float32)

    dec_event = _decay(cfg, tt - last[nodes])
    d_node = dec_event * mm  # (2B,)
    touched = torch.zeros(N, dtype=torch.float32,
                          device=mm.device).index_add_(0, nodes, mm) > 0
    dec = torch.zeros(N, dtype=torch.float32, device=mm.device).scatter_reduce_(
        0, nodes, torch.where(mm > 0, dec_event, 0.0), "amax",
        include_self=False)
    layers = [R[0]]
    for l in range(1, cfg.num_rp_layers + 1):
        contrib = layers[l - 1][other] * d_node[:, None] * mm[:, None]
        base = torch.where(touched[:, None], R[l] * dec[:, None], R[l])
        add = torch.zeros_like(R[l]).index_add_(0, nodes, contrib)
        layers.append(base + add)
    vals = torch.where(mm > 0, tt, 0).to(last.dtype)
    new_last = last.scatter_reduce(0, nodes, vals, "amax", include_self=True)
    return {"R": torch.stack(layers), "last": new_last}


def update_memory(params, cfg: TPNetConfig, state, batch):
    """``update_state`` over a batch's events and ``batch_mask`` (the
    pipeline's per-batch state update, named as TGN's is)."""
    return update_state(params, cfg, state, batch["src"], batch["dst"],
                        batch["time"], batch.get("batch_mask"))


def link_scores(params, cfg: TPNetConfig, state, batch, batch_size: int):
    """``((pos (B,), neg (B, Nn) or None), new_state)`` from the batch's raw
    events (no sampling needed). A negative equal to the positive's
    destination has the positive's inputs and takes its logit (the exact
    tie, ROADMAP C "MRR ties"); the new state carries no autograd graph."""
    src, dst, t = batch["src"], batch["dst"], batch["time"]
    pos = scores_pairwise(params, cfg, state, src, dst, t)
    neg = None
    if "neg" in batch:
        negs = batch["neg"]  # (B, Nn)
        neg = scores_pairwise(params, cfg, state, src[:, None].expand(negs.shape),
                              negs, t[:, None].expand(negs.shape))
        same = negs.long() == dst.long()[:, None]
        neg = torch.where(same, pos[:, None], neg)
    with torch.no_grad():
        new_state = update_memory(params, cfg, state, batch)
    return (pos, neg), new_state
