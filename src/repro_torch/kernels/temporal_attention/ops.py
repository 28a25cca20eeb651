"""Public temporal attention ops with ``mode=`` dispatch.

``temporal_attention``       — masked seed -> K-neighbor attention over
                               pre-gathered (S, K, H, D) keys and values,
                               the classic path's core (kernel
                               ``temporal_attention``).
``fused_temporal_layer``     — the TGAT layer-0 compute over the packed
                               recency buffer, with the time and edge bias
                               folds (kernel ``fused_temporal_layer``).
``fused_temporal_layer_hop2`` — the layer over an (S, K) hop-1 frontier
                               (2-layer TGAT's layer 0 for the frontier).
``fused_temporal_layer_per_seed`` — each seed over its own K rows of an
                               (S * K, H, D) table (2-layer TGAT's final
                               hop), as a synthetic packed buffer.
``fused_recency_attention``  — the ids-only variant (no bias groups).
``fused_temporal_layer_sharded`` — the fused layer over one node shard's
                               block of a node-partitioned buffer, summed
                               over the node group (multi-rank meshes).

``mode``:
  * ``"auto"``   — the CUDA kernel for CUDA tensors, the plain PyTorch
                   version for CPU tensors;
  * ``"ref"``    — force the plain version (any device);
  * ``"kernel"`` — force the CUDA kernel; raises on CPU tensors.

There is no fallback: a CUDA tensor in ``"auto"`` launches the kernel or
raises. On the kernel path ``fused_temporal_layer`` is differentiable
through ``_FusedLayerFn``, the counterpart of the reference's custom VJP
(``repro.kernels.temporal_attention.ops._fused_layer_call``): its forward
launches the forward kernel and saves only the operands, its backward
launches the backward kernel, which recomputes the attention. On the CPU
plain autograd differentiates the plain version. ``temporal_attention``
is differentiable through ``_TemporalAttentionFn``: the reference's kernel
is forward only (its VJP is XLA's, of the jnp oracle); here the forward
launches K3 and the backward launches K3b, the backward kernel that
computes that gradient from the saved operands.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import all_reduce_flat
from repro_torch.kernels import use_kernel
from repro_torch.kernels.temporal_attention.kernel import (
    fused_recency_attention_kernel,
    fused_temporal_layer_bwd_kernel,
    fused_temporal_layer_kernel,
    temporal_attention_bwd_kernel,
    temporal_attention_kernel,
)
from repro_torch.kernels.temporal_attention.ref import (
    GRAD_NAMES,
    fused_recency_attention_ref,
    fused_temporal_layer_bwd_ref,
    fused_temporal_layer_ref,
    temporal_attention_ref,
)

# The two launches of ``_FusedLayerFn``. Module attributes so that the CPU
# tests can stand the plain versions in for them; nothing else rebinds them.
_FWD = fused_temporal_layer_kernel
_BWD = fused_temporal_layer_bwd_kernel
# The two launches of ``_TemporalAttentionFn``, test seams likewise.
_TA_FWD = temporal_attention_kernel
_TA_BWD = temporal_attention_bwd_kernel

# Names of ``_FusedLayerFn``'s positional arguments, in order. Its backward
# returns a gradient for those in ``GRAD_NAMES`` and None for the rest
# (seeds, seed times, buffer, edge storage).
_ARGS = ("q", "k_table", "v_table", "seeds", "seed_times", "buf", "time_w",
         "time_b", "wt_k", "wt_v", "edge_feats", "we_k", "we_v")


class _FusedLayerFn(torch.autograd.Function):
    """The fused layer with the backward kernel as its gradient.

    ``forward`` launches the forward kernel and saves only its operands;
    ``backward`` launches the backward kernel on the stream current inside
    ``backward`` (autograd runs it on the forward's stream) and reshapes each
    gradient to its operand's shape. No (S, K, ...) tensor is saved: the
    backward recomputes the attention from the operands.
    """

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        kw = dict(zip(_ARGS, args))
        return _FWD(**kw)

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        kw = dict(zip(_ARGS, args))
        grads = _BWD(g.contiguous(), **kw)
        return tuple(
            grads[name].reshape(x.shape).to(x.dtype)
            if name in GRAD_NAMES and x is not None else None
            for name, x in kw.items())


def fused_temporal_layer(q, k_table, v_table, seeds, seed_times, buf, *,
                         time_w=None, time_b=None, wt_k=None, wt_v=None,
                         edge_feats=None, we_k=None, we_v=None,
                         mode: str = "auto"):
    """Fused TGAT/TGN-style layer attention over the packed recency buffer.

    For each seed ``s`` with packed buffer row ``buf[seeds[s]]``:

      k[s, j] = k_table[id_j] + phi(t_s - t_j) @ wt_k
                + edge_feats[eid_j] @ we_k        (v analogously)
      out[s]  = softmax((q[s] * scale) . k[s]) @ v[s]   over valid slots

    Shapes as in ``ref.fused_temporal_layer_ref``; seeds, seed times and
    the buffer are narrowed to contiguous int32 here, as the reference
    casts them.
    """
    kw = dict(time_w=time_w, time_b=time_b, wt_k=wt_k, wt_v=wt_v,
              edge_feats=edge_feats, we_k=we_k, we_v=we_v)
    if not use_kernel(mode, q):
        return fused_temporal_layer_ref(q, k_table, v_table, seeds,
                                        seed_times, buf, **kw)
    seeds = seeds.to(torch.int32).contiguous()
    if seed_times is not None:
        seed_times = seed_times.to(torch.int32).contiguous()
    kw = {k: None if v is None else v.contiguous() for k, v in kw.items()}
    return _FusedLayerFn.apply(
        q.contiguous(), k_table.contiguous(), v_table.contiguous(), seeds,
        seed_times, buf.to(torch.int32).contiguous(),
        *(kw[name] for name in _ARGS[6:]))


class _FusedLayerShardedFn(torch.autograd.Function):
    """The fused layer on one node shard's block, summed over the node
    group: the reference's ``_fused_layer_sharded_call`` and its custom VJP.

    ``forward`` runs the layer locally (K1 on the kernel path, the plain
    version otherwise) for the seeds this rank owns (the rest are -1: exact
    zero rows) and ``all_reduce``s the output over ``group``: one owner's
    value plus exact zeros, so the sum is bit-equal to the one-device
    layer. ``backward`` applies the same local call's VJP (K2, or the plain
    backward) to the incoming cotangent, which the node-replicated
    downstream makes equal on every rank, and ``all_reduce``s the operand
    cotangents (``q``, the tables, the time and edge weights) in one call:
    every rank then holds the whole layer gradient, and nothing else of the
    gradient tree needs a collective over the node group. Seeds, times,
    the buffer and the edge table get no cotangent.
    """

    @staticmethod
    def forward(ctx, group, kernel, *args):
        ctx.save_for_backward(*args)
        ctx.group, ctx.kernel = group, kernel
        kw = dict(zip(_ARGS, args))
        out = (_FWD if kernel else fused_temporal_layer_ref)(**kw)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        kw = dict(zip(_ARGS, ctx.saved_tensors))
        bwd = _BWD if ctx.kernel else fused_temporal_layer_bwd_ref
        grads = bwd(g.contiguous(), **kw)
        names = [n for n in _ARGS if n in GRAD_NAMES and kw[n] is not None]
        summed = dict(zip(names, all_reduce_flat(
            [grads[n].to(torch.float32) for n in names], ctx.group)))
        return (None, None) + tuple(
            summed[name].reshape(x.shape).to(x.dtype) if name in summed
            else None for name, x in kw.items())


def fused_temporal_layer_sharded(q, k_table, v_table, seeds, seed_times, buf,
                                 *, group, rows_per_shard: int, time_w=None,
                                 time_b=None, wt_k=None, wt_v=None,
                                 edge_feats=None, we_k=None, we_v=None,
                                 mode: str = "auto"):
    """Shard-aware ``fused_temporal_layer`` over a node-partitioned buffer.

    Every rank of the node ``group`` calls it with the same (replicated)
    ``q``, tables, weights and *global* seed ids; ``buf`` is this rank's
    ``(rows_per_shard + 1, K, 3)`` block (``DeviceRecencySampler(mesh=)
    .packed_buffer``, its sink last), whose id and edge-id channels hold
    global ids, so the table gathers need no remap. The rank at coordinate
    ``s`` owns seeds ``[s * per, (s + 1) * per)``: it remaps them to its
    local rows and marks the rest -1 (the kernel family's zero path), runs
    the layer (K1 under ``"auto"`` on CUDA tensors, the plain version on
    the CPU or with ``"ref"``) and the output is summed over ``group``:
    bit-equal to the one-device layer at any shard count. Differentiable
    through ``_FusedLayerShardedFn`` (K2 on the kernel path). Returns
    (S, H, D) on every rank.
    """
    per = int(rows_per_shard)
    lo = dist.get_rank(group=group) * per
    seeds = seeds.to(torch.int32)
    owned = (seeds >= lo) & (seeds < lo + per)
    local = torch.where(owned, seeds - lo, -1).contiguous()
    if seed_times is not None:
        seed_times = seed_times.to(torch.int32).contiguous()
    kw = dict(time_w=time_w, time_b=time_b, wt_k=wt_k, wt_v=wt_v,
              edge_feats=edge_feats, we_k=we_k, we_v=we_v)
    kw = {k: None if v is None else v.contiguous() for k, v in kw.items()}
    return _FusedLayerShardedFn.apply(
        group, use_kernel(mode, q), q.contiguous(), k_table.contiguous(),
        v_table.contiguous(), local, seed_times,
        buf.to(torch.int32).contiguous(), *(kw[name] for name in _ARGS[6:]))


def fused_temporal_layer_hop2(q, k_table, v_table, frontier, frontier_times,
                              buf, **kw):
    """The fused layer over the (S, K) hop-1 frontier: each frontier node
    queries the buffer at its own interaction time (2-layer TGAT's layer 0
    for the frontier). ``frontier``/``frontier_times``: (S, K) ids (padding
    -1) and times; q: (S * K, H, D), row-major over the frontier. Returns
    (S * K, H, D), exact zero rows (and gradients) for padded slots. A
    frontier slot's time may precede the times in the buffer row it reads
    (negative deltas): the delta is taken in int32 as everywhere. Keyword
    arguments as in ``fused_temporal_layer``."""
    return fused_temporal_layer(
        q, k_table, v_table, frontier.reshape(-1).to(torch.int32),
        frontier_times.reshape(-1).to(torch.int32), buf, **kw)


def fused_temporal_layer_per_seed(q, k_rows, v_rows, seed_times, nbr_times,
                                  nbr_mask, *, nbr_eids=None, **kw):
    """Each seed attends over its own K rows of an (S * K, H, D) table
    (2-layer TGAT's final hop: keys and values from computed hop-1
    embeddings). q: (S, H, D); k_rows/v_rows: (S * K, H, D), row ``s*K + j``
    seed s's j-th neighbor; seed_times: (S,); nbr_times/nbr_mask (and
    ``nbr_eids`` for the edge group): (S, K). Built as a synthetic (S, K, 3)
    buffer (ids the row indices where valid, else -1) over the rows table,
    so the same kernel pair serves it; the table gradient lands on rows
    that exactly one seed reads. Returns (S, H, D)."""
    seeds, buf = per_seed_buffer(nbr_times, nbr_mask, nbr_eids)
    return fused_temporal_layer(q, k_rows, v_rows, seeds,
                                seed_times.to(torch.int32), buf, **kw)


def per_seed_buffer(nbr_times, nbr_mask, nbr_eids=None):
    """The per-seed form's ``(seeds, buf)``: seeds ``0 .. S-1`` over an
    (S, K, 3) int32 buffer whose row s names rows ``s*K .. s*K + K-1`` of
    the table where ``nbr_mask`` holds (else -1), with ``nbr_times`` and
    ``nbr_eids`` (-1 where masked or not given)."""
    S, K = nbr_mask.shape
    dev = nbr_mask.device
    rows = torch.arange(S * K, dtype=torch.int32, device=dev).reshape(S, K)
    ids = torch.where(nbr_mask, rows, -1)
    eids = (torch.full((S, K), -1, dtype=torch.int32, device=dev)
            if nbr_eids is None
            else torch.where(nbr_mask, nbr_eids.to(torch.int32), -1))
    buf = torch.stack([ids, nbr_times.to(torch.int32), eids], dim=-1)
    return torch.arange(S, dtype=torch.int32, device=dev), buf


def fused_recency_attention(q, k_table, v_table, seeds, buf_ids, *,
                            mode: str = "auto"):
    """q: (S, H, D); k_table, v_table: (N, H, D); seeds: (S,);
    buf_ids: (Nb, K) resident buffer id rows -> (S, H, D)."""
    if not use_kernel(mode, q):
        return fused_recency_attention_ref(q, k_table, v_table, seeds, buf_ids)
    return fused_recency_attention_kernel(
        q.contiguous(), k_table.contiguous(), v_table.contiguous(),
        seeds.to(torch.int32).contiguous(),
        buf_ids.to(torch.int32).contiguous())


class _TemporalAttentionFn(torch.autograd.Function):
    """K3 with K3b as its gradient.

    ``forward`` launches K3 and saves q, k, v and the mask; ``backward``
    launches K3b on them and the cotangent, which recomputes the scores,
    and returns its gradients for q, k and v (masked slots and rows with no
    valid slot get exact zeros, as the plain version's ``where``s give).
    """

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return _TA_FWD(q, k, v, mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        dq, dk, dv = _TA_BWD(g.contiguous(), q, k, v, mask)
        return dq, dk, dv, None


def temporal_attention(q, k, v, mask, *, mode: str = "auto"):
    """Masked seed -> K-neighbor attention over pre-gathered keys/values.

    q: (S, H, D); k, v: (S, K, H, D); mask: (S, K) bool -> (S, H, D) in q's
    dtype, zero rows where a seed has no valid neighbor (scale 1/sqrt(D)).
    Differentiable in q, k and v on every path.
    """
    if not use_kernel(mode, q):
        return temporal_attention_ref(q, k, v, mask)
    return _TemporalAttentionFn.apply(q.contiguous(), k.contiguous(),
                                      v.contiguous(),
                                      mask.to(torch.bool).contiguous())
