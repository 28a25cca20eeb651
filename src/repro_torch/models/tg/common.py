"""Shared pieces for the TG model zoo: link decoders, seed bookkeeping.

Batch tensor convention (from the neighbor hook), with B = padded batch
size and Nn = negatives per positive:

  seed_nodes : (S,) = [src (B) | dst (B) | neg (B*Nn)]
  nbr_*      : (S, K) neighbor blocks aligned with seed_nodes
  batch_mask : (B,) valid-event mask

Models embed all S seeds and ``split_seeds`` recovers (h_src, h_dst, h_neg).
``bce_link_loss`` is the training objective over the link logits.
"""

from __future__ import annotations

import torch

from repro_torch.nn.init import normal
from repro_torch.nn.linear import dense, dense_init
from repro_torch.nn.mlp import mlp, mlp_init


def split_seeds(h, batch_size: int):
    """h: (S, d) -> (h_src (B,d), h_dst (B,d), h_neg (B,Nn,d) or None)."""
    B = batch_size
    h_src, h_dst = h[:B], h[B: 2 * B]
    rest = h[2 * B:]
    if rest.shape[0] == 0:
        return h_src, h_dst, None
    nn_ = rest.shape[0] // B
    return h_src, h_dst, rest.reshape(B, nn_, -1)


def link_decoder_init(gen, d_model: int, hidden: int = 0, device="cpu"):
    """Init the 2-layer MLP link decoder over [h_u ; h_v]."""
    hidden = hidden or d_model
    return {"mlp": mlp_init(gen, [2 * d_model, hidden, 1], device=device)}


def link_decoder(params, h_u, h_v):
    """Pairwise link logit. Broadcasts h_u against extra leading dims of h_v."""
    if h_v.dim() == h_u.dim() + 1:
        h_u = h_u[:, None, :].expand(h_v.shape)
    x = torch.cat([h_u, h_v], dim=-1)
    return mlp(params["mlp"], x)[..., 0]


def link_logits(params, h, batch_size: int):
    """Standard positive/negative logits from stacked seed embeddings.

    A negative whose embedding equals the positive destination's bit for
    bit (the same node drawn as a negative) takes the positive's logit, so
    it counts as the exact tie MRR defines. Matrix products are not
    row-invariant on either device (a row's rounding depends on its tile),
    and the reference's two decoder passes may round such a pair apart.
    """
    h_src, h_dst, h_neg = split_seeds(h, batch_size)
    pos = link_decoder(params, h_src, h_dst)  # (B,)
    if h_neg is None:
        return pos, None
    neg = link_decoder(params, h_src, h_neg)  # (B, Nn)
    same = (h_neg == h_dst[:, None]).all(-1)
    return pos, torch.where(same, pos[:, None], neg)


def bce_link_loss_parts(pos_logits, neg_logits, batch_mask):
    """Masked BCE numerator and denominator before normalization.

    Returns ``(loss_sum, denom)``: the negative log-likelihood summed over
    the valid positives and their negatives, and the count of those terms
    (the reference keeps the parts apart for data-sharded training). A tied
    negative carries the positive's logit (``link_logits``), so its term's
    gradient reaches the decoder through the positive pass: the same
    gradient as the reference's, which decodes the identical pair twice.
    """
    m = batch_mask.to(torch.float32)
    loss = -(torch.nn.functional.logsigmoid(pos_logits) * m).sum()
    denom = m.sum()
    if neg_logits is not None:
        neg_ls = torch.nn.functional.logsigmoid(-neg_logits)
        loss = loss - (neg_ls * m[:, None]).sum()
        denom = denom + (m[:, None] * torch.ones_like(neg_logits)).sum()
    return loss, denom


def bce_link_loss(pos_logits, neg_logits, batch_mask):
    """Masked binary cross-entropy over positives and negatives, normalized
    by the number of terms (at least 1)."""
    loss, denom = bce_link_loss_parts(pos_logits, neg_logits, batch_mask)
    return loss / torch.clamp(denom, min=1.0)


def node_feature_init(gen, num_nodes: int, d_static: int, d_model: int,
                      device="cpu"):
    """Learnable node embedding + optional static-feature projection."""
    p = {"emb": normal(gen, (num_nodes, d_model), 0.02, device)}
    if d_static:
        p["static_proj"] = dense_init(gen, d_static, d_model, device=device)
    return p


def node_features(params, ids, static_feats=None):
    """Gather per-id node features (learned embedding + optional static
    projection); rows with id < 0 (padding) are zeroed."""
    safe = torch.clamp(ids, min=0).long()
    h = params["emb"][safe]
    if static_feats is not None and "static_proj" in params:
        h = h + dense(params["static_proj"], static_feats[safe])
    return torch.where((ids >= 0)[..., None], h, 0.0)


def all_node_features(params, static_feats=None):
    """Every node's feature row at once: (N, d_model) — the node-level
    table the fused attention gathers from."""
    h = params["emb"]
    if static_feats is not None and "static_proj" in params:
        h = h + dense(params["static_proj"], static_feats)
    return h


def fused_mode(fused, batch):
    """Resolve a model's ``fused`` argument against the batch contents.

    Returns ``None`` (the classic pre-gathered path) or a
    ``fused_temporal_layer`` mode string. ``fused=None``/``"auto"`` takes
    the fused path whenever the batch carries the packed buffer
    (``nbr_buf``): the CUDA kernel for CUDA tensors, its plain version on
    the CPU. ``False`` forces the classic path (the numerical oracle);
    ``True``/``"kernel"``/``"ref"`` force the fused path and need ``nbr_buf``.
    """
    if fused is False:
        return None
    if fused is None or fused == "auto":
        return "auto" if "nbr_buf" in batch else None
    if "nbr_buf" not in batch:
        raise ValueError(
            "fused temporal attention requires the resident packed buffer "
            "(batch has no 'nbr_buf'): build RECIPE_TGB_LINK with "
            "SamplerSpec(device=True) and expose_buffer left on"
        )
    return "auto" if fused is True else fused
