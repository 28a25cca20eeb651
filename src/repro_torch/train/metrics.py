"""Evaluation metrics: MRR (one-vs-many)."""

from __future__ import annotations

import torch


def mrr(pos_scores, neg_scores, mask=None) -> float:
    """Mean reciprocal rank of each positive against its negatives.

    pos_scores: (B,); neg_scores: (B, M); mask: (B,) valid rows.
    Optimistic-tie handling follows TGB: rank = 1 + #(neg > pos) +
    0.5 * #(neg == pos). Exact float ties count half, so logits that differ
    in their last bits (GPU vs CPU) can move a rank by 0.5: compare MRRs
    across devices with a tolerance.
    """
    pos = torch.as_tensor(pos_scores)
    neg = torch.as_tensor(neg_scores)
    greater = (neg > pos[:, None]).sum(-1)
    ties = (neg == pos[:, None]).sum(-1)
    rank = 1.0 + greater.float() + 0.5 * ties.float()
    rr = 1.0 / rank
    if mask is None:
        return float(rr.mean())
    m = torch.as_tensor(mask, device=rr.device).float()
    return float((rr * m).sum() / torch.clamp(m.sum(), min=1.0))
