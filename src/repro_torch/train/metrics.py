"""Evaluation metrics: MRR (one-vs-many), AUC, NDCG@k.

``mrr`` runs in torch on the scores' device; ``auc`` and ``ndcg_at_k`` are
numpy on the host, bit-equal copies of the reference's (the node task reads
its probabilities back once per split and scores them there).
"""

from __future__ import annotations

import numpy as np
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


def auc(scores, labels) -> float:
    """Area under the ROC curve (rank statistic, ties handled)."""
    s = np.asarray(scores, dtype=np.float64)
    y = np.asarray(labels, dtype=np.int64)
    n_pos, n_neg = int(y.sum()), int((1 - y).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5
    # midrank of each tie group
    uniq, inv, cnt = np.unique(s, return_inverse=True, return_counts=True)
    cum = np.cumsum(cnt)
    mid = cum - (cnt - 1) / 2.0
    ranks = mid[inv]
    r_pos = ranks[y == 1].sum()
    return float((r_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def ndcg_at_k(pred, target, k: int = 10) -> float:
    """NDCG@k averaged over rows. pred/target: (B, M) relevance scores."""
    pred = np.asarray(pred, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    B, M = pred.shape
    k = min(k, M)
    top = np.argsort(-pred, axis=1)[:, :k]
    ideal = -np.sort(-target, axis=1)[:, :k]
    discounts = 1.0 / np.log2(np.arange(2, k + 2))
    dcg = (np.take_along_axis(target, top, axis=1) * discounts).sum(1)
    idcg = (ideal * discounts).sum(1)
    ok = idcg > 0
    out = np.zeros(B)
    out[ok] = dcg[ok] / idcg[ok]
    return float(out.mean())
