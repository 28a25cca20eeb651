"""Synthetic temporal-graph generators, statistically matched to the paper's
datasets (Table 13).

The container is offline, so TGB's Wikipedia/Reddit/LastFM/Trade/Genre are
replaced with deterministic generators that match, at configurable scale:

  * bipartite structure (users x items) where applicable,
  * power-law (Zipf) degree distributions on both sides,
  * bursty inter-arrival times (log-normal gaps),
  * duplicate-edge "surprise" rates via per-user preference concentration,
  * per-edge feature dimension (Wikipedia/Reddit: 172-dim LIWC-like),
  * node-event streams (user activity features) to exercise node events.

All generators are seeded and pure (same spec -> same graph).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.graph import DGData


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    name: str
    num_src: int  # users
    num_dst: int  # items/pages (0 => unipartite)
    num_edges: int
    duration_ticks: int  # native-granularity span
    granularity: str = "s"
    edge_feat_dim: int = 0
    node_feat_dim: int = 0
    node_event_rate: float = 0.0  # node events per edge event
    zipf_src: float = 1.3
    zipf_dst: float = 1.5
    repeat_bias: float = 0.7  # prob. of re-drawing from a user's past items
    seed: int = 0


# Scaled-down analogues of Table 13 (full-size is a flag flip; defaults keep
# CPU benchmarks snappy while preserving the distributions).
DATASET_SPECS = {
    "wikipedia": SyntheticSpec(
        "wikipedia", num_src=6000, num_dst=3000, num_edges=157_474,
        duration_ticks=30 * 86400, edge_feat_dim=172, repeat_bias=0.89,
    ),
    "reddit": SyntheticSpec(
        "reddit", num_src=9000, num_dst=2000, num_edges=672_447,
        duration_ticks=30 * 86400, edge_feat_dim=172, repeat_bias=0.93,
    ),
    "lastfm": SyntheticSpec(
        "lastfm", num_src=980, num_dst=1000, num_edges=1_293_103,
        duration_ticks=30 * 86400, edge_feat_dim=0, repeat_bias=0.65,
    ),
    "trade": SyntheticSpec(
        "trade", num_src=255, num_dst=0, num_edges=468_245,
        duration_ticks=32, granularity="y", edge_feat_dim=1, repeat_bias=0.97,
    ),
    "genre": SyntheticSpec(
        "genre", num_src=1400, num_dst=105, num_edges=1_785_839,
        duration_ticks=30 * 86400, edge_feat_dim=1, repeat_bias=0.95,
    ),
    # Tiny spec for unit tests.
    "tiny": SyntheticSpec(
        "tiny", num_src=50, num_dst=30, num_edges=2000,
        duration_ticks=86400, edge_feat_dim=8, node_feat_dim=4,
        node_event_rate=0.1,
    ),
}


def _zipf_probs(n: int, alpha: float) -> np.ndarray:
    p = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), alpha)
    return p / p.sum()


def generate(spec: SyntheticSpec | str, scale: float = 1.0,
             seed: Optional[int] = None) -> DGData:
    """Generate a synthetic temporal graph from a spec (or named spec)."""
    if isinstance(spec, str):
        spec = DATASET_SPECS[spec]
    if scale != 1.0:
        spec = dataclasses.replace(
            spec,
            num_edges=max(64, int(spec.num_edges * scale)),
            num_src=max(8, int(spec.num_src * min(1.0, scale * 2))),
            num_dst=max(4, int(spec.num_dst * min(1.0, scale * 2))) if spec.num_dst else 0,
        )
    rng = np.random.default_rng(spec.seed if seed is None else seed)
    E = spec.num_edges
    bipartite = spec.num_dst > 0
    n_src = spec.num_src
    n_dst = spec.num_dst if bipartite else spec.num_src

    # -- timestamps: bursty log-normal inter-arrivals, normalized to span ----
    gaps = rng.lognormal(mean=0.0, sigma=1.5, size=E)
    t = np.cumsum(gaps)
    t = (t / t[-1] * (spec.duration_ticks - 1)).astype(np.int64)

    # -- sources: Zipf over users --------------------------------------------
    src = rng.choice(n_src, size=E, p=_zipf_probs(n_src, spec.zipf_src))

    # -- destinations: mixture of (a) re-draw from the user's own past items
    #    (controls duplicate-edge rate / "surprise") and (b) global Zipf.
    dst_global = rng.choice(n_dst, size=E, p=_zipf_probs(n_dst, spec.zipf_dst))
    # Per-user sticky item: a cheap stand-in for preference concentration —
    # with prob repeat_bias, a user interacts within a small personal pool.
    pool_size = 4
    personal_pools = rng.integers(0, n_dst, size=(n_src, pool_size))
    pick = rng.integers(0, pool_size, size=E)
    dst_personal = personal_pools[src, pick]
    use_personal = rng.random(E) < spec.repeat_bias
    dst = np.where(use_personal, dst_personal, dst_global)

    if bipartite:
        dst = dst + n_src  # offset item ids after user ids
        num_nodes = n_src + n_dst
    else:
        # unipartite (trade-like): avoid self loops
        dst = np.where(dst == src, (dst + 1) % n_src, dst)
        num_nodes = n_src

    edge_feats = None
    if spec.edge_feat_dim:
        # Low-rank structured features + noise (LIWC-like correlation).
        basis = rng.standard_normal((16, spec.edge_feat_dim)).astype(np.float32)
        codes = rng.standard_normal((E, 16)).astype(np.float32) * 0.3
        edge_feats = codes @ basis + 0.05 * rng.standard_normal(
            (E, spec.edge_feat_dim)
        ).astype(np.float32)

    node_ids = node_t = node_feats = None
    if spec.node_event_rate > 0:
        M = int(E * spec.node_event_rate)
        node_ids = rng.integers(0, num_nodes, size=M)
        node_t = np.sort(rng.integers(0, spec.duration_ticks, size=M))
        if spec.node_feat_dim:
            node_feats = rng.standard_normal((M, spec.node_feat_dim)).astype(np.float32)

    static = None
    if spec.node_feat_dim:
        static = rng.standard_normal((num_nodes, spec.node_feat_dim)).astype(np.float32)

    return DGData.from_arrays(
        src, dst, t,
        edge_feats=edge_feats,
        node_ids=node_ids, node_t=node_t, node_feats=node_feats,
        static_node_feats=static,
        granularity=spec.granularity,
        num_nodes=num_nodes,
    )


def dst_pool_of(data: DGData) -> np.ndarray:
    """Destination pool for negative sampling (the observed dst set)."""
    return np.unique(data.dst)
