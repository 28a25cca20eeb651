"""Negative edge construction for dynamic link prediction.

Supports the standard protocols:
  * random   — uniform destination corruption (training default)
  * historical — negatives drawn from previously-seen edges not active now
                 (Poursafaei et al. 2022 evaluation)

Host numpy copy of ``repro.core.negatives.NegativeEdgeSampler``: the same
``np.random.default_rng`` stream, so draws are bit-equal to the reference.

``snapshot_negatives`` is the DTDG counterpart: per-snapshot corrupted
destinations as a pure function of ``(seed, num_negatives, snapshot row)``.
The reference draws them through ``jax.random.fold_in``, which torch cannot
reproduce; the port keeps the property that matters (a row's draws depend
on nothing else, on every device) with its own stream, and parity tests
hand the reference's draws in.
"""

from __future__ import annotations

from typing import Optional, Set, Tuple

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def _row_seed(seed: int, num_negatives: int, row: int) -> int:
    """A fixed 63-bit mix of ``(seed, num_negatives, row)`` (SplitMix64's
    finalizer over a golden-ratio combination), the seed of one row's
    generator."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(num_negatives) * 0xBF58476D1CE4E5B9
         + int(row) * 0x94D049BB133111EB + 0x632BE59BD9B4E019) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def snapshot_negatives(seed: int, num_nodes: int, capacity: int,
                       num_negatives: int, rows, device="cpu"):
    """Deterministic per-snapshot negative destinations.

    Returns a ``(len(rows), capacity, num_negatives)`` int32 tensor of
    uniform node draws on ``device``. Row ``r`` is drawn by its own CPU
    ``torch.Generator`` seeded from ``(seed, num_negatives, r)`` alone, so a
    bulk draw over many rows equals any subset of it drawn alone (the
    compiled-vs-hook parity invariant), a restored snapshot cursor replays
    the same negatives, and the draws are the same on every device (they
    are moved there afterwards).
    """
    hi = max(int(num_nodes), 1)
    out = [torch.randint(0, hi, (capacity, num_negatives), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(
                             _row_seed(seed, num_negatives, r)))
           for r in np.asarray(rows, dtype=np.int64).reshape(-1).tolist()]
    if not out:
        return torch.zeros((0, capacity, num_negatives), dtype=torch.int32,
                           device=device)
    return torch.stack(out).to(device)


class NegativeEdgeSampler:
    """Stateful negative-edge sampler for the CTDG link recipes (random or
    historical destination corruption; see the module docstring)."""

    def __init__(
        self,
        num_nodes: int,
        strategy: str = "random",
        num_negatives: int = 1,
        seed: int = 0,
        dst_pool: Optional[np.ndarray] = None,
    ):
        if strategy not in ("random", "historical"):
            raise ValueError(f"unknown strategy {strategy!r}")
        self.num_nodes = int(num_nodes)
        self.strategy = strategy
        self.num_negatives = int(num_negatives)
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        # Destination pool (e.g. item side of a bipartite graph).
        self.dst_pool = (
            np.arange(self.num_nodes, dtype=np.int64)
            if dst_pool is None
            else np.asarray(dst_pool, dtype=np.int64)
        )
        self._hist: Set[Tuple[int, int]] = set()
        self._hist_dst = np.zeros(0, dtype=np.int64)
        self._hist_dirty = False

    def reset_state(self) -> None:
        """Reset the RNG and the historical destination pool."""
        self._rng = np.random.default_rng(self._seed)
        self._hist.clear()
        self._hist_dst = np.zeros(0, dtype=np.int64)
        self._hist_dirty = False

    def observe(self, src: np.ndarray, dst: np.ndarray) -> None:
        """Record positives for the historical strategy."""
        if self.strategy != "historical":
            return
        for u, v in zip(src.tolist(), dst.tolist()):
            self._hist.add((u, v))
        self._hist_dirty = True

    def sample(self, src: np.ndarray, dst: np.ndarray, t: np.ndarray) -> np.ndarray:
        """Sample ``(B, num_negatives)`` negative destinations."""
        B = len(src)
        if self.strategy == "random" or not self._hist:
            neg = self._rng.choice(self.dst_pool, size=(B, self.num_negatives))
            return neg.astype(np.int64)
        # historical: half historical destinations, half random (the standard
        # mixed protocol); vectorized draw from the historical dst multiset.
        if self._hist_dirty:
            self._hist_dst = np.fromiter(
                (v for (_, v) in self._hist), dtype=np.int64, count=len(self._hist)
            )
            self._hist_dirty = False
        n_hist = self.num_negatives // 2
        n_rand = self.num_negatives - n_hist
        parts = []
        if n_hist:
            parts.append(self._rng.choice(self._hist_dst, size=(B, n_hist)))
        if n_rand:
            parts.append(self._rng.choice(self.dst_pool, size=(B, n_rand)))
        return np.concatenate(parts, axis=1).astype(np.int64)
