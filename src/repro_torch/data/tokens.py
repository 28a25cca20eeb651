"""Deterministic synthetic token stream for LM training (a copy of the
reference's ``repro.data.tokens``, bit-equal for the same arguments).

Structured (learnable) tokens: a Markov chain over a small state space
projected into the vocabulary, so a model's loss falls measurably within a
few hundred steps, with no external data.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def synthetic_token_batches(
    vocab_size: int,
    batch_size: int,
    seq_len: int,
    num_batches: int,
    seed: int = 0,
    num_states: int = 64,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields (tokens, labels) int32 arrays of shape (B, S); labels are the
    next-token shift of tokens (the chain's next draw past the end)."""
    rng = np.random.default_rng(seed)
    k = min(num_states, vocab_size)
    # Sparse-ish row-stochastic transition matrix.
    trans = rng.dirichlet(np.full(k, 0.1), size=k)
    cdf = np.cumsum(trans, axis=1)
    proj = rng.integers(0, vocab_size, size=k)  # state -> token id

    for _ in range(num_batches):
        states = rng.integers(0, k, size=batch_size)
        seq = np.empty((batch_size, seq_len + 1), dtype=np.int64)
        u = rng.random((batch_size, seq_len + 1))
        for s in range(seq_len + 1):
            seq[:, s] = proj[states]
            # advance the chain (vectorized inverse-CDF draw)
            states = (cdf[states] < u[:, s : s + 1]).sum(axis=1)
            states = np.minimum(states, k - 1)
        tokens = seq[:, :-1].astype(np.int32)
        labels = seq[:, 1:].astype(np.int32)
        yield tokens, labels
