"""Parity of the port's flash attention (K5) with the reference, on the CPU.

The same numpy-seeded inputs go through the reference's oracle
(``flash_attention_ref``), its Pallas kernel in interpret mode, and the
port's plain version and ``mode="auto"`` dispatch (the plain version on a
CPU tensor). Cases: the reference's eight (``tests/kernels/families.py``:
base, unaligned, sliding window, chunked decode with Sq = 32 over Skv = 96,
bidirectional, GQA at D = 128, two in bfloat16) plus hymba's grouping (25
query over 5 kv heads, D = 64, a window). Tolerances are the harness's:
float32 2e-5, bfloat16 2e-2 (relative + absolute). The CUDA kernel itself
runs only on the card (``chip_smoke.py``'s ``lm_kernels`` phase); its tile
walk is held here through the Python mirror of its index math
(``kv_tile_range``, ``tile_needs_mask``) at both kernels' tile sizes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_kernel,
    flash_attention_ref,
)
from repro_torch.kernels.flash_attention.kernel import (
    TILES,
    kv_tile_range,
    tile_needs_mask,
)

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

# (name, B, H, Hk, Sq, Skv, D, causal, window, bf16): families.py:214-226,
# then hymba-1.5b's grouping (G = 5) with a window shorter than the tile.
CASES = [
    ("base", 2, 4, 2, 64, 64, 32, True, 0, False),
    ("unaligned_seq", 1, 4, 4, 60, 60, 64, True, 0, False),
    ("sliding_window", 2, 8, 2, 128, 128, 64, True, 32, False),
    ("chunked_decode", 1, 2, 1, 32, 96, 32, True, 0, False),
    ("bidirectional", 2, 4, 2, 64, 64, 32, False, 0, False),
    ("gqa_d128", 1, 16, 4, 128, 128, 128, True, 0, False),
    ("base_bf16", 2, 4, 2, 64, 64, 32, True, 0, True),
    ("window_bf16", 2, 8, 2, 128, 128, 64, True, 32, True),
    ("hymba_g5", 1, 25, 5, 80, 80, 64, True, 24, False),
]
IDS = [c[0] for c in CASES]


def _inputs(case, seed=0):
    _, B, H, Hk, Sq, Skv, D, causal, window, bf16 = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Sq, D), (B, Hk, Skv, D), (B, Hk, Skv, D))]
    if bf16:  # round once, so both packages see the same bfloat16 values
        jx = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
        tx = [torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
              for a in jx]
    else:
        jx = [jnp.asarray(a) for a in arrs]
        tx = [torch.as_tensor(a) for a in arrs]
    return jx, tx, dict(causal=causal, window=window), (BF16_TOL if bf16 else F32_TOL)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ref_matches_reference_oracle(case):
    jx, tx, kw, tol = _inputs(case)
    want = jax_flash_ref(*jx, **kw)
    got = flash_attention_ref(*tx, **kw)
    assert got.dtype == tx[0].dtype
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_auto_on_cpu_matches_reference_kernel_in_interpret_mode(case):
    """The port's dispatch on a CPU tensor (the plain version) against the
    reference's Pallas kernel body run by the interpreter (32 x 32 blocks,
    as the reference's harness runs it)."""
    jx, tx, kw, tol = _inputs(case, seed=1)
    want = jax_flash_attention(*jx, **kw, block_q=32, block_k=32, mode="interpret")
    got = flash_attention(*tx, **kw, mode="auto")
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_bshd_layout_is_the_transposed_call():
    jx, tx, kw, _ = _inputs(CASES[2])
    want = flash_attention(*tx, **kw, mode="ref")
    got = flash_attention(*(t.transpose(1, 2) for t in tx), **kw, mode="ref",
                          layout="bshd")
    assert torch.equal(got.transpose(1, 2), want)


def test_kernel_mode_raises_on_cpu():
    _, tx, kw, _ = _inputs(CASES[0])
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(*tx, **kw, mode="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_kernel(*tx, **kw)
    with pytest.raises(ValueError, match="unknown kernel dispatch mode"):
        flash_attention(*tx, **kw, mode="interpret")


# (Sq, Skv, causal, window) for the tile walk: causal and not, windowed and
# not, Sq < Skv at offsets that are not multiples of a tile, windows that
# are not multiples of a tile and windows >= S, S = 1, hymba's prefill.
WALK_CASES = [
    (300, 300, True, 0), (300, 300, False, 0), (300, 300, True, 100),
    (300, 300, False, 70), (37, 203, True, 0), (129, 1000, True, 77),
    (100, 4096, True, 1024), (200, 263, False, 0), (1000, 1000, True, 2048),
    (64, 64, True, 64), (1, 1, True, 0), (1, 1, False, 0), (1, 97, True, 5),
    (1, 1, True, 3), (2048, 2048, True, 1024),
]


@pytest.mark.parametrize("tiles", sorted(set(TILES.values())),
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("case", WALK_CASES, ids=lambda c: "sq{}_skv{}_{}_w{}".format(
    c[0], c[1], "causal" if c[2] else "full", c[3]))
def test_kernel_tile_walk_covers_every_visible_pair(case, tiles):
    """Each q tile walks every kv tile that holds a visible pair of its rows
    and no other, and a tile it walks without the mask is visible whole."""
    Sq, Skv, causal, window = case
    bq, bk = tiles
    i = np.arange(Sq)[:, None] + (Skv - Sq)
    t = np.arange(Skv)[None, :]
    vis = np.ones((Sq, Skv), dtype=bool)
    if causal:
        vis &= t <= i
    if window:
        vis &= t > i - window
    for q0 in range(0, Sq, bq):
        rows = vis[q0:q0 + bq]
        beg, end = kv_tile_range(q0, Sq, Skv, causal, window, bq, bk)
        assert 0 <= beg < end <= -(-Skv // bk)
        for tt in range(-(-Skv // bk)):
            tile = rows[:, tt * bk:(tt + 1) * bk]
            if beg <= tt < end:
                assert tile.any(), (q0, tt)
                if not tile_needs_mask(q0, tt * bk, Sq, Skv, causal, window, bq, bk):
                    assert tile.shape[1] == bk and tile.all(), (q0, tt)
            else:
                assert not tile.any(), (q0, tt)
