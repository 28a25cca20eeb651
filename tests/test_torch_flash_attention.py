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

The gradient (K5b, the port's own kernel: the reference leaves it to
autodiff): its plain version ``flash_attention_bwd_ref`` (from the
forward's output and row log-sum-exp, ``flash_attention_lse_ref``)
against torch autograd of the plain forward and ``jax.vjp`` of the
reference's oracle, in both layouts, masked pairs giving exact zeros; the
dk/dv pass's walk (``q_tile_range``) against the mask at K5b's tiles; and
the dispatch on the kernel path, with the plain versions standing in for
the kernels: a call that needs a gradient goes through
``_FlashAttentionFn`` (K5 with the log-sum-exp, then K5b), one that does
not is one K5 launch, and a remat train step of the reduced qwen3 counts
two forwards and one backward a layer.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro_torch.configs import ARCHS
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd_ref,
    flash_attention_kernel,
    flash_attention_lse_ref,
    flash_attention_ref,
)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.kernel import (
    BWD_TILES,
    BWD_WG_ROWS,
    TILES,
    bwd_plan,
    bwd_scratch_shape,
    bwd_stats_ref,
    kv_tile_range,
    q_tile_range,
    tile_needs_mask,
)
from repro_torch.models.lm import layers as lm_layers
from repro_torch.models.lm import model as M
from repro_torch.tree import tree_leaves, tree_map

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


def _visible(Sq, Skv, causal, window):
    i = np.arange(Sq)[:, None] + (Skv - Sq)
    t = np.arange(Skv)[None, :]
    vis = np.ones((Sq, Skv), dtype=bool)
    if causal:
        vis &= t <= i
    if window:
        vis &= t > i - window
    return vis


WALK_IDS = ["sq{}_skv{}_{}_w{}".format(c[0], c[1], "causal" if c[2] else "full", c[3])
            for c in WALK_CASES]


def _bwd_walks(pass_name):
    """K5b's (own rows, walked tile) pairs of one pass: each dtype's block
    tiles and, in bfloat16, a warpgroup's own rows against the
    same walked tile."""
    walks = {t[pass_name] for t in BWD_TILES.values()}
    return walks | {(BWD_WG_ROWS, BWD_TILES[torch.bfloat16][pass_name][1])}


# K5's tiles and the dq pass of K5b (a block's or a warpgroup's q rows, the
# kv tile it walks).
@pytest.mark.parametrize("tiles", sorted(set(TILES.values()) | _bwd_walks("dq")),
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("case", WALK_CASES, ids=WALK_IDS)
def test_kernel_tile_walk_covers_every_visible_pair(case, tiles):
    """Each q tile walks every kv tile that holds a visible pair of its rows
    and no other, and a tile it walks without the mask is visible whole."""
    Sq, Skv, causal, window = case
    bq, bk = tiles
    vis = _visible(Sq, Skv, causal, window)
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


@pytest.mark.parametrize("tiles", sorted(_bwd_walks("dkdv")),
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("case", WALK_CASES, ids=WALK_IDS)
def test_bwd_kv_tile_walks_the_q_tiles_that_see_it(case, tiles):
    """K5b's dk/dv pass: each tile of ``tiles[0]`` keys walks exactly the q
    tiles of ``tiles[1]`` rows that hold a visible pair with it (none, for
    keys no row sees), and a walked tile the kernel does not mask is
    visible whole."""
    Sq, Skv, causal, window = case
    bk, bq = tiles
    vis = _visible(Sq, Skv, causal, window)
    for k0 in range(0, Skv, bk):
        cols = vis[:, k0:k0 + bk]
        beg, end = q_tile_range(k0, Sq, Skv, causal, window, bk, bq)
        assert 0 <= beg <= end <= -(-Sq // bq)
        for tt in range(-(-Sq // bq)):
            tile = cols[tt * bq:(tt + 1) * bq]
            if beg <= tt < end:
                assert tile.any(), (k0, tt)
                if not (tt * bq + bq > Sq or tile_needs_mask(
                        tt * bq, k0, Sq, Skv, causal, window, bq, bk)):
                    assert tile.shape == (bq, bk) and tile.all(), (k0, tt)
            else:
                assert not tile.any(), (k0, tt)


@pytest.mark.parametrize("case", WALK_CASES, ids=WALK_IDS)
def test_bwd_warpgroup_walks_lie_in_their_block_walk(case):
    """K5b's bfloat16 blocks stream the block's walk through the ring and
    each warpgroup computes the part its own rows see: that part
    lies inside the block's walk for both passes (a warpgroup whose rows
    lie past the end has none)."""
    Sq, Skv, causal, window = case
    wg = BWD_WG_ROWS
    own, walk = BWD_TILES[torch.bfloat16]["dq"]
    for q0 in range(0, Sq, own):
        beg, end = kv_tile_range(q0, Sq, Skv, causal, window, own, walk)
        for qw0 in range(q0, q0 + own, wg):
            if qw0 < Sq:
                wb, we = kv_tile_range(qw0, Sq, Skv, causal, window, wg, walk)
                assert beg <= wb and we <= end, (q0, qw0)
    own, walk = BWD_TILES[torch.bfloat16]["dkdv"]
    for k0 in range(0, Skv, own):
        beg, end = q_tile_range(k0, Sq, Skv, causal, window, own, walk)
        for kw0 in range(k0, k0 + own, wg):
            if kw0 < Skv:
                wb, we = q_tile_range(kw0, Sq, Skv, causal, window, wg, walk)
                assert wb == we or (beg <= wb and we <= end), (k0, kw0)


# ----------------------------------------------------------------------
# K5b's bfloat16 host-side plan: the TMA maps and the row statistics
# ----------------------------------------------------------------------
def _tma_load(flat, dims, byte_strides, box, coords):
    """What a TMA tile load reads: the ``box`` (innermost first) at
    ``coords`` of the map (dims, byte strides of dims 1..3) over the bf16
    storage ``flat`` (elements from the map's base), zeros out of bounds;
    returned as (rows, columns)."""
    idx = np.meshgrid(*[c + np.arange(n) for c, n in zip(coords, box)], indexing="ij")
    inside = np.ones(idx[0].shape, dtype=bool)
    off = idx[0].astype(np.int64)
    for i, (x, n) in enumerate(zip(idx, dims)):
        inside &= (x >= 0) & (x < n)
        if i:
            assert byte_strides[i - 1] % 16 == 0
            off = off + x * (byte_strides[i - 1] // 2)
    vals = np.where(inside, flat[np.where(inside, off, 0)], 0.0)
    return vals.reshape(box[0], box[1]).T


@pytest.mark.parametrize("D", [8, 32, 48, 64, 96, 120, 128])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_bwd_tensor_maps_read_each_operand_tile(layout, D):
    """K5b's tensor map arguments (``bwd_plan``, what the wrapper passes)
    against numpy's emulation of a TMA box load over the operand's
    storage, for q as a view into a wider fused projection (the model's
    layout) or a contiguous tensor: every (column atom, 64-row tile, head, batch) box is
    the operand's tile, zero-padded past D and past the last row; every
    byte stride a multiple of 16."""
    B, H, Hk, Sq, Skv = 2, 4, 2, 100, 70
    rng = np.random.default_rng(D)
    if layout == "bshd":  # q, k, v as views of one (B, S, (H + 2 Hk) D) tensor
        qkv = torch.as_tensor(rng.standard_normal((B, Sq, (H + 2 * Hk) * D)).astype(np.float32))
        q = qkv[:, :, :H * D].unflatten(-1, (H, D))
        flat, base = qkv.numpy().reshape(-1), 0
        bhsd = q.transpose(1, 2)
    else:
        q = torch.as_tensor(rng.standard_normal((B, H, Sq, D)).astype(np.float32))
        flat, base, bhsd = q.numpy().reshape(-1), 0, q
    st = list(fa_kernel._bhs_strides(q, layout))
    plan = bwd_plan(B, H, Hk, Sq, Skv, D, st * 8)
    dims, strides, box = plan["maps"][0]
    assert dims == [D, Sq, H, B] and box == [64, 64, 1, 1]
    assert all(x % 16 == 0 and 0 < x < 2 ** 40 for x in strides)
    kd = 64 if D <= 64 else 128
    want = np.zeros((B, H, plan["sq_pad"], kd), np.float32)
    want[:, :, :Sq, :D] = bhsd.numpy()
    for b in range(B):
        for h in range(H):
            for r0 in range(0, plan["sq_pad"], 64):
                for atom in range(kd // 64):
                    got = _tma_load(flat[base:], dims, strides, box, (64 * atom, r0, h, b))
                    np.testing.assert_array_equal(
                        got, want[b, h, r0:r0 + 64, 64 * atom:64 * atom + 64])


def test_bwd_plan_grids_scratch_and_shared_memory():
    """K5b's bfloat16 plan pads the row statistics to Sq rounded up to 128
    rows, the scratch the wrapper allocates, so that the dq grid (padded
    rows over a block's own rows) and the resident rows a block stages (in
    box-row loads) cover every row and read no statistic past the scratch;
    and it names the q, k, v and dO maps with their rows and heads."""
    own = BWD_TILES[torch.bfloat16]["dq"][0]
    for B, H, Hk, Sq, Skv, D in ((4, 16, 8, 4096, 4096, 128), (4, 25, 5, 4096, 4096, 64),
                                 (2, 25, 5, 100, 4096, 64), (1, 4, 2, 1, 1, 8),
                                 (1, 6, 2, 130, 130, 120)):
        plan = bwd_plan(B, H, Hk, Sq, Skv, D, [8] * 24)
        assert plan["sq_pad"] == -(-Sq // 128) * 128 >= Sq
        assert bwd_scratch_shape(torch.bfloat16, B, H, Sq) == (B * H, plan["sq_pad"], 2)
        assert plan["sq_pad"] % own == 0 and plan["sq_pad"] - Sq < own
        assert [m[0] for m in plan["maps"]] == [[D, Sq, H, B], [D, Skv, Hk, B],
                                                [D, Skv, Hk, B], [D, Sq, H, B]]
        assert all(own % m[2][1] == 0 and m[2][0] == 64 for m in plan["maps"])
    assert bwd_scratch_shape(torch.float32, 2, 3, 5) == (2, 3, 5)


def test_bwd_tma_stride_rule_refuses_an_expanded_operand():
    """TMA takes no zero stride on a dimension longer than 1 (a kv head
    broadcast by ``expand``); a zero stride on a dimension of extent 1 is
    fine (the map takes 16 there)."""
    k = torch.zeros(2, 1, 5, 64).expand(2, 3, 5, 64)
    with pytest.raises(ValueError, match="TMA"):
        fa_kernel._check_tma_strides((k,), "bhsd")
    fa_kernel._check_tma_strides((torch.zeros(2, 1, 5, 64).expand(2, 1, 5, 64),), "bhsd")
    assert fa_kernel.bwd_tensor_map(64, 5, 1, 2, (320, 0, 64))[1] == [128, 16, 640]


def _emulate_bwd_bf16(q, k, v, o, lse, do, causal, window):
    """A numpy mirror of K5b's bfloat16 passes in (B, H, S, D): the padded
    row statistics, the blocks' walks and each warpgroup's part of them,
    the exp2 form of P, the mask only where ``tile_needs_mask`` says, and P
    and dS rounded once to bf16 as the A operands of the second products;
    float32 sums."""
    B, H, Sq, D = q.shape
    Hk, Skv = k.shape[1], k.shape[2]
    G, sc, off = H // Hk, 1.0 / np.sqrt(D), Skv - Sq
    stats = bwd_stats_ref(o, lse, do).numpy().reshape(B, H, -1, 2)
    qn, kn, vn, gn = (x.float().numpy() for x in (q, k, v, do))
    bf = lambda x: torch.as_tensor(x).to(torch.bfloat16).float().numpy()  # noqa: E731
    own, wk = BWD_TILES[torch.bfloat16]["dq"]
    wg = BWD_WG_ROWS
    vis = _visible(Sq, Skv, causal, window)

    def probs(s, lse2, rows, keys, masked):
        p = np.exp2(s * sc * np.log2(np.e) - lse2).astype(np.float32)
        if masked:
            ok = np.zeros(p.shape, dtype=bool)
            r_in, k_in = rows < Sq, keys < Skv
            ok[np.ix_(r_in, k_in)] = vis[np.ix_(rows[r_in], keys[k_in])]
            p = np.where(ok, p, 0.0)
        return p

    dq = np.zeros((B, H, Sq, D), np.float32)
    dk = np.zeros((B, Hk, Skv, D), np.float32)
    dv = np.zeros_like(dk)
    pad = lambda x, n: np.pad(x, ((0, max(0, n - len(x))), (0, 0)))[:n]  # noqa: E731
    for b in range(B):
        for h in range(H):
            hk = h // G
            for q0 in range(0, Sq, own):
                t_beg, t_end = kv_tile_range(q0, Sq, Skv, causal, window, own, wk)
                for qw0 in range(q0, min(q0 + own, Sq), wg):
                    wb, we = kv_tile_range(qw0, Sq, Skv, causal, window, wg, wk)
                    rows = np.arange(qw0, qw0 + wg)
                    st = stats[b, h, qw0:qw0 + wg]
                    acc = np.zeros((wg, D), np.float32)
                    for t in range(max(t_beg, wb), min(t_end, we)):
                        keys = np.arange(t * wk, t * wk + wk)
                        kt, vt = pad(kn[b, hk, t * wk:], wk), pad(vn[b, hk, t * wk:], wk)
                        s = pad(qn[b, h, qw0:], wg) @ kt.T
                        dp = pad(gn[b, h, qw0:], wg) @ vt.T
                        p = probs(s, st[:, :1], rows, keys, tile_needs_mask(
                            qw0, t * wk, Sq, Skv, causal, window, wg, wk))
                        acc += bf(p * (dp - st[:, 1:])) @ kt
                    n = min(wg, Sq - qw0)
                    dq[b, h, qw0:qw0 + n] = acc[:n] * sc
    own, wk = BWD_TILES[torch.bfloat16]["dkdv"]
    for b in range(B):
        for hk in range(Hk):
            for k0 in range(0, Skv, own):
                t_beg, t_end = q_tile_range(k0, Sq, Skv, causal, window, own, wk)
                for kw0 in range(k0, min(k0 + own, Skv), wg):
                    wb, we = q_tile_range(kw0, Sq, Skv, causal, window, wg, wk)
                    keys = np.arange(kw0, kw0 + wg)
                    kt, vt = pad(kn[b, hk, kw0:], wg), pad(vn[b, hk, kw0:], wg)
                    ak, av = np.zeros((wg, D), np.float32), np.zeros((wg, D), np.float32)
                    for h in range(hk * G, hk * G + G):
                        for t in range(t_beg, t_end):
                            if not wb <= t < we:
                                continue
                            q0 = t * wk
                            rows = np.arange(q0, q0 + wk)
                            qt, gt = pad(qn[b, h, q0:], wk), pad(gn[b, h, q0:], wk)
                            st = stats[b, h, q0:q0 + wk]
                            masked = q0 + wk > Sq or tile_needs_mask(
                                q0, kw0, Sq, Skv, causal, window, wk, wg)
                            pt = probs(qt @ kt.T, st[:, :1], rows, keys, masked).T
                            av += bf(pt) @ gt
                            ak += bf(pt * (vt @ gt.T - st[:, 1].T)) @ qt
                    n = min(wg, Skv - kw0)
                    dk[b, hk, kw0:kw0 + n] = ak[:n] * sc
                    dv[b, hk, kw0:kw0 + n] = av[:n]
    return dq, dk, dv


# (name, B, H, Hk, Sq, Skv, D, causal, window): the tiles' edges (Sq and
# Skv not multiples of 128, a key block no row sees, GQA 5, a window).
EMU_CASES = [
    ("causal_g2", 1, 4, 2, 200, 200, 32, True, 0),
    ("skv_ragged_g5_window", 1, 5, 1, 150, 300, 16, True, 40),
    ("unseen_key_block", 1, 2, 1, 20, 300, 16, True, 8),
    ("noncausal_ragged", 1, 4, 2, 70, 133, 24, False, 0),
    ("window_no_causal", 1, 2, 2, 190, 190, 8, False, 33),
]


@pytest.mark.parametrize("case", EMU_CASES, ids=[c[0] for c in EMU_CASES])
def test_bwd_bf16_pass_mirror_matches_the_plain_backward(case):
    """The numpy mirror of K5b's bfloat16 passes (walks, warpgroup parts,
    padded statistics, mask, P and dS rounded once to bf16) against the
    plain backward on bf16 inputs, to the bf16 tolerance of each gradient's
    largest entry; keys no row sees get exactly zero dk and dv."""
    _, B, H, Hk, Sq, Skv, D, causal, window = case
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.as_tensor(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
                   for s in ((B, H, Sq, D), (B, Hk, Skv, D), (B, Hk, Skv, D), (B, H, Sq, D)))
    kw = dict(causal=causal, window=window)
    o, lse = flash_attention_lse_ref(q, k, v, **kw)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    got = _emulate_bwd_bf16(q, k, v, o, lse, do, causal, window)
    for name, g, w in zip("qkv", got, want):
        w = w.float().numpy()
        assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max(), name
    seen = _visible(Sq, Skv, causal, window).any(0)
    assert not got[1][:, :, ~seen].any() and not got[2][:, :, ~seen].any()


# ----------------------------------------------------------------------
# The gradient: K5b's plain version
# ----------------------------------------------------------------------
# (name, B, H, Hk, Sq, Skv, D, causal, window)
BWD_CASES = [
    ("causal_g2", 2, 4, 2, 40, 40, 32, True, 0),
    ("window_g2", 1, 4, 2, 48, 48, 16, True, 12),
    ("gqa_g5_window", 1, 10, 2, 33, 33, 24, True, 9),
    ("offset_sq_lt_skv", 2, 4, 2, 20, 64, 32, True, 8),
    ("noncausal", 1, 6, 3, 24, 37, 16, False, 0),
    ("noncausal_window", 1, 4, 1, 30, 30, 8, False, 7),
]
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _bwd_inputs(case, seed=3):
    _, B, H, Hk, Sq, Skv, D, causal, window = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, H, Sq, D), (B, Hk, Skv, D), (B, Hk, Skv, D), (B, H, Sq, D)))
    return (q, k, v, do), dict(causal=causal, window=window)


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_bwd_ref_matches_autograd_and_the_reference(case):
    (q, k, v, do), kw = _bwd_inputs(case)
    tq, tk, tv = (torch.as_tensor(a).requires_grad_() for a in (q, k, v))
    o = flash_attention_ref(tq, tk, tv, **kw)
    want = torch.autograd.grad(o, (tq, tk, tv), torch.as_tensor(do))

    o2, lse = flash_attention_lse_ref(tq.detach(), tk.detach(), tv.detach(), **kw)
    np.testing.assert_allclose(o2.numpy(), o.detach().numpy(), **F32_TOL)
    got = flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(), o2, lse,
                                  torch.as_tensor(do), **kw)
    ref = jax.jit(lambda q, k, v, do: jax.vjp(
        lambda *x: jax_flash_ref(*x, **kw), q, k, v)[1](do))(q, k, v, do)
    for name, g, w, r in zip("qkv", got, want, ref):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name, **GRAD_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **GRAD_TOL)

    # the model's layout: the transposed call
    t = [x.transpose(1, 2) for x in (tq.detach(), tk.detach(), tv.detach(), o2,
                                     torch.as_tensor(do))]
    bshd = flash_attention_bwd_ref(*t[:4], lse, t[4], **kw, layout="bshd")
    for g, b in zip(got, bshd):
        assert torch.equal(b.transpose(1, 2), g)


def test_bwd_ref_gives_exact_zeros_where_masked():
    """Keys no query sees (the window behind an offset) get exactly zero
    dk and dv rows; masked pairs add exactly nothing to dq."""
    case = ("offset_sq_lt_skv", 1, 4, 2, 20, 64, 32, True, 8)
    (q, k, v, do), kw = _bwd_inputs(case, seed=5)
    tq, tk, tv, tdo = map(torch.as_tensor, (q, k, v, do))
    o, lse = flash_attention_lse_ref(tq, tk, tv, **kw)
    dq, dk, dv = flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, **kw)
    seen = _visible(20, 64, True, 8).any(0)
    assert (~seen).sum() == 64 - 27
    assert not dk[:, :, ~seen].any() and not dv[:, :, ~seen].any()
    assert dk[:, :, seen].abs().amax(-1).min() > 0
    # k and v rows no query sees may hold anything: dq does not change
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[:, :, ~seen] = 1e3
    tv2[:, :, ~seen] = -1e3
    o2, lse2 = flash_attention_lse_ref(tq, tk2, tv2, **kw)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    assert torch.equal(flash_attention_bwd_ref(tq, tk2, tv2, o2, lse2, tdo, **kw)[0], dq)


# ----------------------------------------------------------------------
# The dispatch on the kernel path, the plain versions standing in
# ----------------------------------------------------------------------
def _stubs(monkeypatch):
    """Route the kernel path through recording stand-ins for K5 and K5b
    (their plain versions) and let ``use_kernel`` take it for CPU tensors
    in "auto"; returns the list of calls."""
    calls = []

    def fwd(q, k, v, *, causal, window, layout, return_lse=False):
        calls.append("K5+lse" if return_lse else "K5")
        t = (lambda x: x.transpose(1, 2)) if layout == "bshd" else (lambda x: x)
        o, lse = flash_attention_lse_ref(t(q), t(k), t(v), causal=causal,
                                         window=window)
        return (t(o), lse) if return_lse else t(o)

    def bwd(q, k, v, o, lse, do, *, causal, window, layout):
        calls.append("K5b")
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window, layout=layout)

    auto = lambda mode, x: mode != "ref"  # noqa: E731
    monkeypatch.setattr(fa_ops, "use_kernel", auto)
    monkeypatch.setattr(lm_layers, "use_kernel", auto)
    monkeypatch.setattr(fa_ops, "_FWD", fwd)
    monkeypatch.setattr(fa_ops, "_BWD", bwd)
    return calls


def test_a_gradient_call_goes_through_k5_and_k5b(monkeypatch):
    calls = _stubs(monkeypatch)
    (q, k, v, do), kw = _bwd_inputs(BWD_CASES[2])
    tx = [torch.as_tensor(a).transpose(1, 2).contiguous().requires_grad_()
          for a in (q, k, v)]
    o = flash_attention(*tx, **kw, layout="bshd")
    assert calls == ["K5+lse"] and type(o.grad_fn).__name__ == "_FlashAttentionFnBackward"
    got = torch.autograd.grad(o, tx, torch.as_tensor(do).transpose(1, 2))
    assert calls == ["K5+lse", "K5b"]
    want = torch.autograd.grad(flash_attention(*tx, **kw, layout="bshd", mode="ref"),
                               tx, torch.as_tensor(do).transpose(1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)
    calls.clear()
    with torch.no_grad():  # no gradient wanted: one K5 launch, no lse
        assert flash_attention(*tx, **kw, layout="bshd").grad_fn is None
    flash_attention(*(x.detach() for x in tx), **kw, layout="bshd")
    assert calls == ["K5", "K5"]


def test_a_remat_train_step_runs_two_forwards_and_one_backward_a_layer(monkeypatch):
    calls = _stubs(monkeypatch)
    cfg = dataclasses.replace(ARCHS["qwen3-0.6b"].reduced(), remat=True)
    params = M.init(cfg, torch.Generator().manual_seed(4))
    rng = np.random.default_rng(6)
    batch = {n: torch.as_tensor(rng.integers(0, 256, (2, 24)).astype(np.int32))
             for n in ("tokens", "labels")}
    grads = {}
    for mode in ("auto", "ref"):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        tree = tree_map(lambda _: next(it), params)
        loss = M.loss_fn(tree, cfg, batch, kv_block=8, mode=mode)
        grads[mode] = torch.autograd.grad(loss, leaves)
    n = cfg.num_layers
    assert calls == ["K5+lse"] * n + ["K5+lse", "K5b"] * n
    for g, w in zip(grads["auto"], grads["ref"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()) + 1e-7)
