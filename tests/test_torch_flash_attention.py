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
from repro_torch.kernels.flash_attention.kernel import (
    BWD_TILES,
    TILES,
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


# K5's tiles and the dq pass of K5b (a block's q rows, the kv tile it walks).
@pytest.mark.parametrize("tiles", sorted(set(TILES.values()) | set(BWD_TILES.values())),
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


@pytest.mark.parametrize("tiles", sorted(set(BWD_TILES.values())),
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
