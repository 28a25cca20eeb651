"""K3b's plain version and K3/K3b's chunked arithmetic hold against the JAX
package's gradient of the classic attention.

The JAX package has no backward kernel for ``temporal_attention``: its
gradient is ``jax.vjp`` of the jnp oracle ``temporal_attention_ref``, taken
here op by op (``jax.disable_jit()``). The port's backward kernel (K3b,
``csrc/temporal_attention_bwd.cu``) computes that gradient by the formulas
of ``temporal_attention_bwd_ref``; both CUDA kernels stage a seed's slots in
chunks (``kernel.ta_plan``) with an online softmax that starts at the first
chunk holding a valid slot. Inputs come from a numpy seed. Tolerances as in
``tests/kernels/harness.py``: forward f32 2e-5, gradients 1e-4, bf16 2e-2.
Masked slots and rows with no valid slot give exact zeros. The kernels
themselves run only on the card (``chip_smoke.py``'s ``classic_kernels``).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.temporal_attention.ref import (
    temporal_attention_ref as jax_temporal_attention_ref,
)
from repro_torch.kernels.temporal_attention import (
    ta_plan,
    temporal_attention_bwd_ref,
)
from repro_torch.kernels.temporal_attention.kernel import TA_DEFAULT_SHARED, TA_MAX_SHARED

TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)

# The classic attention tests' cases (test_torch_classic_attention.py).
CASES = (
    ("path", 60, 10, 2, 50, "random"),
    ("s100_k16", 100, 16, 2, 32, "random"),
    ("s33_k8_h1", 33, 8, 1, 16, "random"),
    ("s128_d100", 128, 20, 2, 100, "random"),
    ("all_masked", 8, 4, 2, 16, "none"),
    ("some_rows_empty", 40, 10, 2, 50, "rows"),
    ("one_valid_slot", 40, 10, 2, 50, "one"),
    ("k1", 50, 1, 2, 50, "random"),
    ("s1", 1, 10, 2, 50, "random"),
    ("d33", 37, 10, 2, 33, "random"),
    ("d128", 37, 10, 2, 128, "random"),
)
BF16_CASES = (("s100_k16_bf16", 100, 16, 2, 32), ("s33_k8_bf16", 33, 8, 1, 16),
              ("path_bf16", 60, 10, 2, 50))


def _inputs(seed, S, K, H, D, mask_kind, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    k = rng.standard_normal((S, K, H, D)).astype(np.float32)
    v = rng.standard_normal((S, K, H, D)).astype(np.float32)
    g = rng.standard_normal((S, H, D)).astype(np.float32)
    if mask_kind == "none":
        mask = np.zeros((S, K), bool)
    elif mask_kind == "one":
        mask = np.zeros((S, K), bool)
        mask[np.arange(S), rng.integers(0, K, S)] = True
    else:
        mask = rng.random((S, K)) > 0.4
        if mask_kind == "rows":
            mask[::3] = False
        if mask_kind == "late":  # rows whose first chunk(s) hold no valid slot
            mask[::2, :16] = False
            mask[1::4, :32] = False
            mask[::5] = False
    if dtype != np.float32:  # round through the storage type once
        q, k, v, g = (np.array(jnp.asarray(x, dtype).astype(jnp.float32))
                      for x in (q, k, v, g))
    return q, k, v, g, mask


def _jax_vjp(q, k, v, mask, g, dtype=jnp.float32):
    with jax.disable_jit():
        args = [jnp.asarray(x, dtype) for x in (q, k, v)]
        _, vjp = jax.vjp(lambda a, b, c: jax_temporal_attention_ref(
            a, b, c, jnp.asarray(mask)), *args)
        return [np.asarray(x.astype(jnp.float32)) for x in vjp(jnp.asarray(g, dtype))]


def _jax_forward(q, k, v, mask):
    return np.asarray(jax_temporal_attention_ref(*map(jnp.asarray, (q, k, v, mask))))


def _check_zeros(dq, dk, dv, mask):
    empty = ~mask.any(-1)
    assert (dq[empty] == 0).all()
    assert (dk[~mask] == 0).all() and (dv[~mask] == 0).all()


@pytest.mark.parametrize("case,S,K,H,D,mask_kind", CASES, ids=[c[0] for c in CASES])
def test_bwd_ref_matches_jax_vjp(case, S, K, H, D, mask_kind):
    q, k, v, g, mask = _inputs(13, S, K, H, D, mask_kind)
    got = temporal_attention_bwd_ref(*map(torch.from_numpy, (g, q, k, v, mask)))
    want = _jax_vjp(q, k, v, mask, g)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == w.shape
        np.testing.assert_allclose(a.numpy(), w, err_msg=name, **GRAD_TOL)
    _check_zeros(*(t.numpy() for t in got), mask)


@pytest.mark.parametrize("case,S,K,H,D", BF16_CASES, ids=[c[0] for c in BF16_CASES])
def test_bwd_ref_bf16_matches_jax_vjp(case, S, K, H, D):
    q, k, v, g, mask = _inputs(17, S, K, H, D, "rows", dtype=jnp.bfloat16)
    args = [torch.from_numpy(x).to(torch.bfloat16) for x in (g, q, k, v)]
    got = temporal_attention_bwd_ref(*args, torch.from_numpy(mask))
    want = _jax_vjp(q, k, v, mask, g, jnp.bfloat16)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), w, err_msg=name, **BF16_TOL)
    _check_zeros(*(t.float().numpy() for t in got), mask)


# ---------------------------------------------------------------------------
# The kernels' chunked arithmetic, mirrored in float32 torch
# ---------------------------------------------------------------------------
def _online_stats(q, k, v, g, mask, chunk, scale):
    """K3's and K3b's first pass over the chunks: per (seed, head) the running
    maximum, the running sum of e = exp(s - max), the forward's sum of e v
    and (with g) the sum of e * dp, each rescaled when the maximum moves; a
    row's state starts at its first chunk with a valid slot ("seen")."""
    S, K, H, D = k.shape
    m = torch.zeros(S, H)
    l, t = torch.zeros(S, H), torch.zeros(S, H)
    acc = torch.zeros(S, H, D)
    seen = torch.zeros(S, dtype=torch.bool)
    for c0 in range(0, K, chunk):
        mc = mask[:, c0:c0 + chunk]
        has = mc.any(-1)
        kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = torch.einsum("shd,schd->shc", q, kc) * scale
        cm = torch.where(mc[:, None, :], s, -math.inf).amax(-1)
        old = seen[:, None]
        mn = torch.where(old, torch.maximum(m, cm), cm)
        alpha = torch.where(old, torch.exp(m - mn), 0.0)
        e = torch.where(mc[:, None, :], torch.exp(s - mn[..., None]), 0.0)
        upd = has[:, None]
        m = torch.where(upd, mn, m)
        l = torch.where(upd, alpha * l + e.sum(-1), l)
        acc = torch.where(upd[..., None],
                          alpha[..., None] * acc + torch.einsum("shc,schd->shd", e, vc), acc)
        if g is not None:
            dp = torch.einsum("shd,schd->shc", g, vc)
            t = torch.where(upd, alpha * t + (e * dp).sum(-1), t)
        seen |= has
    return m, l, t, acc, seen


def _chunked_forward(q, k, v, mask, chunk):
    """K3's arithmetic: online statistics over chunks, then acc * (1 / l);
    zeros for a row with no valid slot."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    _, l, _, acc, seen = _online_stats(q, k, v, None, mask, chunk, scale)
    inv = 1.0 / torch.where(seen[:, None], l, 1.0)
    return torch.where(seen[:, None, None], acc * inv[..., None], 0.0)


def _chunked_backward(g, q, k, v, mask, chunk):
    """K3b's arithmetic: pass 1 the statistics and delta = t / l, pass 2 per
    chunk p = exp(s - m) / l, ds = p (dp - delta), dq's sum and each slot's
    dk and dv; zeros for masked slots and rows without a valid slot."""
    S, K, H, D = k.shape
    scale = 1.0 / math.sqrt(D)
    m, l, t, _, seen = _online_stats(q, k, v, g, mask, chunk, scale)
    l = torch.where(seen[:, None], l, 1.0)
    delta = t / l
    dq = torch.zeros(S, H, D)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for c0 in range(0, K, chunk):
        mc = mask[:, c0:c0 + chunk]
        kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = torch.einsum("shd,schd->shc", q, kc) * scale
        p = torch.where(mc[:, None, :], torch.exp(s - m[..., None]) / l[..., None], 0.0)
        ds = p * (torch.einsum("shd,schd->shc", g, vc) - delta[..., None])
        dq += torch.einsum("shc,schd->shd", ds, kc)
        dk[:, c0:c0 + chunk] = scale * torch.einsum("shc,shd->schd", ds, q)
        dv[:, c0:c0 + chunk] = torch.einsum("shc,shd->schd", p, g)
    return scale * dq, dk, dv


CHUNK_CASES = (("k17", 24, 17, 2, 50, "late"), ("k300", 12, 300, 2, 16, "late"),
               ("k300_random", 9, 300, 1, 33, "random"), ("k40_rows", 30, 40, 2, 8, "rows"))


@pytest.mark.parametrize("case,S,K,H,D,mask_kind", CHUNK_CASES,
                         ids=[c[0] for c in CHUNK_CASES])
def test_chunked_forward_matches_jax_oracle(case, S, K, H, D, mask_kind):
    q, k, v, _, mask = _inputs(21, S, K, H, D, mask_kind)
    plan = ta_plan(S, K, H, D, torch.float32, True)
    assert plan["chunks"] > 1
    got = _chunked_forward(*map(torch.from_numpy, (q, k, v, mask)), plan["chunk"]).numpy()
    np.testing.assert_allclose(got, _jax_forward(q, k, v, mask), **TOL)
    assert (got[~mask.any(-1)] == 0).all()
    if mask_kind == "late":  # some rows start late, and some of those are live
        first = mask[:, :plan["chunk"]].any(-1)
        assert (~first & mask.any(-1)).any()


@pytest.mark.parametrize("case,S,K,H,D,mask_kind", CHUNK_CASES,
                         ids=[c[0] for c in CHUNK_CASES])
def test_chunked_backward_matches_jax_vjp(case, S, K, H, D, mask_kind):
    q, k, v, g, mask = _inputs(23, S, K, H, D, mask_kind)
    chunk = ta_plan(S, K, H, D, torch.float32, True, backward=True)["chunk"]
    got = _chunked_backward(*map(torch.from_numpy, (g, q, k, v, mask)), chunk)
    want = _jax_vjp(q, k, v, mask, g)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), w, err_msg=name, **GRAD_TOL)
    _check_zeros(*(t.numpy() for t in got), mask)


@pytest.mark.parametrize("case,S,K,H,D,mask_kind", CASES[:4], ids=[c[0] for c in CASES[:4]])
def test_one_chunk_backward_matches_bwd_ref(case, S, K, H, D, mask_kind):
    """At K <= 16 (one chunk, the path's K = 10) the chunked backward is the
    plain version's formulas."""
    q, k, v, g, mask = _inputs(29, S, K, H, D, mask_kind)
    args = list(map(torch.from_numpy, (g, q, k, v, mask)))
    chunk = ta_plan(S, K, H, D, torch.float32, True, backward=True)["chunk"]
    for a, w in zip(_chunked_backward(*args, chunk), temporal_attention_bwd_ref(*args)):
        np.testing.assert_allclose(a.numpy(), w.numpy(), **GRAD_TOL)


# ---------------------------------------------------------------------------
# The launch plan
# ---------------------------------------------------------------------------
PLAN_SHAPES = [(K, H, D) for K in (1, 10, 16, 17, 300) for H, D in
               ((2, 50), (1, 16), (2, 33), (2, 128), (4, 64), (16, 128))]


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ta_plan(backward, dtype):
    esize = 4 if dtype == torch.float32 else 2
    for K, H, D in PLAN_SHAPES:
        for aligned in (True, False):
            p = ta_plan(600, K, H, D, dtype, aligned, backward=backward)
            vec = aligned and (H * D * esize) % 16 == 0
            assert p["vector_bytes"] == (16 if vec else esize)
            assert 1 <= p["chunk"] <= min(K, 16) and p["chunks"] == -(-K // p["chunk"])
            assert p["warp_bytes"] <= TA_MAX_SHARED and p["warp_bytes"] % 16 == 0
            assert p["block_bytes"] == p["warps"] * p["warp_bytes"]
            assert 1 <= p["warps"] <= (8 if backward else 1)
            assert p["blocks"] == -(-600 // p["warps"])
            assert p["block_bytes"] <= TA_DEFAULT_SHARED or p["warps"] == 1
            # One warp's stage holds the chunk's k and v rows.
            assert p["warp_bytes"] >= 2 * p["chunk"] * H * D * esize
    # The path: K = 10 is one chunk, 16-byte copies (400-byte rows).
    path = ta_plan(600, 10, 2, 50, torch.float32, True, backward=backward)
    assert (path["chunk"], path["chunks"], path["vector_bytes"]) == (10, 1, 16)
    assert path["warps"] == (5 if backward else 1)  # 9,392 / 8,912 bytes a warp
    assert ta_plan(600, 300, 2, 50, dtype, True, backward=backward)["chunks"] == 19
    assert ta_plan(0, 10, 2, 50, dtype, True, backward=backward)["blocks"] == 0


def test_ta_plan_halves_the_chunk_of_wide_rows():
    p = ta_plan(4, 64, 16, 512, torch.float32, True)  # 32 KB rows
    assert p["chunk"] == 2 and p["warps"] == 1 and p["block_bytes"] > TA_DEFAULT_SHARED
    with pytest.raises(ValueError, match="too wide"):
        ta_plan(4, 4, 64, 1024, torch.float32, True)
