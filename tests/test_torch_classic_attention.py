"""The port's classic attention (K3's plain version) holds against the JAX op.

Inputs come from a numpy seed and go through both packages: the JAX
``temporal_attention`` in ``mode="interpret"`` (the Pallas kernel body on the
CPU, as ``tests/kernels`` runs it) and its jnp oracle
``temporal_attention_ref``, and the port's ``temporal_attention`` on CPU
tensors (its plain version). Tolerances as in ``tests/kernels/harness.py``:
forward f32 2e-5, bf16 2e-2; gradients 1e-4, against ``jax.vjp`` of the
reference's oracle taken op by op (``jax.disable_jit()``). Masked slots and
rows with no valid slot give exact zeros in the output and the gradients.
The CUDA kernels (K3 and its gradient K3b) run only on the card:
``chip_smoke.py`` holds them against the plain versions there
(``classic_kernels`` phase); ``test_torch_classic_attention_bwd.py`` holds
K3b's plain version and the kernels' chunked arithmetic here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels.temporal_attention.ops as tops
from repro.kernels.temporal_attention import ops as jops
from repro.kernels.temporal_attention.ref import (
    temporal_attention_ref as jax_temporal_attention_ref,
)
from repro.nn import attention as jattn
from repro_torch.convert import params_from_jax
from repro_torch.kernels.temporal_attention import (
    temporal_attention,
    temporal_attention_bwd_kernel,
    temporal_attention_bwd_ref,
    temporal_attention_kernel,
    temporal_attention_ref,
)
from repro_torch.nn import attention as tattn

TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)

# (case, S, K, H, D, mask): the path's widths (K = 10, H = 2, D = 50) at a
# small S, the reference's families, and the degenerate inputs.
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


def _inputs(seed, S, K, H, D, mask_kind, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    k = rng.standard_normal((S, K, H, D)).astype(np.float32)
    v = rng.standard_normal((S, K, H, D)).astype(np.float32)
    if mask_kind == "none":
        mask = np.zeros((S, K), bool)
    elif mask_kind == "one":
        mask = np.zeros((S, K), bool)
        mask[np.arange(S), rng.integers(0, K, S)] = True
    else:
        mask = rng.random((S, K)) > 0.4
        if mask_kind == "rows":
            mask[::3] = False
    if dtype != np.float32:  # round through the storage type once
        q, k, v = (np.array(jnp.asarray(x, dtype).astype(jnp.float32))
                   for x in (q, k, v))
    return q, k, v, mask


def _torch(q, k, v, mask, dtype=torch.float32):
    return (torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
            torch.from_numpy(v).to(dtype), torch.from_numpy(mask))


@pytest.mark.parametrize("case,S,K,H,D,mask_kind", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_version_matches_jax_interpret_and_ref(case, S, K, H, D,
                                                     mask_kind):
    q, k, v, mask = _inputs(7, S, K, H, D, mask_kind)
    got = temporal_attention(*_torch(q, k, v, mask)).numpy()
    jargs = tuple(map(jnp.asarray, (q, k, v, mask)))
    want_interp = np.asarray(jops.temporal_attention(*jargs, block_s=32,
                                                     mode="interpret"))
    want_ref = np.asarray(jax_temporal_attention_ref(*jargs))
    np.testing.assert_allclose(got, want_interp, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)
    empty = ~mask.any(-1)
    assert (got[empty] == 0).all()


BF16_CASES = (("s100_k16_bf16", 100, 16, 2, 32), ("s33_k8_bf16", 33, 8, 1, 16),
              ("path_bf16", 60, 10, 2, 50))


@pytest.mark.parametrize("case,S,K,H,D", BF16_CASES,
                         ids=[c[0] for c in BF16_CASES])
def test_bf16_matches_jax(case, S, K, H, D):
    q, k, v, mask = _inputs(11, S, K, H, D, "random", dtype=jnp.bfloat16)
    got = temporal_attention(*_torch(q, k, v, mask, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    jargs = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)] + [jnp.asarray(mask)]
    want = jops.temporal_attention(*jargs, block_s=32, mode="interpret")
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **BF16_TOL)


def test_zero_seeds():
    q, k, v, mask = _inputs(3, 0, 10, 2, 50, "random")
    got = temporal_attention(*_torch(q, k, v, mask))
    assert tuple(got.shape) == (0, 2, 50)
    want = jax_temporal_attention_ref(*map(jnp.asarray, (q, k, v, mask)))
    assert tuple(want.shape) == (0, 2, 50)


def _jax_vjp(q, k, v, mask, g):
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda a, b, c: jax_temporal_attention_ref(
            a, b, c, jnp.asarray(mask)), *map(jnp.asarray, (q, k, v)))
        return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("mask_kind", ["random", "rows", "one", "none"])
def test_function_backward_matches_jax_grad(monkeypatch, mask_kind):
    """``_TemporalAttentionFn`` with the plain versions standing in for the
    kernel launches (K3's and K3b's): its backward against ``jax.vjp`` of
    the reference's oracle, with exact zeros on masked slots and empty
    rows."""
    monkeypatch.setattr(tops, "_TA_FWD", temporal_attention_ref)
    monkeypatch.setattr(tops, "_TA_BWD", temporal_attention_bwd_ref)
    S, K, H, D = 33, 8, 2, 16
    q, k, v, mask = _inputs(5, S, K, H, D, mask_kind)
    g = np.random.default_rng(6).standard_normal((S, H, D)).astype(np.float32)
    tq, tk, tv, tm = _torch(q, k, v, mask)
    leaves = [t.requires_grad_(True) for t in (tq, tk, tv)]
    out = tops._TemporalAttentionFn.apply(*leaves, tm)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(
        jax_temporal_attention_ref(*map(jnp.asarray, (q, k, v, mask)))), **TOL)
    out.backward(torch.from_numpy(g))
    want = _jax_vjp(q, k, v, mask, g)
    for name, t, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), w, err_msg=name, **GRAD_TOL)
    empty = ~mask.any(-1)
    assert (tq.grad.numpy()[empty] == 0).all()
    assert (tk.grad.numpy()[~mask] == 0).all()
    assert (tv.grad.numpy()[~mask] == 0).all()


def test_plain_autograd_matches_the_function(monkeypatch):
    """On the CPU ``temporal_attention`` differentiates the plain version
    directly; it gives the Function's gradients (K3b's formulas, by their
    plain version) within the gradient tolerance, with the same exact
    zeros."""
    monkeypatch.setattr(tops, "_TA_FWD", temporal_attention_ref)
    monkeypatch.setattr(tops, "_TA_BWD", temporal_attention_bwd_ref)
    q, k, v, mask = _inputs(9, 20, 10, 2, 50, "rows")
    g = torch.from_numpy(
        np.random.default_rng(2).standard_normal((20, 2, 50)).astype(np.float32))
    grads = []
    for fn in (lambda *a: temporal_attention(*a),
               lambda *a: tops._TemporalAttentionFn.apply(*a)):
        tq, tk, tv, tm = _torch(q, k, v, mask)
        leaves = [t.requires_grad_(True) for t in (tq, tk, tv)]
        fn(*leaves, tm).backward(g)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)
    masked, empty = torch.from_numpy(~mask), torch.from_numpy(~mask.any(-1))
    for dq, dk, dv in grads:
        assert bool((dq[empty] == 0).all())
        assert bool((dk[masked] == 0).all()) and bool((dv[masked] == 0).all())


def test_dispatch_modes():
    q, k, v, mask = _torch(*_inputs(1, 8, 4, 2, 16, "random"))
    want = temporal_attention_ref(q, k, v, mask)
    assert torch.equal(temporal_attention(q, k, v, mask, mode="auto"), want)
    assert torch.equal(temporal_attention(q, k, v, mask, mode="ref"), want)
    with pytest.raises(ValueError, match="CUDA"):
        temporal_attention(q, k, v, mask, mode="kernel")
    with pytest.raises(ValueError, match="unknown"):
        temporal_attention(q, k, v, mask, mode="interpret")
    with pytest.raises(ValueError, match="CUDA"):
        temporal_attention_kernel(q, k, v, mask)
    with pytest.raises(ValueError, match="CUDA"):
        temporal_attention_bwd_kernel(q, q, k, v, mask)


@pytest.mark.parametrize("mask_kind", ["random", "rows"])
def test_seed_neighbor_attention_matches_jax(mask_kind):
    S, K, Dq, Dkv, d_model, heads = 48, 10, 200, 372, 100, 2
    jparams = jattn.mha_init(jax.random.PRNGKey(4), Dq, Dkv, d_model, heads)
    rng = np.random.default_rng(8)
    seed_feat = rng.standard_normal((S, Dq)).astype(np.float32)
    nbr_feat = rng.standard_normal((S, K, Dkv)).astype(np.float32)
    _, _, _, mask = _inputs(8, S, K, 1, 1, mask_kind)
    want = jattn.seed_neighbor_attention(jparams, jnp.asarray(seed_feat),
                                         jnp.asarray(nbr_feat),
                                         jnp.asarray(mask), num_heads=heads)
    tparams = params_from_jax(jax.device_get(jparams))
    args = (tparams, torch.from_numpy(seed_feat), torch.from_numpy(nbr_feat),
            torch.from_numpy(mask))
    got = tattn.seed_neighbor_attention(*args, num_heads=heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # mha itself stays the plain multi-query attention; both agree.
    via_mha = tattn.mha(tparams, args[1][:, None, :], args[2],
                        args[3][:, None, :], num_heads=heads)[:, 0, :]
    np.testing.assert_allclose(got.numpy(), via_mha.numpy(), **TOL)
