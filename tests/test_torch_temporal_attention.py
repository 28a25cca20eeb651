"""The port's fused temporal layer (plain version) holds against the JAX op.

Inputs come from a numpy seed and go through both packages: the JAX
``fused_temporal_layer`` in ``mode="interpret"`` (the Pallas kernel body on
the CPU, as ``tests/kernels`` runs it) and in ``mode="ref"``, and the port's
``ops.fused_temporal_layer`` on CPU tensors (its plain version). Tolerance
f32 ``rtol=atol=2e-5`` (``tests/kernels/harness.py``). The CUDA kernel
itself runs only on the card: ``chip_smoke.py`` holds it against the plain
version there.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.temporal_attention import ops as jops
from repro_torch.kernels.temporal_attention import (
    fused_recency_attention,
    fused_recency_attention_kernel,
    fused_temporal_layer,
    fused_temporal_layer_kernel,
)

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, S, K, H, D, N, d_time, d_edge, E=60, neg_seeds=0,
            empty_rows=0, all_masked=False, dup_ids=False):
    """Numpy operands: buffer rows with -1 slots, times before the seeds',
    featureless (-1) edge ids; glorot-magnitude weights."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s, scale=0.25: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    seeds = rng.integers(0, N, S).astype(np.int32)
    if neg_seeds:
        seeds[rng.choice(S, neg_seeds, replace=False)] = -1
    buf = np.stack([rng.integers(-1, N, (N + 1, K)),
                    rng.integers(0, 900, (N + 1, K)),
                    rng.integers(-1, E, (N + 1, K))], -1).astype(np.int32)
    buf[N] = (-1, 0, -1)
    for r in seeds[:empty_rows]:
        buf[max(r, 0), :, 0] = -1
    if dup_ids:
        buf[max(seeds[0], 0), :, 0] = 3
    if all_masked:
        buf[..., 0] = -1
    args = dict(q=f32(S, H, D), k_table=f32(N, H, D), v_table=f32(N, H, D),
                seeds=seeds, seed_times=rng.integers(900, 1000, S).astype(np.int32),
                buf=buf)
    if d_time:
        args.update(time_w=f32(d_time, scale=0.1), time_b=f32(d_time, scale=0.1),
                    wt_k=f32(d_time, H * D), wt_v=f32(d_time, H * D))
    if d_edge:
        args.update(edge_feats=f32(E, d_edge, scale=1.0),
                    we_k=f32(d_edge, H * D), we_v=f32(d_edge, H * D))
    return args


CASES = {
    "time_edge": dict(S=40, K=6, H=2, D=8, N=30, d_time=12, d_edge=10),
    "time_only": dict(S=24, K=5, H=2, D=8, N=30, d_time=12, d_edge=0),
    "edge_only": dict(S=24, K=5, H=1, D=16, N=30, d_time=0, d_edge=10),
    "no_groups": dict(S=24, K=5, H=2, D=8, N=30, d_time=0, d_edge=0),
    "neg_seeds": dict(S=33, K=6, H=2, D=8, N=30, d_time=12, d_edge=10,
                      neg_seeds=9),
    "empty_rows": dict(S=24, K=6, H=2, D=8, N=30, d_time=12, d_edge=10,
                       empty_rows=6),
    "all_masked": dict(S=16, K=4, H=2, D=8, N=20, d_time=12, d_edge=10,
                       all_masked=True),
    "dup_ids": dict(S=16, K=6, H=2, D=8, N=20, d_time=12, d_edge=10,
                    dup_ids=True),
    "k1": dict(S=20, K=1, H=2, D=8, N=20, d_time=12, d_edge=10),
    "s_not_128": dict(S=131, K=3, H=2, D=4, N=40, d_time=6, d_edge=5),
    "quickstart_widths": dict(S=12, K=10, H=2, D=50, N=30, d_time=100,
                              d_edge=172),
}


def _torch(args):
    return {k: torch.from_numpy(v) for k, v in args.items()}


def _jax(args):
    return {k: jnp.asarray(v) for k, v in args.items()}


@pytest.mark.parametrize("jax_mode", ["interpret", "ref"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_temporal_layer_matches_jax(case, jax_mode):
    args = _inputs(11, **CASES[case])
    want = np.asarray(jax.jit(lambda a: jops.fused_temporal_layer(
        **a, block_s=16, mode=jax_mode))(_jax(args)))
    got = fused_temporal_layer(**_torch(args), mode="auto")
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if case in ("neg_seeds", "all_masked"):
        zero = args["seeds"] < 0 if case == "neg_seeds" else slice(None)
        assert (got.numpy()[zero] == 0).all()  # exact zeros, not just small


@pytest.mark.parametrize("jax_mode", ["interpret", "ref"])
@pytest.mark.parametrize("case", ["s37_k20", "empty"])
def test_fused_recency_attention_matches_jax(case, jax_mode):
    args = _inputs(5, S=37, K=20 if case == "s37_k20" else 4, H=2, D=8, N=50,
                   d_time=0, d_edge=0, all_masked=case == "empty")
    ids = np.ascontiguousarray(args["buf"][..., 0])
    qkv = {k: args[k] for k in ("q", "k_table", "v_table", "seeds")}
    want = np.asarray(jax.jit(lambda a, b: jops.fused_recency_attention(
        **a, buf_ids=b, block_s=16, mode=jax_mode))(_jax(qkv), jnp.asarray(ids)))
    got = fused_recency_attention(**_torch(qkv), buf_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_kernel_modes_refuse_cpu_tensors():
    args = _torch(_inputs(0, **CASES["time_edge"]))
    with pytest.raises(ValueError, match="CUDA"):
        fused_temporal_layer(**args, mode="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        fused_temporal_layer_kernel(**args)
    qkv = {k: args[k] for k in ("q", "k_table", "v_table", "seeds")}
    with pytest.raises(ValueError, match="CUDA"):
        fused_recency_attention(**qkv, buf_ids=args["buf"][..., 0].contiguous(),
                                mode="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        fused_recency_attention_kernel(
            **qkv, buf_ids=args["buf"][..., 0].contiguous())
    with pytest.raises(ValueError, match="unknown"):
        fused_temporal_layer(**args, mode="interpret")


def test_ref_mode_forces_the_plain_version():
    args = _torch(_inputs(2, **CASES["time_edge"]))
    np.testing.assert_array_equal(fused_temporal_layer(**args, mode="ref"),
                                  fused_temporal_layer(**args, mode="auto"))


# -- Backward (K2) --------------------------------------------------------
# Gradient tolerance of tests/kernels/harness.py and the JAX package's own
# backward-kernel tests: f32, rtol=atol=1e-4. The time_w gradient sums
# dtheta * dt over every slot (dt up to ~1e3 here, ~2.6e6 on wikipedia), so
# an entry that cancels carries the rounding of its largest terms: it is
# held to 1e-4 of the gradient's largest entry instead.
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _assert_grad_close(got, want, name):
    if name == "time_w":
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name
    else:
        np.testing.assert_allclose(got, want, err_msg=name, **GRAD_TOL)
DIFF = ("q", "k_table", "v_table", "time_w", "time_b", "wt_k", "wt_v",
        "we_k", "we_v")
BWD_CASES = ("time_edge", "neg_seeds", "empty_rows", "all_masked", "dup_ids",
             "time_only", "edge_only", "no_groups", "quickstart_widths")


def _cotangent(args):
    S, H, D = args["q"].shape
    return np.random.default_rng(99).standard_normal((S, H, D)).astype(np.float32)


@pytest.mark.parametrize("case", BWD_CASES)
def test_fused_temporal_layer_bwd_matches_jax(case):
    """The port's plain backward (``fused_temporal_layer_bwd_ref``) and the
    plain autograd of ``fused_temporal_layer`` against the JAX backward
    kernel in interpret mode and ``jax.vjp`` of the JAX ref path, over every
    differentiable operand."""
    from repro.kernels.temporal_attention.kernel import (
        fused_temporal_layer_bwd_kernel as jax_bwd_kernel,
    )
    from repro_torch.kernels.temporal_attention import fused_temporal_layer_bwd_ref

    args = _inputs(13, **CASES[case])
    g = _cotangent(args)
    names = [n for n in DIFF if n in args]

    want_kernel = jax.device_get(jax.jit(lambda a, gg: jax_bwd_kernel(
        gg, **a, block_s=8, interpret=True))(_jax(args), jnp.asarray(g)))

    def jax_ref(diff, rest):
        return jops.fused_temporal_layer(**diff, **rest, mode="ref")

    diff = {n: jnp.asarray(args[n]) for n in names}
    rest = {k: jnp.asarray(v) for k, v in args.items() if k not in names}
    _, vjp = jax.vjp(lambda d: jax_ref(d, rest), diff)
    (want_ref,) = vjp(jnp.asarray(g))

    got_ref = fused_temporal_layer_bwd_ref(torch.from_numpy(g), **_torch(args))
    leaves = {n: torch.from_numpy(args[n]).requires_grad_(True) for n in names}
    out = fused_temporal_layer(**{**_torch(args), **leaves}, mode="auto")
    out.backward(torch.from_numpy(g))

    assert sorted(got_ref) == sorted(names) == sorted(want_kernel)
    for n in names:
        k = np.asarray(want_kernel[n])
        r = np.asarray(want_ref[n])
        _assert_grad_close(got_ref[n].numpy(), k, n)
        _assert_grad_close(leaves[n].grad.numpy(), r, n)
        assert tuple(got_ref[n].shape) == tuple(k.shape), n  # kernel layout
    if case == "neg_seeds":
        assert (got_ref["q"].numpy()[args["seeds"] < 0] == 0).all()
    if case == "all_masked":
        assert all((v == 0).all() for v in got_ref.values())


@pytest.mark.parametrize("case", ["time_edge", "dup_ids"])
def test_autograd_function_saves_only_operands(case, monkeypatch):
    """``_FusedLayerFn`` with the plain versions standing in for its two
    launches: the gradients are plain autograd's, and what it saves for the
    backward is the operands — no (S, K, ...) tensor."""
    from repro_torch.kernels.temporal_attention import (
        fused_temporal_layer_bwd_ref,
        fused_temporal_layer_ref,
        ops,
    )

    monkeypatch.setattr(ops, "_FWD", fused_temporal_layer_ref)
    monkeypatch.setattr(ops, "_BWD", fused_temporal_layer_bwd_ref)
    args = _inputs(17, **CASES[case])
    g = torch.from_numpy(_cotangent(args))
    S, K = args["q"].shape[0], args["buf"].shape[1]
    names = [n for n in DIFF if n in args]

    def run(fn):
        leaves = {n: torch.from_numpy(args[n]).requires_grad_(True)
                  for n in names}
        kw = {**_torch(args), **leaves}
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
            out = fn(kw)
        out.backward(g)
        return out, {n: leaves[n].grad for n in names}, saved

    out, grads, saved = run(lambda kw: ops._FusedLayerFn.apply(
        *(kw.get(name) for name in ops._ARGS)))
    want_out, want, _ = run(lambda kw: fused_temporal_layer(**kw, mode="ref"))
    np.testing.assert_allclose(out.detach().numpy(), want_out.detach().numpy(),
                               **TOL)
    for n in names:
        _assert_grad_close(grads[n].numpy(), want[n].numpy(), n)
    operands = {tuple(v.shape) for v in _torch(args).values()}
    assert saved and set(saved) <= operands
    assert not any(len(s) >= 2 and s[:2] == (S, K) for s in saved)


def test_backward_kernel_refuses_cpu_tensors():
    from repro_torch.kernels.temporal_attention import (
        fused_temporal_layer_bwd_kernel,
    )

    args = _torch(_inputs(0, **CASES["time_edge"]))
    with pytest.raises(ValueError, match="CUDA"):
        fused_temporal_layer_bwd_kernel(torch.zeros_like(args["q"]), **args)
