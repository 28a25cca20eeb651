"""The port's snapshot models hold against the reference's.

The reference draws the parameters (``jax.random``) and the port takes them
through ``repro_torch.convert``; the snapshot edge lists (padded, id 0 and
mask False on padding, ids unsorted), the recurrent state and the cotangents
come from a numpy seed. ``gcn_layer`` and every model's apply are held:
embeddings and the new state within 2e-5 (f32 forward, as
``tests/kernels/harness.py``), the gradients of a fixed linear functional of
both with respect to every parameter within 1e-4 of the leaf's largest
entry. The port runs each model twice: through its plain segment sum and
through the autograd function that wraps the CUDA kernel on the card, with
the plain version standing in for the kernel here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.tg import snapshot as jsnap
from repro.nn.graph_conv import gcn_layer as jax_gcn_layer
from repro_torch.convert import params_from_jax, params_to_numpy, state_from_jax
from repro_torch.kernels.segment_reduce import ops, segment_sum_ref
from repro_torch.models.tg import snapshot
from repro_torch.nn.graph_conv import gcn_layer

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_RTOL = 1e-4
N, CAP, VALID = 24, 32, 21
CFG = dict(num_nodes=N, d_node=16, d_embed=8)


def _edges(seed):
    rng = np.random.default_rng(seed)
    src = np.zeros(CAP, np.int32)
    dst = np.zeros(CAP, np.int32)
    src[:VALID] = rng.integers(0, N, VALID)
    dst[:VALID] = rng.integers(0, N, VALID)
    mask = np.arange(CAP) < VALID
    return src, dst, mask


@pytest.fixture(params=["plain", "function"])
def path(request, monkeypatch):
    """``function``: every segment sum goes through ``_SegmentSumFn`` (the
    kernel path's autograd function), its forward the plain version."""
    if request.param == "function":
        monkeypatch.setattr(ops, "use_kernel", lambda mode, x: True)
        monkeypatch.setattr(ops, "_FWD", segment_sum_ref)
    return request.param


def _assert_grads(want, got):
    def walk(a, b, key=""):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{key}{k}/")
            return
        atol = GRAD_RTOL * float(np.abs(a).max()) + 1e-7
        np.testing.assert_allclose(b, np.asarray(a), rtol=GRAD_RTOL,
                                   atol=atol, err_msg=key)

    walk(jax.device_get(want), params_to_numpy(got))


def test_gcn_layer_matches_jax(path):
    rng = np.random.default_rng(1)
    src, dst, mask = _edges(0)
    x = rng.standard_normal((N, 12)).astype(np.float32)
    cot = rng.standard_normal((N, 6)).astype(np.float32)
    jp = {"lin": {"w": rng.standard_normal((12, 6)).astype(np.float32) * 0.3,
                  "b": rng.standard_normal(6).astype(np.float32) * 0.1}}

    def jloss(p, xx):
        out = jax_gcn_layer(p, xx, jnp.asarray(src), jnp.asarray(dst),
                            jnp.asarray(mask), N)
        return jnp.sum(out * cot), out

    (_, want), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(jp, jnp.asarray(x))
    tp = params_from_jax(jp)
    for leaf in (tp["lin"]["w"], tp["lin"]["b"]):
        leaf.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = gcn_layer(tp, tx, torch.from_numpy(src), torch.from_numpy(dst),
                    torch.from_numpy(mask), N)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)
    (got * torch.from_numpy(cot)).sum().backward()
    _assert_grads(gp, {"lin": {"w": tp["lin"]["w"].grad, "b": tp["lin"]["b"].grad}})
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * float(np.abs(gx).max()))


@pytest.mark.parametrize("name", snapshot.SNAPSHOT_MODELS)
def test_model_apply_and_gradients_match_jax(name, path):
    jcfg = jsnap.SnapshotConfig(**CFG)
    cfg = snapshot.SnapshotConfig(**CFG)
    jparams = jax.device_get(jsnap.init_params(name, jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(2)
    state0 = jax.device_get(jsnap.init_state(name, jcfg))
    state0 = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32) * 0.5, state0)
    src, dst, mask = _edges(4)
    cz = rng.standard_normal((N, CFG["d_embed"])).astype(np.float32)
    cs = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), state0)

    japply = jsnap.make_apply(name, jcfg)

    def jloss(p):
        z, st = japply(p, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask),
                       state0)
        extra = sum(jnp.sum(a * b) for a, b in zip(
            jax.tree_util.tree_leaves(st), jax.tree_util.tree_leaves(cs)))
        return jnp.sum(z * cz) + extra, (z, st)

    (_, (jz, jst)), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)

    tparams = params_from_jax(jparams)
    for leaf in _leaves(tparams):
        leaf.requires_grad_(True)
    tstate = state_from_jax(state0)
    z, st = snapshot.make_apply(name, cfg)(
        tparams, torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(mask), tstate)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz), **FWD_TOL)
    got_state = _tensors(st)
    want_state = [np.asarray(a) for a in jax.tree_util.tree_leaves(jst)]
    assert len(got_state) == len(want_state)
    for a, b in zip(got_state, want_state):
        np.testing.assert_allclose(a.detach().numpy(), b, **FWD_TOL)
    loss = (z * torch.from_numpy(cz)).sum() + sum(
        (a * torch.from_numpy(np.asarray(b))).sum()
        for a, b in zip(got_state, jax.tree_util.tree_leaves(cs)))
    loss.backward()
    # Unused parameters (GCN's decoder here) get zeros, as JAX gives.
    _assert_grads(jgrads, _map(
        lambda t: torch.zeros_like(t) if t.grad is None else t.grad, tparams))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tensors(state):
    return list(state) if isinstance(state, tuple) else [state]


def test_registry_and_padding_match_the_reference():
    cfg = snapshot.SnapshotConfig(**CFG)
    gen = torch.Generator().manual_seed(0)
    for name in snapshot.SNAPSHOT_MODELS:
        ours = snapshot.init_params(name, gen, cfg)
        theirs = jax.device_get(jsnap.init_params(
            name, jax.random.PRNGKey(0), jsnap.SnapshotConfig(**CFG)))
        shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), theirs)
        assert _map(lambda t: tuple(t.shape), ours) == shapes
        assert len(_tensors(snapshot.init_state(name, cfg))) == len(
            jax.tree_util.tree_leaves(jsnap.init_state(name, jsnap.SnapshotConfig(**CFG))))
    with pytest.raises(ValueError, match="unknown DTDG model"):
        snapshot.make_apply("gat", cfg)
    rng = np.random.default_rng(5)
    s, d = rng.integers(0, 9, 40), rng.integers(0, 9, 40)
    for cap in (64, 16):
        for a, b in zip(snapshot.pad_snapshot(s, d, cap),
                        jsnap.pad_snapshot(s, d, cap)):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))
