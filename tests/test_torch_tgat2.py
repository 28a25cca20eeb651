"""2-layer TGAT in the port holds against the JAX package.

Numpy-seeded inputs go through both packages:

* the fused layer's hop-2 and per-seed forms (``fused_temporal_layer_hop2``,
  ``fused_temporal_layer_per_seed``): the JAX op in ``mode="interpret"``
  (the Pallas kernel body and its backward kernel on the CPU) and
  ``mode="ref"``, against the port's plain version, forward and every
  gradient, with padded frontiers, rows with no valid slot and frontier
  times before the buffer's (negative deltas);
* ``fused_final_hop_attention`` with the same parameters;
* both hop-2 neighbor hooks, bit for bit over a stream whose buffers wrap;
* 2-layer ``link_scores`` on the classic and the fused path (the reference
  with ``fused="ref"``), with the reference's parameters converted;
* train steps of the 2-layer pipeline on both samplers (loss, every
  gradient), the reference's gradients computed under ``jax.disable_jit()``.

Tolerances from ``tests/kernels/harness.py``: forward float32 2e-5,
gradients 1e-4 (``time_w``'s, and whole-model gradients, of the leaf's
largest entry, plus 1e-7 for the latter, as
``tests/test_torch_temporal_attention.py`` and ``tests/test_torch_train.py``
hold them). The CUDA kernels
run only on the card: ``chip_smoke.py``'s ``tgat2`` phase holds them there.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DGDataLoader as JaxLoader, DGraph as JaxGraph
from repro.core import RECIPE_TGB_LINK as JAX_LINK, RecipeRegistry as JaxRecipes
from repro.core import TRAIN_KEY as JAX_TRAIN_KEY
from repro.data import generate as jax_generate
from repro.kernels.temporal_attention import ops as jops
from repro.models.tg import tgat as jtgat
from repro.models.tg.common import bce_link_loss as jax_bce_link_loss
from repro.nn.attention import fused_final_hop_attention as jax_final_hop
from repro.tg.specs import SamplerSpec as JaxSamplerSpec
from repro.train.loop import CTDGLinkPipeline as JaxPipeline
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import (
    DGDataLoader,
    DGraph,
    RECIPE_TGB_LINK,
    RecipeRegistry,
    TRAIN_KEY,
)
from repro_torch.data import generate
from repro_torch.kernels.temporal_attention import (
    fused_temporal_layer_bwd_ref,
    fused_temporal_layer_hop2,
    fused_temporal_layer_per_seed,
    fused_temporal_layer_ref,
    ops,
)
from repro_torch.models.tg import tgat
from repro_torch.nn.attention import fused_final_hop_attention
from repro_torch.tg.specs import SamplerSpec
from repro_torch.train.loop import CTDGLinkPipeline

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = 1e-4
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-7
LOSS_TOL = 1e-5
DIFF = ("q", "k_table", "v_table", "time_w", "time_b", "wt_k", "wt_v",
        "we_k", "we_v")


def _f32(rng, *shape, scale=0.25):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _groups(rng, H, D, d_time, d_edge, E):
    kw = {}
    if d_time:
        kw.update(time_w=_f32(rng, d_time, scale=0.1),
                  time_b=_f32(rng, d_time, scale=0.1),
                  wt_k=_f32(rng, d_time, H * D), wt_v=_f32(rng, d_time, H * D))
    if d_edge:
        kw.update(edge_feats=_f32(rng, E, d_edge, scale=1.0),
                  we_k=_f32(rng, d_edge, H * D), we_v=_f32(rng, d_edge, H * D))
    return kw


# Hop-2 cases: (S, K) frontier over an (N + 1, K) buffer. ``pad``: the
# share of padded frontier slots; ``empty``: buffer rows with no valid
# slot; ``late``: every frontier time before every buffer time (all deltas
# negative); otherwise frontier and buffer times overlap (mixed signs).
HOP2 = {
    "mixed": dict(S=6, K=4, pad=0.3),
    "mostly_padded": dict(S=6, K=4, pad=0.8),
    "all_padded": dict(S=4, K=3, pad=1.0),
    "empty_rows": dict(S=6, K=4, pad=0.2, empty=8),
    "negative_deltas": dict(S=5, K=4, pad=0.2, late=True),
    "time_only": dict(S=6, K=4, pad=0.3, d_edge=0),
}


def _hop2_inputs(seed, S, K, pad, empty=0, late=False, H=2, D=8, N=20,
                 d_time=12, d_edge=10, E=40):
    rng = np.random.default_rng(seed)
    frontier = rng.integers(0, N, (S, K)).astype(np.int32)
    frontier[rng.random((S, K)) < pad] = -1
    buf = np.stack([rng.integers(-1, N, (N + 1, K)),
                    rng.integers(500, 1000, (N + 1, K)),
                    rng.integers(-1, E, (N + 1, K))], -1).astype(np.int32)
    buf[N] = (-1, 0, -1)
    buf[rng.choice(N, empty, replace=False), :, 0] = -1
    f_times = rng.integers(0, 400 if late else 1200, (S, K)).astype(np.int32)
    args = dict(q=_f32(rng, S * K, H, D), k_table=_f32(rng, N, H, D),
                v_table=_f32(rng, N, H, D), frontier=frontier,
                frontier_times=f_times, buf=buf)
    args.update(_groups(rng, H, D, d_time, d_edge, E))
    return args


def _per_seed_inputs(seed, S=7, K=5, H=2, D=8, d_time=12, d_edge=10, E=40,
                     masked_seeds=(2,), late=True):
    rng = np.random.default_rng(seed)
    mask = rng.random((S, K)) < 0.7
    mask[list(masked_seeds)] = False
    seed_t = rng.integers(500, 1000, S).astype(np.int32)
    # With ``late``, some slots lie after their seed (negative deltas).
    nbr_t = rng.integers(0, 1200 if late else 500, (S, K)).astype(np.int32)
    args = dict(q=_f32(rng, S, H, D), k_rows=_f32(rng, S * K, H, D),
                v_rows=_f32(rng, S * K, H, D), seed_times=seed_t,
                nbr_times=nbr_t, nbr_mask=mask,
                nbr_eids=rng.integers(-1, E, (S, K)).astype(np.int32))
    args.update(_groups(rng, H, D, d_time, d_edge, E))
    return args


def _torch(args):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in args.items()}


def _jax(args):
    return {k: jnp.asarray(v) for k, v in args.items()}


def _diff_names(args, table_names):
    return [n for n in ("q",) + table_names + DIFF[3:] if n in args]


def _cotangent(out_shape, seed=99):
    return np.random.default_rng(seed).standard_normal(out_shape).astype(np.float32)


def _jax_value_and_grads(fn, args, names, g):
    """The JAX op's output and the gradient of sum(out * g) by ``names``."""
    fixed = {k: v for k, v in _jax(args).items() if k not in names}

    def f(diff):
        return jnp.sum(fn(**fixed, **diff) * g)

    diff = {n: jnp.asarray(args[n]) for n in names}
    out = fn(**fixed, **diff)
    return np.asarray(out), {n: np.asarray(v) for n, v in jax.grad(f)(diff).items()}


def _port_value_and_grads(fn, args, names, g):
    leaves = {n: torch.from_numpy(args[n]).requires_grad_(True) for n in names}
    out = fn(**{**_torch(args), **leaves})
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), {n: leaves[n].grad.numpy() for n in names}


def _assert_grads(got, want):
    """Gradients within 1e-4; ``time_w``'s within 1e-4 of its largest entry
    (it sums dtheta * dt over every slot, entries in the hundreds here), as
    ``tests/test_torch_temporal_attention.py`` holds it."""
    for n, w in want.items():
        if n == "time_w":
            assert np.abs(got[n] - w).max() <= GRAD_TOL * np.abs(w).max(), n
        else:
            np.testing.assert_allclose(got[n], w, rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=n)


@pytest.mark.parametrize("jax_mode", ["interpret", "ref"])
@pytest.mark.parametrize("case", sorted(HOP2))
def test_hop2_form_matches_jax(case, jax_mode):
    c = dict(HOP2[case])
    d_edge = c.pop("d_edge", 10)
    args = _hop2_inputs(23, d_edge=d_edge, **c)
    names = _diff_names(args, ("k_table", "v_table"))
    H, D = args["q"].shape[1:]
    g = _cotangent(args["q"].shape)

    def jfn(**kw):
        return jops.fused_temporal_layer_hop2(**kw, block_s=8, mode=jax_mode)

    want, want_g = _jax_value_and_grads(jfn, args, names, g)
    got, got_g = _port_value_and_grads(
        lambda **kw: fused_temporal_layer_hop2(**kw, mode="auto"), args, names, g)
    np.testing.assert_allclose(got, want, **TOL)
    _assert_grads(got_g, want_g)
    pad = args["frontier"].reshape(-1) < 0
    assert (got[pad] == 0).all() and (got_g["q"][pad] == 0).all()
    if case == "all_padded":
        assert all((v == 0).all() for v in got_g.values())


@pytest.mark.parametrize("jax_mode", ["interpret", "ref"])
@pytest.mark.parametrize("case", ["time_edge", "time_only", "no_late_slots"])
def test_per_seed_form_matches_jax(case, jax_mode):
    kw = dict(d_edge=0) if case == "time_only" else {}
    args = _per_seed_inputs(31, late=case != "no_late_slots", **kw)
    if case == "time_only":
        args.pop("nbr_eids")
    names = _diff_names(args, ("k_rows", "v_rows"))
    g = _cotangent(args["q"].shape)

    def jfn(**kw):
        return jops.fused_temporal_layer_per_seed(**kw, block_s=8, mode=jax_mode)

    want, want_g = _jax_value_and_grads(jfn, args, names, g)
    got, got_g = _port_value_and_grads(
        lambda **kw: fused_temporal_layer_per_seed(**kw, mode="auto"),
        args, names, g)
    np.testing.assert_allclose(got, want, **TOL)
    _assert_grads(got_g, want_g)
    # The all-masked seed: a zero row, no gradient into its query or rows.
    S, K = args["nbr_mask"].shape
    assert (got[2] == 0).all() and (got_g["q"][2] == 0).all()
    masked = ~args["nbr_mask"].reshape(-1)
    assert (got_g["k_rows"][masked] == 0).all()
    assert (got_g["v_rows"][masked] == 0).all()


def test_per_seed_form_through_the_autograd_function(monkeypatch):
    """``_FusedLayerFn`` with the plain versions standing in for K1 and K2,
    reached through the per-seed wrapper (an (S * K)-row table over an
    S-row synthetic buffer): the plain version's output and gradients, each
    gradient in its operand's shape."""
    monkeypatch.setattr(ops, "use_kernel", lambda mode, x: mode != "ref")
    monkeypatch.setattr(ops, "_FWD", fused_temporal_layer_ref)
    monkeypatch.setattr(ops, "_BWD", fused_temporal_layer_bwd_ref)
    args = _per_seed_inputs(5)
    names = _diff_names(args, ("k_rows", "v_rows"))
    g = _cotangent(args["q"].shape)
    got, got_g = _port_value_and_grads(
        lambda **kw: fused_temporal_layer_per_seed(**kw, mode="auto"),
        args, names, g)
    want, want_g = _port_value_and_grads(
        lambda **kw: fused_temporal_layer_per_seed(**kw, mode="ref"),
        args, names, g)
    np.testing.assert_allclose(got, want, **TOL)
    for n in names:
        assert got_g[n].shape == args[n].shape, n
    _assert_grads(got_g, want_g)


def _attn_params(rng, d_q, d_kv, d_model):
    def dense(i, o):
        return {"w": _f32(rng, i, o, scale=1 / np.sqrt(i)), "b": _f32(rng, o, scale=0.1)}

    return {"q": dense(d_q, d_model), "k": dense(d_kv, d_model),
            "v": dense(d_kv, d_model), "o": dense(d_model, d_model)}


@pytest.mark.parametrize("use_edges", [True, False], ids=["edges", "no_edges"])
def test_fused_final_hop_attention_matches_jax(use_edges):
    rng = np.random.default_rng(8)
    S, K, d_model, d_time, d_edge, E, H = 6, 4, 16, 12, 10, 30, 2
    params = _attn_params(rng, d_model + d_time, d_model + d_edge + d_time,
                          d_model)
    time_p = {"w": _f32(rng, d_time, scale=0.1), "b": _f32(rng, d_time, scale=0.1)}
    mask = rng.random((S, K)) < 0.7
    mask[1] = False
    args = dict(nbr_kv_in=_f32(rng, S * K, d_model),
                q_in=_f32(rng, S, d_model + d_time),
                seed_times=rng.integers(500, 1000, S).astype(np.int32),
                nbr_times=rng.integers(0, 1200, (S, K)).astype(np.int32),
                nbr_eids=rng.integers(-1, E, (S, K)).astype(np.int32),
                nbr_mask=mask)
    table = _f32(rng, E, d_edge, scale=1.0) if use_edges else None
    want = jax_final_hop(
        jax.tree.map(jnp.asarray, params), **_jax(args),
        time_params=jax.tree.map(jnp.asarray, time_p), d_edge=d_edge,
        edge_table=None if table is None else jnp.asarray(table),
        num_heads=H, mode="ref")
    got = fused_final_hop_attention(
        params_from_jax(params), **_torch(args),
        time_params=params_from_jax(time_p), d_edge=d_edge,
        edge_table=None if table is None else torch.from_numpy(table),
        num_heads=H, mode="auto")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got.shape == (S, d_model)


# ---------------------------------------------------------------------------
# Hooks
# ---------------------------------------------------------------------------
HOOK_B, HOOK_K, HOOK_NEG = 64, 5, 4
HOP2_KEYS = ("nbr2_ids", "nbr2_times", "nbr2_eids", "nbr2_mask", "nbr2_feats")


def _hook_batches(device, key, n_batches=12):
    """Both packages' recipe batches (hop-2) over ``tiny``: 80 nodes, 25
    events each, k = 5, so the buffers wrap many times over."""
    jdata, tdata = jax_generate("tiny"), generate("tiny")
    jm = JaxRecipes.build(JAX_LINK, num_nodes=jdata.num_nodes,
                          spec=JaxSamplerSpec(k=HOOK_K, num_hops=2, device=device),
                          batch_size=HOOK_B, eval_negatives=HOOK_NEG,
                          edge_feats=jdata.edge_feats,
                          edge_feat_dim=jdata.edge_feat_dim)
    tm = RecipeRegistry.build(RECIPE_TGB_LINK, num_nodes=tdata.num_nodes,
                              spec=SamplerSpec(k=HOOK_K, num_hops=2, device=device),
                              batch_size=HOOK_B, eval_negatives=HOOK_NEG,
                              edge_feats=tdata.edge_feats,
                              edge_feat_dim=tdata.edge_feat_dim, device="cpu")
    with jm.activate(key), tm.activate(key):
        pairs = zip(JaxLoader(JaxGraph(jdata), jm, batch_size=HOOK_B),
                    DGDataLoader(DGraph(tdata), tm, batch_size=HOOK_B))
        for _, (jb, tb) in zip(range(n_batches), pairs):
            yield ({k: np.asarray(v) for k, v in jb.as_dict().items()},
                   {k: np.asarray(v) for k, v in tb.as_dict().items()})


@pytest.mark.parametrize("key", ["train", "eval"])
@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_hop2_hooks_are_bit_exact(device, key):
    n = 0
    padded = 0
    for jb, tb in _hook_batches(device, key):
        for name in ("nbr_ids", "nbr_times", "nbr_eids", "nbr_mask") + HOP2_KEYS:
            want, got = jb[name], tb[name]
            assert got.shape == want.shape, name
            if name == "nbr2_feats":
                assert np.array_equal(got, want), name
            else:
                assert np.array_equal(got.astype(np.int64),
                                      want.astype(np.int64)), name
        S = tb["nbr_ids"].size
        assert tb["nbr2_ids"].shape == (S, HOOK_K)
        pad = tb["nbr_ids"].reshape(-1) < 0
        assert (tb["nbr2_ids"][pad] == -1).all()
        assert (tb["nbr2_times"][pad] == 0).all()
        assert (tb["nbr2_eids"][pad] == -1).all()
        assert not tb["nbr2_mask"][pad].any()
        padded += int(pad.sum())
        n += 1
    assert n == 12 and padded > 0


def test_host_and_device_hop2_hooks_agree():
    for (_, host), (_, dev) in zip(_hook_batches(False, "eval", 6),
                                   _hook_batches(True, "eval", 6)):
        for name in HOP2_KEYS:
            assert np.array_equal(host[name], dev[name]), name


def test_one_hop_spec_produces_no_hop2_tensors():
    data = generate("tiny")
    m = RecipeRegistry.build(RECIPE_TGB_LINK, num_nodes=data.num_nodes,
                             spec=SamplerSpec(k=3, num_hops=1, device=True),
                             batch_size=32, eval_negatives=2,
                             edge_feats=data.edge_feats,
                             edge_feat_dim=data.edge_feat_dim, device="cpu")
    with m.activate("train"):
        batch = next(iter(DGDataLoader(DGraph(data), m, batch_size=32)))
    assert not any(k.startswith("nbr2") for k in batch.as_dict())


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
B, NEG, K = 64, 5, 6


@pytest.fixture(scope="module")
def setup():
    data = jax_generate("tiny")
    cfg = jtgat.TGATConfig(num_nodes=data.num_nodes, d_edge=data.edge_feat_dim,
                           k=K)
    assert cfg.num_layers == 2
    params = jtgat.init(jax.random.PRNGKey(5), cfg)
    m = JaxRecipes.build(JAX_LINK, num_nodes=data.num_nodes,
                         spec=JaxSamplerSpec(k=K, num_hops=2, device=True,
                                             expose_buffer=True),
                         batch_size=B, eval_negatives=NEG,
                         edge_feats=data.edge_feats,
                         edge_feat_dim=data.edge_feat_dim)
    with m.activate("eval"):
        batches = [b for _, b in zip(range(8), JaxLoader(JaxGraph(data), m,
                                                         batch_size=B))]
    host = {k: np.asarray(v) for k, v in batches[-1].as_dict().items()}
    return cfg, params, host


def _jax_batch(host):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in host.items()}


def _torch_batch(host):
    return {k: torch.from_numpy(np.array(v, np.int32 if v.dtype == np.int64 else v.dtype))
            for k, v in host.items()}


def test_two_layer_params_convert_to_the_port_tree(setup):
    cfg, params, _ = setup
    tree = jax.device_get(params)
    mine = tgat.init(tgat.TGATConfig(**vars(cfg)), torch.Generator().manual_seed(0))
    back = params_to_numpy(params_from_jax(tree))

    def walk(a, b, c):
        assert set(a) == set(b) == set(c)
        for key in a:
            if isinstance(a[key], dict):
                walk(a[key], b[key], c[key])
            else:
                np.testing.assert_array_equal(np.asarray(a[key]), b[key])
                assert tuple(c[key].shape) == a[key].shape

    walk(tree, back, mine)
    assert {"attn_1", "merge_1"} <= set(mine)


@pytest.mark.parametrize("fused", ["ref", False], ids=["fused", "classic"])
def test_two_layer_link_scores_match_jax(setup, fused):
    cfg, params, host = setup
    assert (host["nbr_ids"] < 0).any()  # padded frontier slots
    jpos, jneg = jtgat.link_scores(params, cfg, _jax_batch(host), B, fused=fused)
    tpos, tneg = tgat.link_scores(params_from_jax(jax.device_get(params)),
                                  tgat.TGATConfig(**vars(cfg)),
                                  _torch_batch(host), B, fused=fused)
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), **TOL)
    np.testing.assert_allclose(tneg.numpy(), np.asarray(jneg), **TOL)


def test_two_layer_fused_and_classic_paths_agree(setup):
    cfg, params, host = setup
    tparams = params_from_jax(jax.device_get(params))
    tcfg = tgat.TGATConfig(**vars(cfg))
    batch = _torch_batch(host)
    fpos, fneg = tgat.link_scores(tparams, tcfg, batch, B)  # auto: fused
    cpos, cneg = tgat.link_scores(tparams, tcfg, batch, B, fused=False)
    np.testing.assert_allclose(fpos.numpy(), cpos.numpy(), **TOL)
    np.testing.assert_allclose(fneg.numpy(), cneg.numpy(), **TOL)


def test_fused_path_reads_no_hop2_features(setup):
    """The fused path gathers edge rows from ``edge_feat_table`` itself: its
    scores are the same bits without ``nbr_feats`` and ``nbr2_feats``."""
    cfg, params, host = setup
    tparams = params_from_jax(jax.device_get(params))
    tcfg = tgat.TGATConfig(**vars(cfg))
    full = _torch_batch(host)
    bare = {k: v for k, v in full.items() if k not in ("nbr_feats", "nbr2_feats")}
    for a, b in zip(tgat.link_scores(tparams, tcfg, full, B),
                    tgat.link_scores(tparams, tcfg, bare, B)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Training steps
# ---------------------------------------------------------------------------
TRAIN_KW = dict(batch_size=200, eval_negatives=5)
TRAIN_K, TRAIN_STEPS = 5, 2


def _pairs(ref, port, prefix=""):
    for k in ref:
        if isinstance(ref[k], dict):
            yield from _pairs(ref[k], port[k], f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(ref[k]), port[k]


@pytest.mark.parametrize("device", [True, False], ids=["device_fused", "host_classic"])
def test_two_layer_train_steps_match_the_reference(device):
    """The first train steps of 2-layer TGAT on ``wikipedia`` (scale 0.01,
    172-dim edge features): from the reference's parameters, the port's
    loss and every gradient against the reference's (fused plain version on
    the device sampler, the classic path on the host sampler)."""
    jfused = "ref" if device else None
    jp = JaxPipeline("tgat", jax_generate("wikipedia", scale=0.01),
                     sampler_spec=JaxSamplerSpec(device=device, k=TRAIN_K),
                     fused=jfused, **TRAIN_KW)
    tp = CTDGLinkPipeline("tgat", generate("wikipedia", scale=0.01),
                          sampler_spec=SamplerSpec(device=device, k=TRAIN_K),
                          device="cpu", **TRAIN_KW)
    assert jp.cfg.num_layers == tp.cfg.num_layers == 2
    tp.load_params(params_from_jax(jax.device_get(jp.params)))

    def value_and_grad(params, bt):
        def loss(p):
            pos, neg = jtgat.link_scores(p, jp.cfg, bt, jp.batch_size,
                                         fused=jfused)
            return jax_bce_link_loss(pos, neg, bt["batch_mask"])
        with jax.disable_jit():  # theta rounded per operation, as the port does
            return jax.value_and_grad(loss)(params)

    jp.reset_epoch_state()
    tp.reset_epoch_state()
    steps = 0
    with jp.manager.activate(JAX_TRAIN_KEY), tp.manager.activate(TRAIN_KEY):
        for jb, tb in zip(jp._loader(jp.train_data), tp._loader(tp.train_data)):
            assert ("nbr_buf" in tb) == device and "nbr2_ids" in tb
            want_loss, want_grads = value_and_grad(jp.params, jp._batch_tensors(jb))
            loss = tp._loss(tb)
            assert abs(loss.item() - float(want_loss)) <= LOSS_TOL, steps
            got = params_to_numpy(tp._grads(loss))
            for key, want, g in _pairs(jax.device_get(want_grads), got):
                atol = GRAD_RTOL * float(np.abs(want).max()) + GRAD_FLOOR
                np.testing.assert_allclose(g, want, rtol=GRAD_RTOL, atol=atol,
                                           err_msg=f"step {steps}: {key}")
            # Both take the reference's step, so the next batch starts level.
            jp.params = jax.tree.map(lambda p, d: p - 1e-3 * d, jp.params,
                                     want_grads)
            tp.load_params(params_from_jax(jax.device_get(jp.params)))
            steps += 1
            if steps == TRAIN_STEPS:
                break
    assert steps == TRAIN_STEPS
