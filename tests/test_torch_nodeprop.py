"""The port's node property pipelines hold against the reference's.

Both packages run on the ``tiny`` stream with hourly label windows (24
windows, 80 nodes), ``num_cats`` 6 and ``d_embed`` 8, the port on the CPU
(the plain segment sum and the plain classic attention), from the
reference's parameters and optimizer state moved over by
``repro_torch.convert``. Held against the reference:

* the category map and every window's (N, C) label counts, bit for bit;
* ``DTDGNodePipeline`` (GCN, GCLSTM, T-GCN) step by step against the
  reference's own jitted step: the labels scattered on the device
  (bit-equal to a numpy count), the loss (1e-5), every gradient (1e-4 of
  the leaf's largest entry + 1e-7), the carried state and the AdamW
  update; test NDCG@10 within 1e-4;
* ``EventNodePipeline("tgn")`` window by window: the batch (bit-equal), the
  loss, every gradient, the new memory and the AdamW update; NDCG within
  1e-4 at init, after ``run_online`` and after ``NodePropertyTrainer.run``.
  The reference's steps run compiled at XLA's backend optimization level
  0 (``_unfused``): at tiny's time deltas (up to 8.6e4 s) the default
  level fuses the time encoding's ``dt * w + b`` into one FMA (ROADMAP C)
  and moved the new memory by 3.6e-5, where op by op (and at level 0) it
  rounds as the port does. Largest gaps seen: loss 4.8e-7, gradients 0.7%
  of their tolerance, memory 2.1e-7;
* ``pf`` (``evaluate``, ``run_online``) bit for bit; the legacy
  ``NodePropertyTrainer.run`` of ``gcn`` (the reference's scanned epoch)
  within 1e-4;
* checkpoints written by either package restore in the other, bit for bit.

The reference's gradients are read back from its AdamW step's first
moment (``mu' = b1 * mu + (1 - b1) * g``), so each step is the
reference's compiled step, not a copy of its loss. Held within the port:
``compiled=True`` and ``compiled=False`` (one per-pair loop either way)
give the same epoch, and the reference's padding of the seed users with
node 0 (ROADMAP C), whose rows take node 0's labels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import generate as jax_generate
from repro.train import nodeprop as jax_nodeprop
from repro_torch.convert import (
    opt_state_from_jax,
    opt_state_to_numpy,
    params_from_jax,
    params_to_numpy,
    state_from_jax,
)
from repro_torch.data import generate
from repro_torch.train import nodeprop
from repro_torch.train.nodeprop import (
    DTDGNodePipeline,
    EventNodePipeline,
    NodePropertyTrainer,
)

MODELS = ("gcn", "gclstm", "tgcn")
KW = dict(unit="h", num_cats=6, d_embed=8, seed=1)
NDCG_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-7
STATE_TOL = dict(rtol=2e-5, atol=2e-5)
STEPS = 3
TGN_STEPS = 2  # windows 0 and 1 share their bucket shapes: one compile


@pytest.fixture(scope="module")
def jdata():
    return jax_generate("tiny")


@pytest.fixture(scope="module")
def tdata():
    return generate("tiny")


@pytest.fixture(scope="module")
def ref_dtdg(jdata):
    """One reference ``DTDGNodePipeline`` per model, built on first use and
    handed out at its initial parameters, state and split rows.
    ``compiled=False``, so its epochs and scores run the per-pair steps the
    step test compiles."""
    built = {}

    def get(name):
        if name not in built:
            jp = jax_nodeprop.DTDGNodePipeline(name, jdata, compiled=False, **KW)
            built[name] = jp, (jp.params, jp.opt_state, jp.model_state,
                               jp._val_row, jp._test_row)
        jp, (params, opt, state, val_row, test_row) = built[name]
        jp.params, jp.opt_state, jp.model_state = params, opt, state
        jp.set_split_rows(val_row, test_row)
        return jp

    return get


def _unfused(step):
    """Jitted ``step`` compiled per input shape at XLA's backend
    optimization level 0, which contracts no ``a * b + c`` into an FMA:
    the reference then rounds its time encoding as it does op by op."""
    compiled = {}

    def run(*args):
        key = (jax.tree.structure(args),
               tuple((np.shape(x), np.result_type(x)) for x in jax.tree.leaves(args)))
        if key not in compiled:
            compiled[key] = step.lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        return compiled[key](*args)

    return run


@pytest.fixture(scope="module")
def tgn_pair(jdata, tdata):
    """The reference's and the port's ``tgn`` pipelines, the port holding
    the reference's parameters and optimizer state, and a copy of both for
    restarts. One reference pipeline serves every TGN test, its steps
    unfused."""
    jp = jax_nodeprop.EventNodePipeline("tgn", jdata, **KW)
    jp._train_step, jp._predict = _unfused(jp._train_step), _unfused(jp._predict)
    tp = EventNodePipeline("tgn", tdata, device="cpu", **KW)
    _sync(jp, tp, jp.opt)
    return jp, tp, (jp.params, jp.opt)


def _reference_grads(new_opt, old_opt, b1):
    """The gradient of the reference's AdamW step from ``old_opt`` to
    ``new_opt``, read back from the first moment (to a few float32 ulps of
    ``mu'``, far inside GRAD_RTOL)."""
    return jax.tree.map(
        lambda new, old: ((np.asarray(new, np.float64)
                           - b1 * np.asarray(old, np.float64)) / (1 - b1)
                          ).astype(np.float32),
        jax.device_get(new_opt["mu"]), jax.device_get(old_opt["mu"]))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, torch.Tensor):
        return [tree.detach().numpy()]
    return [np.asarray(tree)]


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def _assert_grads_close(want_tree, got_tree):
    for want, got in zip(_leaves(jax.device_get(want_tree)), _leaves(got_tree)):
        atol = GRAD_RTOL * float(np.abs(want).max()) + GRAD_FLOOR
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol)


def _sync(jp, tp, opt):
    """Give the port the reference's parameters and optimizer state."""
    _load(tp, jp.params, opt)


def _load(tp, params, opt):
    tp.load_params(params_from_jax(jax.device_get(params)))
    tp.load_opt_state(opt_state_from_jax(jax.device_get(opt)))


def _dtdg_pair(name, ref_dtdg, tdata):
    jp = ref_dtdg(name)
    tp = DTDGNodePipeline(name, tdata, device="cpu", **KW)
    _sync(jp, tp, jp.opt_state)
    tp.load_model_state(state_from_jax(jax.device_get(jp.model_state)))
    return jp, tp


def _hold_params(jp_params, tp):
    for want, got in zip(_leaves(jax.device_get(jp_params)),
                         _leaves(params_to_numpy(tp.params))):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("unit,num_cats", [("h", 6), ("d", None)])
def test_category_map_and_window_labels_are_bit_equal(jdata, tdata, unit,
                                                      num_cats):
    jc, jcat = jax_nodeprop._category_map(jdata, num_cats)
    tc, tcat = nodeprop._category_map(tdata, num_cats)
    assert jc == tc
    np.testing.assert_array_equal(jcat, tcat)
    jw = jax_nodeprop._window_labels(jdata, jax_nodeprop.TimeDelta.coerce(unit),
                                     jdata.num_nodes, jc, jcat)
    tw = nodeprop._window_labels(tdata, nodeprop.TimeDelta.coerce(unit),
                                 tdata.num_nodes, tc, tcat)
    assert len(jw) == len(tw) > 0
    for (jb, jl), (tb, tl) in zip(jw, tw):
        assert jb.num_events == tb.num_events
        np.testing.assert_array_equal(jb["src"], tb["src"])
        assert jl.dtype == tl.dtype and jl.shape == tl.shape
        np.testing.assert_array_equal(jl, tl)


@pytest.mark.parametrize("name", MODELS)
def test_dtdg_node_steps_and_ndcg_match_the_reference(name, ref_dtdg, tdata):
    """Each step of the reference from its parameters, optimizer state and
    carried state: labels, loss, every gradient, the new state, the AdamW
    update on the reference's gradients; then test NDCG@10."""
    jp, tp = _dtdg_pair(name, ref_dtdg, tdata)
    assert tp._split_pairs("train") == jp._split_pairs("train")
    assert tp._split_pairs("test") == jp._split_pairs("test")
    cat = np.asarray(jp._cat_dev)
    for p in range(STEPS):
        jx, tx = jp._pair_x(p), tp._pair_x(p)
        labels = np.zeros((jp.n, jp.num_cats), np.float32)
        np.add.at(labels, (np.asarray(jx["nsrc"]), cat[np.asarray(jx["ndst"])]),
                  np.asarray(jx["nmask"], np.float32))
        np.testing.assert_array_equal(tp.labels_of(tx).numpy(), labels)
        assert labels.sum() > 0
        (params, opt, state), loss = jp._train_step(jp.params, jp.opt_state,
                                                    jp.model_state, jx)
        grads = _reference_grads(opt, jp.opt_state, jp.opt_cfg.b1)
        _sync(jp, tp, jp.opt_state)
        tp.load_model_state(state_from_jax(jax.device_get(jp.model_state)))
        t_loss, t_state = tp._loss_and_state(tp.params, tp.model_state, tx)
        assert abs(t_loss.item() - float(loss)) <= LOSS_TOL, (p, t_loss, loss)
        _assert_grads_close(grads, params_to_numpy(tp._grads(t_loss)))
        for want, got in zip(_leaves(jax.device_get(state)), _leaves(t_state)):
            np.testing.assert_allclose(got, want, **STATE_TOL)
        tp._update(params_from_jax(grads))
        _hold_params(params, tp)
        jp.params, jp.opt_state, jp.model_state = params, opt, state
    want, _ = jp.evaluate("test")
    got, _ = tp.evaluate("test")
    assert want > 0 and abs(got - want) <= NDCG_TOL, (got, want)


def test_dtdg_compiled_and_per_pair_paths_are_bit_identical(tdata):
    """``compiled`` is accepted for parity with the reference; both values
    run the one per-pair loop, so their epochs and scores are equal."""
    comp = DTDGNodePipeline("gclstm", tdata, compiled=True, device="cpu", **KW)
    loop = DTDGNodePipeline("gclstm", tdata, compiled=False, device="cpu", **KW)
    assert comp.train_epoch()[0] == loop.train_epoch()[0]
    _assert_trees_equal(params_to_numpy(comp.params), params_to_numpy(loop.params))
    _assert_trees_equal(opt_state_to_numpy(comp.opt_state),
                        opt_state_to_numpy(loop.opt_state))
    _assert_trees_equal(comp.model_state, loop.model_state)
    for split in ("val", "test"):
        assert comp.evaluate(split)[0] == loop.evaluate(split)[0]


def test_tgn_window_steps_and_ndcg_match_the_reference(tgn_pair):
    """Window by window, each step of the reference from its parameters and
    memory: the batch, the loss, every gradient, the new memory and the
    AdamW update; then test NDCG@10; then ``run_online`` and
    ``NodePropertyTrainer.run`` of both from the same start."""
    jp, tp, (params0, opt0) = tgn_pair
    jw, tw = jp.windows(), tp.windows()
    jstate = jax_nodeprop.tgn.init_state(jp.cfg)
    for i in range(TGN_STEPS):
        jb = jp._tgn_batch(jw[i][0])
        tb, seed_user = tp._tgn_batch(tw[i][0])
        assert set(jb) == set(tb)
        for k in jb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]),
                                          err_msg=k)
        labels = jnp.asarray(jw[i + 1][1][seed_user])
        active = (labels.sum(-1) > 0).astype(jnp.float32)
        params, opt, new_state, loss = jp._train_step(jp.params, jp.opt, jstate,
                                                      jb, labels, active)
        grads = _reference_grads(opt, jp.opt, jp.opt_cfg.b1)
        _sync(jp, tp, jp.opt)
        tstate = state_from_jax(jax.device_get(jstate))
        logits = tp._embed(tstate, tb) @ tp.params["head"]
        t_loss = nodeprop._soft_cross_entropy(
            logits, tp._put(tp._next_labels(i, seed_user)))
        assert abs(t_loss.item() - float(loss)) <= LOSS_TOL, (i, t_loss, loss)
        _assert_grads_close(grads, params_to_numpy(tp._grads(t_loss)))
        t_new = tp._advance(tstate, tb)
        np.testing.assert_allclose(t_new["memory"].numpy(),
                                   np.asarray(new_state["memory"]), **STATE_TOL)
        np.testing.assert_array_equal(t_new["last_update"].numpy(),
                                      np.asarray(new_state["last_update"]))
        tp._update(params_from_jax(grads))
        _hold_params(params, tp)
        jp.params, jp.opt, jstate = params, opt, new_state
    want, _ = jp.evaluate("test")
    got, _ = tp.evaluate("test")
    assert want > 0 and abs(got - want) <= NDCG_TOL, (got, want)

    # One online pass each from the initial parameters, training the windows
    # stepped above, then the legacy trainer of the port against the
    # reference's pass (its ``run`` is ``run_online``).
    frac = (TGN_STEPS + 1) / len(jw)
    jp.params, jp.opt = params0, opt0
    _load(tp, params0, opt0)
    want, _ = jp.run_online(frac)
    got, _ = tp.run_online(frac)
    assert want > 0 and abs(got - want) <= NDCG_TOL, (got, want)
    trainer = NodePropertyTrainer("tgn", tp.data, device="cpu", **KW)
    assert isinstance(trainer.pipeline, EventNodePipeline)
    _load(trainer.pipeline, params0, opt0)
    got, _ = trainer.run(frac)
    assert abs(got - want) <= NDCG_TOL, (got, want)


def test_pf_matches_the_reference_bit_for_bit(jdata, tdata):
    jp = jax_nodeprop.EventNodePipeline("pf", jdata, **KW)
    tp = EventNodePipeline("pf", tdata, device="cpu", **KW)
    for split in ("train", "val", "test"):
        assert tp.evaluate(split)[0] == jp.evaluate(split)[0]
    for frac in (0.3, 0.7):
        assert tp.run_online(frac)[0] == jp.run_online(frac)[0] > 0
    assert tp.train_epoch()[0] == 0.0
    pf = NodePropertyTrainer("pf", tdata, device="cpu", **KW)
    assert pf.run()[0] == jax_nodeprop.NodePropertyTrainer(
        "pf", jdata, **KW).run()[0]


def test_trainer_run_of_a_snapshot_model_matches_the_reference(ref_dtdg, jdata,
                                                              tdata):
    """The reference trainer runs over the shared reference pipeline (its
    steps compiled already), the port's over its own."""
    jt = jax_nodeprop.NodePropertyTrainer("gcn", jdata, compiled=False, **KW)
    jt._impl = ref_dtdg("gcn")
    tt = NodePropertyTrainer("gcn", tdata, device="cpu", **KW)
    assert isinstance(tt.pipeline, DTDGNodePipeline)
    _sync(jt.pipeline, tt.pipeline, jt.pipeline.opt_state)
    want, _ = jt.run(0.5)
    got, _ = tt.run(0.5)
    assert want > 0 and abs(got - want) <= NDCG_TOL, (got, want)
    assert tt.pipeline._split_pairs("test") == jt.pipeline._split_pairs("test")


def test_checkpoints_cross_between_packages(ref_dtdg, jdata, tdata, tmp_path):
    # DTDG (recurrent state in the bundle): reference -> port -> reference.
    jp, tp = _dtdg_pair("gclstm", ref_dtdg, tdata)
    jp.train_epoch()
    jp.save_checkpoint(str(tmp_path / "jax"), 1)
    assert tp.restore_checkpoint(str(tmp_path / "jax")) == 1
    _assert_trees_equal(jax.device_get(jp.params), params_to_numpy(tp.params))
    _assert_trees_equal(jax.device_get(jp.opt_state),
                        opt_state_to_numpy(tp.opt_state))
    _assert_trees_equal(jax.device_get(jp.model_state), tp.model_state)
    tp.train_epoch()
    tp.save_checkpoint(str(tmp_path / "port"), 2)
    back = jax_nodeprop.DTDGNodePipeline("gclstm", jdata, **KW)
    assert back.restore_checkpoint(str(tmp_path / "port")) == 2
    _assert_trees_equal(params_to_numpy(tp.params), jax.device_get(back.params))
    _assert_trees_equal(tp.model_state, jax.device_get(back.model_state))

    # TGN: port -> reference -> port.
    jt = jax_nodeprop.EventNodePipeline("tgn", jdata, **KW)
    tt = EventNodePipeline("tgn", tdata, device="cpu", **KW)
    _sync(jt, tt, jt.opt)
    tt.train_epoch()
    tt.save_checkpoint(str(tmp_path / "tgn_port"), 3)
    assert jt.restore_checkpoint(str(tmp_path / "tgn_port")) == 3
    _assert_trees_equal(params_to_numpy(tt.params), jax.device_get(jt.params))
    _assert_trees_equal(opt_state_to_numpy(tt.opt_state), jax.device_get(jt.opt))
    jt.save_checkpoint(str(tmp_path / "tgn_jax"), 4)
    fresh = EventNodePipeline("tgn", tdata, device="cpu", **KW)
    assert fresh.restore_checkpoint(str(tmp_path / "tgn_jax")) == 4
    _assert_trees_equal(params_to_numpy(fresh.params), params_to_numpy(tt.params))

    # pf: the stateless marker bundle, both ways.
    jpf = jax_nodeprop.EventNodePipeline("pf", jdata, **KW)
    tpf = EventNodePipeline("pf", tdata, device="cpu", **KW)
    jpf.save_checkpoint(str(tmp_path / "pf_jax"), 5)
    assert tpf.restore_checkpoint(str(tmp_path / "pf_jax")) == 5
    tpf.save_checkpoint(str(tmp_path / "pf_port"), 6)
    assert jpf.restore_checkpoint(str(tmp_path / "pf_port")) == 6


def test_padding_rows_take_node_0_labels(jdata, tdata):
    """The reference pads the seed users with node 0 (time 0, no
    neighbors) and gathers the labels by ``seed_user``, so every padding row
    takes node 0's next-window distribution: on a window where node 0 is
    active next, the padding rows count as active in the loss and NDCG.
    The port keeps that behavior (ROADMAP C)."""
    jp = jax_nodeprop.EventNodePipeline("tgn", jdata, **KW)
    tp = EventNodePipeline("tgn", tdata, device="cpu", **KW)
    tw = tp.windows()
    i = next(i for i in range(len(tw) - 1)
             if tw[i][0].num_events and tw[i + 1][1][0].sum() > 0)
    users = np.unique(tw[i][0]["src"])
    tb, seed_user = tp._tgn_batch(tw[i][0])
    jb = jp._tgn_batch(jp.windows()[i][0])
    np.testing.assert_array_equal(seed_user, np.asarray(jb["seed_user"]))
    pad = np.arange(len(seed_user)) >= len(users)
    assert pad.any() and (seed_user[pad] == 0).all()
    assert (tb["seed_times"].numpy()[pad] == 0).all()
    assert not tb["nbr_mask"].numpy()[pad].any()
    labels = tp._next_labels(i, seed_user)
    np.testing.assert_array_equal(labels[pad], np.broadcast_to(
        tw[i + 1][1][0], labels[pad].shape))
    active = labels.sum(-1) > 0
    share = active[pad].sum() / active.sum()
    # Each padding row is an active row: more than a third of them here.
    assert active[pad].all() and share > 1 / 3, share


def test_experiment_runs_the_node_task_through_trainloop(tdata, tmp_path):
    """``Experiment(task="node").run`` fits through ``TrainLoop`` (its
    checkpoint cadence included) and scores NDCG@10; a fresh pipeline
    restores the checkpoint it wrote."""
    from repro_torch.tg import DataSpec, Experiment, ModelSpec, TrainSpec

    for name in ("tgcn", "tgn"):
        exp = Experiment(task="node", data=DataSpec("tiny", discretization="h"),
                         model=ModelSpec(name, {"num_cats": 6, "d_embed": 8}),
                         train=TrainSpec(epochs=1, ckpt_dir=str(tmp_path / name),
                                         ckpt_every=1, eval_every=1,
                                         eval_split="test"))
        out = exp.run(data=tdata, splits=("val", "test"), device="cpu")
        kind = EventNodePipeline if name == "tgn" else DTDGNodePipeline
        assert isinstance(out["pipeline"], kind)
        assert len(out["history"]["loss"]) == len(out["history"]["ckpts"]) == 1
        assert out["history"]["eval"][0][1] == out["metrics"]["test"] > 0
        fresh = exp.compile(tdata, device="cpu")
        assert fresh.restore_checkpoint(str(tmp_path / name)) == 0
        _assert_trees_equal(params_to_numpy(fresh.params),
                            params_to_numpy(out["pipeline"].params))
