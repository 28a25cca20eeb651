"""The reference's default CTDG path in the port: the host recency sampler,
the classic attention, and TGN with its memory, against the JAX pipeline.

The quickstart spec exactly as ``examples/quickstart.py`` writes it
(``SamplerSpec(kind="recency", k=10)``: the host ``RecencySampler``, so the
batch carries no packed buffer and the models take the classic path) runs
in both packages on synthetic ``wikipedia`` at ``scale=0.01``, the port on
the CPU, both from the reference's parameters. Held:

* the host hook's batches, bit for bit, against the reference's host hook
  and against the port's device sampler (the reference promises the two
  samplers' neighborhoods agree);
* val MRR within 1e-4 (TGAT and TGN; TGN's memory is warmed through the
  train split, and through val for the test split);
* TGN step by step on both samplers (training is chaotic here, see
  ``tests/test_torch_train.py``): from the reference's parameters, optimizer
  and memory, the loss (1e-5), every gradient (1e-4 of the leaf's largest
  entry plus 1e-7; the reference's gradients taken op by op under
  ``jax.disable_jit()``), the GRU's gradients exactly zero in both (no
  gradient reaches the memory update), the new memory (2e-5) and
  ``last_update`` (bit-exact), and one AdamW update on the reference's
  gradients;
* checkpoints with ``model_state`` and the host sampler's state restore
  across both packages, bit for bit.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.core import TRAIN_KEY as JAX_TRAIN_KEY
from repro.data import generate as jax_generate
from repro.models.tg import tgn as jax_tgn
from repro.models.tg.common import bce_link_loss as jax_bce_link_loss
from repro.models.tg.common import split_seeds as jax_split_seeds
from repro.optim import adamw_update as jax_adamw_update
from repro.tg import DataSpec as JaxDataSpec, Experiment as JaxExperiment
from repro.tg import ModelSpec as JaxModelSpec, TrainSpec as JaxTrainSpec
from repro.tg.specs import SamplerSpec as JaxSamplerSpec
from repro.train.loop import CTDGLinkPipeline as JaxPipeline
from repro_torch.convert import (
    opt_state_from_jax,
    opt_state_to_numpy,
    params_from_jax,
    params_to_numpy,
    state_from_jax,
)
from repro_torch.core import TRAIN_KEY
from repro_torch.core.tg_hooks import RecencyNeighborHook
from repro_torch.data import generate
from repro_torch.tg import DataSpec, Experiment, ModelSpec, SamplerSpec, TrainSpec
from repro_torch.train.loop import CTDGLinkPipeline

MRR_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-7
MEM_TOL = dict(rtol=2e-5, atol=2e-5)
PARITY_STEPS = 6
TGN_KW = dict(batch_size=200, eval_negatives=20)


def _quickstart(pkg):
    """The quickstart's specs in either package (scale cut to 0.01)."""
    D, M, S, T, E = pkg
    return E(data=D("wikipedia", scale=0.01), model=M("tgat", {"num_layers": 1}),
             sampler=S(kind="recency", k=10),
             train=T(epochs=2, batch_size=200, eval_negatives=20), task="link")


JAX_SPECS = (JaxDataSpec, JaxModelSpec, JaxSamplerSpec, JaxTrainSpec, JaxExperiment)
PORT_SPECS = (DataSpec, ModelSpec, SamplerSpec, TrainSpec, Experiment)


def _sync(jp, tp):
    """Give the port the reference's parameters, optimizer and model state."""
    tp.load_params(params_from_jax(jax.device_get(jp.params)))
    tp.load_opt_state(opt_state_from_jax(jax.device_get(jp.opt_state)))
    if tp.stateful:
        tp.load_model_state(state_from_jax(jax.device_get(jp.model_state)))


@pytest.fixture(scope="module")
def quickstart():
    jp = _quickstart(JAX_SPECS).compile()
    tp = _quickstart(PORT_SPECS).compile(device="cpu")
    _sync(jp, tp)
    return jp, tp


def test_quickstart_compiles_to_the_host_sampler(quickstart):
    _, tp = quickstart
    hooks = [h for h in tp.manager.hooks() if isinstance(h, RecencyNeighborHook)]
    assert len(hooks) == 1 and not tp.sampler_spec.device
    tp.reset_epoch_state()
    with tp.manager.activate(TRAIN_KEY):
        batch = next(iter(tp._loader(tp.train_data)))
    assert "nbr_buf" not in batch
    for key in ("seed_nodes", "nbr_ids", "nbr_times", "nbr_eids", "nbr_mask",
                "nbr_feats"):
        assert isinstance(batch[key], torch.Tensor), key


@pytest.mark.parametrize("key", ["train", "eval"])
def test_host_hook_batches_match_the_reference_and_the_device_sampler(
        quickstart, key):
    jp, tp = quickstart
    dev = CTDGLinkPipeline("tgat", tp.data, sampler_spec=SamplerSpec(k=10, device=True),
                           model_kwargs={"num_layers": 1}, device="cpu", **TGN_KW)
    for p in (jp, tp, dev):
        p.reset_epoch_state()
    with jp.manager.activate(key), tp.manager.activate(key), \
            dev.manager.activate(key):
        for _, jb, tb, db in zip(range(4), jp._loader(jp.train_data),
                                 tp._loader(tp.train_data),
                                 dev._loader(dev.train_data)):
            assert set(tb.keys()) == set(jb.keys())
            for name in jb.keys():
                want = np.asarray(jb[name])
                if want.dtype == np.int64:
                    want = want.astype(np.int32)  # staged as int32 in both
                got = tb[name].numpy()
                assert got.dtype == want.dtype, name
                np.testing.assert_array_equal(got, want, err_msg=name)
            for name in ("seed_nodes", "seed_times", "nbr_ids", "nbr_times",
                         "nbr_eids", "nbr_mask", "nbr_feats"):
                np.testing.assert_array_equal(tb[name].numpy(),
                                              db[name].numpy(), err_msg=name)
    a, b = jp.manager.state_dict(), tp.manager.state_dict()
    assert sorted(a) == sorted(b)
    for group in a:
        for leaf in a[group]:
            np.testing.assert_array_equal(np.asarray(a[group][leaf]),
                                          b[group][leaf], err_msg=leaf)


def test_quickstart_val_mrr_matches_jax(quickstart):
    jp, tp = quickstart
    want, _ = jp.evaluate("val")
    got, _ = tp.evaluate("val")
    assert abs(got - want) <= MRR_TOL, (got, want)
    # The plain version of the classic attention, forced, ranks alike.
    tp.fused = "ref"
    try:
        plain, _ = tp.evaluate("val")
    finally:
        tp.fused = None
    assert plain == got


@pytest.fixture(scope="module", params=[False, True], ids=["host", "device"])
def tgn_pair(request):
    device = request.param
    jp = JaxPipeline("tgn", jax_generate("wikipedia", scale=0.01),
                     sampler_spec=JaxSamplerSpec(k=10, device=device),
                     fused="ref" if device else None, **TGN_KW)
    tp = CTDGLinkPipeline("tgn", generate("wikipedia", scale=0.01),
                          sampler_spec=SamplerSpec(k=10, device=device),
                          device="cpu", **TGN_KW)
    _sync(jp, tp)
    return jp, tp


def _pairs(ref, port, prefix=""):
    for k in ref:
        if isinstance(ref[k], dict):
            yield from _pairs(ref[k], port[k], f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(ref[k]), port[k]


def test_tgn_steps_match_the_reference(tgn_pair):
    jp, tp = tgn_pair
    fused = jp.fused

    def value_and_grad(params, state, bt):
        def loss(p):
            (pos, neg), new = jax_tgn.link_scores(p, jp.cfg, state, bt,
                                                  jp.batch_size, fused=fused)
            return jax_bce_link_loss(pos, neg, bt["batch_mask"]), new
        with jax.disable_jit():  # theta rounded per operation, as the port
            return jax.value_and_grad(loss, has_aux=True)(params)

    jp.reset_epoch_state()
    tp.reset_epoch_state()
    with jp.manager.activate(JAX_TRAIN_KEY), tp.manager.activate(TRAIN_KEY):
        for step, jb, tb in zip(range(PARITY_STEPS), jp._loader(jp.train_data),
                                tp._loader(tp.train_data)):
            bt = jp._batch_tensors(jb)
            (want_loss, want_state), want_grads = value_and_grad(
                jp.params, jp.model_state, bt)
            _sync(jp, tp)
            loss, new_state = tp._loss_and_state(tb)
            assert abs(loss.item() - float(want_loss)) <= LOSS_TOL, step
            grads = params_to_numpy(tp._grads(loss))
            for key, want, got in _pairs(jax.device_get(want_grads), grads):
                atol = GRAD_RTOL * float(np.abs(want).max()) + GRAD_FLOOR
                np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol,
                                           err_msg=f"step {step} {key}")
                if key.startswith("gru/"):
                    assert not want.any() and not got.any(), key
            np.testing.assert_array_equal(new_state["last_update"].numpy(),
                                          np.asarray(want_state["last_update"]))
            np.testing.assert_allclose(new_state["memory"].numpy(),
                                       np.asarray(want_state["memory"]),
                                       **MEM_TOL)

            # One AdamW step of each package on the reference's gradients.
            jp.params, jp.opt_state = jax_adamw_update(
                jp.params, want_grads, jp.opt_state, jp.opt_cfg)
            jp.model_state = want_state
            tp._update(params_from_jax(jax.device_get(want_grads)))
            want_opt = jax.device_get(jp.opt_state)
            got_opt = opt_state_to_numpy(tp.opt_state)
            assert int(got_opt["step"]) == int(want_opt["step"]) == step + 1
            for key, w, g in _pairs(jax.device_get(jp.params),
                                    params_to_numpy(tp.params)):
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                           err_msg=f"step {step} {key}")
    assert step == PARITY_STEPS - 1


def test_tgn_train_step_threads_the_state(tgn_pair):
    """``_train_step`` moves the state to the batch's update and leaves no
    autograd graph on it; the GRU parameters do not move under AdamW with
    zero gradients beyond its weight decay."""
    _, tp = tgn_pair
    tp.reset_epoch_state()
    with tp.manager.activate(TRAIN_KEY):
        batch = next(iter(tp._loader(tp.train_data)))
        _, want = tp._loss_and_state(batch)
        tp._train_step(batch)
    assert torch.equal(tp.model_state["last_update"], want["last_update"])
    assert torch.equal(tp.model_state["memory"], want["memory"])
    assert not tp.model_state["memory"].requires_grad
    assert int((tp.model_state["last_update"] > 0).sum()) > 0


def _exact_ties(params, h, batch_size):
    """The reference's ``link_logits`` with the port's tie rule: a negative
    whose embedding equals the positive destination's takes the positive's
    logit (ROADMAP C, "MRR ties"). TGN at this scale (90 nodes, 20
    negatives) draws ~40 such negatives per val batch, and the reference's
    two decoder passes round them apart: 1e-3 of MRR."""
    pos, neg = _JAX_LINK_LOGITS(params, h, batch_size)
    h_src, h_dst, h_neg = jax_split_seeds(h, batch_size)
    same = (h_neg == h_dst[:, None]).all(-1)
    return pos, jax.numpy.where(same, pos[:, None], neg)


_JAX_LINK_LOGITS = jax_tgn.link_logits


@pytest.mark.parametrize("split", ["val", "test"])
def test_tgn_evaluate_matches_jax(tgn_pair, split, monkeypatch):
    jp, tp = tgn_pair
    _sync(jp, tp)
    monkeypatch.setattr(jax_tgn, "link_logits", _exact_ties)
    # Op by op (the patched decoder is read at call time, and theta is
    # rounded per operation as in the port: under jit XLA fuses the memory
    # update's dt * w + b, with dt up to ~1e6 s, into one multiply-add).
    with jax.disable_jit():
        want, _ = jp.evaluate(split)
    got, _ = tp.evaluate(split)
    assert abs(got - want) <= MRR_TOL, (got, want)
    np.testing.assert_array_equal(tp.model_state["last_update"].numpy(),
                                  np.asarray(jp.model_state["last_update"]))
    np.testing.assert_allclose(tp.model_state["memory"].numpy(),
                               np.asarray(jp.model_state["memory"]), **MEM_TOL)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().numpy()
    return {prefix[:-1]: np.asarray(tree)}


def _assert_same_state(jp, tp):
    for name, want, got in (
            ("params", jax.device_get(jp.params), params_to_numpy(tp.params)),
            ("opt", jax.device_get(jp.opt_state), opt_state_to_numpy(tp.opt_state)),
            ("model_state", jax.device_get(jp.model_state), tp.model_state),
            ("hooks", jp.manager.state_dict(), tp.manager.state_dict())):
        want, got = _flat(want), _flat(got)
        assert sorted(want) == sorted(got), name
        for k in want:
            assert got[k].dtype == want[k].dtype, (name, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}/{k}")


def test_tgn_checkpoints_cross_both_ways(tgn_pair, tmp_path):
    jp, tp = tgn_pair
    _sync(jp, tp)
    jp.train_epoch()
    jp.save_checkpoint(str(tmp_path / "ref"), 2)
    assert tp.restore_checkpoint(str(tmp_path / "ref")) == 2
    _assert_same_state(jp, tp)
    assert tp.model_state["last_update"].dtype == torch.int32

    tp.train_epoch()
    tp.save_checkpoint(str(tmp_path / "port"), 3)
    assert jp.restore_checkpoint(str(tmp_path / "port")) == 3
    _assert_same_state(jp, tp)
    assert int(np.asarray(jp.model_state["last_update"]).max()) > 0
