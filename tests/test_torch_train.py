"""The port's training slice holds against the JAX pipeline.

Both ``CTDGLinkPipeline``s run the quickstart: 1-layer TGAT over the device
recency sampler (k=10), batch 200, 20 eval negatives, synthetic
``wikipedia`` at ``scale=0.01``. The reference runs ``fused="ref"`` (its
plain fused path on the CPU), the port ``device="cpu"`` (the plain version
of its kernels); both start from the reference's parameters and AdamW state
(``repro_torch.convert``).

Training is chaotic in this model, so two epochs that run freely cannot be
held to float32 rounding: ``theta = dt * w + b`` multiplies the Bochner
frequencies by time deltas up to ~1e6 s, an ulp of ``w`` moves ``theta``
by ~0.1 rad, and AdamW turns a gradient entry near zero into a full-size
step of either sign. In the reference itself, scaling the initial
parameters by (1 + 1e-7) moves the third step's loss by ~5e-4, an epoch's
mean loss by ~3e-3 and val MRR after two epochs by ~8e-3 (measured on the
CPU at this configuration). So the dynamics are held step by step: before
each step the port takes the reference's parameters and optimizer state,
and its loss and every gradient must match the reference's, computed op by
op so that theta is rounded per operation on both sides (float32, sums
in another order: loss 1e-5, gradients 1e-4 of the leaf's largest entry
plus 1e-7 for the gradients that are zero in exact arithmetic, such as the
key bias, which softmax ignores); its AdamW step on the reference's
gradients must match the reference's update. After the two epochs both
hold the same trained parameters and val MRR agrees within 1e-4 (the
tolerance of ``tests/test_torch_pipeline.py``). Free-running epochs through
``TrainLoop.fit`` are held to the reference's own spread (1e-2 in an
epoch's mean loss).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TRAIN_KEY as JAX_TRAIN_KEY
from repro.data import generate as jax_generate
from repro.models.tg import tgat as jax_tgat
from repro.models.tg.common import bce_link_loss as jax_bce_link_loss
from repro.optim import adamw_update as jax_adamw_update
from repro.tg.specs import SamplerSpec as JaxSamplerSpec
from repro.train.loop import CTDGLinkPipeline as JaxPipeline
from repro.train.loop import TrainLoop as JaxTrainLoop
from repro_torch.convert import (
    opt_state_from_jax,
    opt_state_to_numpy,
    params_from_jax,
    params_to_numpy,
)
from repro_torch.core import TRAIN_KEY
from repro_torch.data import generate
from repro_torch.obs import validate
from repro_torch.tg import DataSpec, Experiment, ModelSpec, SamplerSpec, TrainSpec
from repro_torch.train.loop import CTDGLinkPipeline, TrainLoop

KW = dict(batch_size=200, eval_negatives=20, model_kwargs={"num_layers": 1})
EPOCHS = 2
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-7
MRR_TOL = 1e-4
FREE_EPOCH_LOSS_TOL = 1e-2


def _pair():
    jp = JaxPipeline("tgat", jax_generate("wikipedia", scale=0.01),
                     sampler_spec=JaxSamplerSpec(device=True, k=10),
                     fused="ref", **KW)
    tp = CTDGLinkPipeline("tgat", generate("wikipedia", scale=0.01),
                          sampler_spec=SamplerSpec(device=True, k=10),
                          device="cpu", **KW)
    _sync(jp, tp)
    return jp, tp


def _sync(jp, tp):
    """Give the port the reference's parameters and optimizer state."""
    tp.load_params(params_from_jax(jax.device_get(jp.params)))
    tp.load_opt_state(opt_state_from_jax(jax.device_get(jp.opt_state)))


def _pairs(ref, port, prefix=""):
    """(key, reference array, port array) over two parameter-shaped trees."""
    for k in ref:
        if isinstance(ref[k], dict):
            yield from _pairs(ref[k], port[k], f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(ref[k]), port[k]


def _assert_grads_close(ref, port):
    for key, want, got in _pairs(ref, params_to_numpy(port)):
        atol = GRAD_RTOL * float(np.abs(want).max()) + GRAD_FLOOR
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=key)


def test_training_matches_the_reference_step_by_step():
    jp, tp = _pair()

    def value_and_grad(params, bt):
        def loss(p):
            pos, neg = jax_tgat.link_scores(p, jp.cfg, bt, jp.batch_size,
                                            fused="ref")
            return jax_bce_link_loss(pos, neg, bt["batch_mask"])
        # Op by op: under jit, XLA's CPU compiler contracts dt * w + b into
        # one fused multiply-add, which moves theta by up to ~0.03 rad at
        # these time deltas; op by op the reference rounds theta per
        # operation, as the port's plain version and its kernels do.
        with jax.disable_jit():
            return jax.value_and_grad(loss)(params)

    steps = 0
    for _ in range(EPOCHS):
        jp.reset_epoch_state()
        tp.reset_epoch_state()
        with jp.manager.activate(JAX_TRAIN_KEY), tp.manager.activate(TRAIN_KEY):
            for jb, tb in zip(jp._loader(jp.train_data),
                              tp._loader(tp.train_data)):
                bt = jp._batch_tensors(jb)
                want_loss, want_grads = value_and_grad(jp.params, bt)
                _sync(jp, tp)
                loss = tp._loss(tb)
                assert abs(loss.item() - float(want_loss)) <= LOSS_TOL, steps
                _assert_grads_close(jax.device_get(want_grads), tp._grads(loss))

                # One AdamW step of each package on the reference's gradients.
                jp.params, jp.opt_state = jax_adamw_update(
                    jp.params, want_grads, jp.opt_state, jp.opt_cfg)
                tp._update(params_from_jax(jax.device_get(want_grads)))
                want = jax.device_get(jp.opt_state)
                got = opt_state_to_numpy(tp.opt_state)
                assert int(got["step"]) == int(want["step"]) == steps + 1
                for name in ("mu", "nu"):
                    for key, w, g in _pairs(want[name], got[name]):
                        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-12,
                                                   err_msg=f"{name}/{key}")
                for key, w, g in _pairs(jax.device_get(jp.params),
                                        params_to_numpy(tp.params)):
                    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-8,
                                               err_msg=key)
                steps += 1
    assert steps == EPOCHS * 6  # ceil(1,103 train events / 200) a epoch

    # Both hold the trained parameters: val MRR agrees.
    _sync(jp, tp)
    want, _ = jp.evaluate("val")
    got, _ = tp.evaluate("val")
    assert abs(got - want) <= MRR_TOL, (got, want)


def test_free_running_epochs_through_train_loop():
    jp, tp = _pair()
    want = JaxTrainLoop(jp).fit(epochs=EPOCHS, eval_every=EPOCHS)
    got = TrainLoop(tp).fit(epochs=EPOCHS, eval_every=EPOCHS)
    assert len(got["loss"]) == EPOCHS and got["ckpts"] == []
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                               atol=FREE_EPOCH_LOSS_TOL)
    assert [e for e, _ in got["eval"]] == [EPOCHS - 1]
    assert 0.0 < got["eval"][0][1] <= 1.0
    assert int(tp.opt_state["step"]) == int(jp.opt_state["step"]) == 6 * EPOCHS


def test_experiment_run_trains_checkpoints_and_records(tmp_path):
    """``Experiment.run`` end to end on the CPU: epochs through
    ``TrainLoop``, a checkpoint per epoch, telemetry as JSONL records that
    the history is rebuilt from."""
    log = tmp_path / "run.jsonl"
    exp = Experiment(
        data=DataSpec("tiny"), model=ModelSpec("tgat", {"num_layers": 1}),
        sampler=SamplerSpec(kind="recency", k=4, device=True),
        train=TrainSpec(epochs=2, batch_size=100, eval_negatives=5,
                        eval_every=1, ckpt_dir=str(tmp_path / "ck"),
                        ckpt_every=1, telemetry=str(log), lr=1e-3))
    out = exp.run(device="cpu", splits=("val", "test"))
    hist = out["history"]
    assert len(hist["loss"]) == 2 and all(np.isfinite(hist["loss"]))
    assert [e for e, _ in hist["eval"]] == [0, 1]
    assert [p.rsplit("_", 1)[1] for p in hist["ckpts"]] == ["0", "1"]
    assert set(out["metrics"]) == {"val", "test"}
    assert all(0.0 < m <= 1.0 for m in out["metrics"].values())
    pipe = out["pipeline"]
    assert pipe.opt_cfg.lr == 1e-3 and int(pipe.opt_state["step"]) > 0
    records = [validate(json.loads(line)) for line in log.read_text().splitlines()]
    names = {r["name"] for r in records if r["kind"] == "span"}
    assert {"train/epoch", "train/eval", "train/ckpt", "ctdg/epoch",
            "ctdg/step", "loader/stage", "ctdg/eval"} <= names
    epochs = [r["attrs"]["loss"] for r in records if r.get("name") == "train/epoch"]
    assert epochs == hist["loss"]


@pytest.mark.parametrize("tied", [False, True])
def test_bce_link_loss_and_gradient_match_the_reference(tied):
    """The masked BCE and its gradient through the decoder logits. With
    ``tied`` a negative equals the positive destination: the port's
    ``link_logits`` gives it the positive's logit, so its term's gradient
    flows through the positive pass; the total is the reference's."""
    from repro.models.tg.common import link_logits as jax_link_logits
    from repro_torch.models.tg.common import bce_link_loss, link_logits

    rng = np.random.default_rng(4)
    B, Nn, d = 6, 3, 8
    h = rng.standard_normal((B * (2 + Nn), d)).astype(np.float32)
    if tied:
        h[2 * B + 1 * Nn + 2] = h[B + 1]  # batch row 1's third negative
    mask = np.array([1, 1, 1, 1, 0, 1], bool)
    jdec = {"mlp": {"layer_0": {"w": rng.standard_normal((2 * d, d)).astype(np.float32) * 0.3,
                                "b": np.zeros(d, np.float32)},
                    "layer_1": {"w": rng.standard_normal((d, 1)).astype(np.float32) * 0.3,
                                "b": np.zeros(1, np.float32)}}}

    def jloss(p, hh):
        pos, neg = jax_link_logits(p, hh, B)
        return jax_bce_link_loss(pos, neg, jnp.asarray(mask))

    want, (wp, wh) = jax.value_and_grad(jloss, (0, 1))(jdec, jnp.asarray(h))
    tdec = params_from_jax(jdec)
    for leaf in (tdec["mlp"]["layer_0"]["w"], tdec["mlp"]["layer_1"]["w"]):
        leaf.requires_grad_(True)
    th = torch.from_numpy(h).requires_grad_(True)
    pos, neg = link_logits(tdec, th, B)
    if tied:
        assert neg[1, 2] == pos[1]
    loss = bce_link_loss(pos, neg, torch.from_numpy(mask))
    loss.backward()
    assert abs(loss.item() - float(want)) <= 1e-6
    for name in ("layer_0", "layer_1"):
        np.testing.assert_allclose(tdec["mlp"][name]["w"].grad.numpy(),
                                   np.asarray(wp["mlp"][name]["w"]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    # The embeddings' gradient summed over the tied pair is the same.
    got_h, want_h = th.grad.numpy().copy(), np.array(wh)
    if tied:
        for g in (got_h, want_h):
            g[B + 1] += g[2 * B + 1 * Nn + 2]
            g[2 * B + 1 * Nn + 2] = 0.0
    np.testing.assert_allclose(got_h, want_h, rtol=1e-5, atol=1e-6)


def test_adamw_update_matches_the_reference():
    from repro.optim import AdamWConfig as JaxAdamWConfig
    from repro.optim import adamw_init as jax_adamw_init
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    rng = np.random.default_rng(9)
    params = {"a": {"w": rng.standard_normal((5, 3)).astype(np.float32)},
              "b": rng.standard_normal(4).astype(np.float32)}
    cfg = dict(lr=3e-3, weight_decay=0.01)
    jp, js = params, jax_adamw_init(params)
    tp = params_from_jax(params)
    ts = adamw_init(tp)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0
    for step in range(3):
        grads = {"a": {"w": rng.standard_normal((5, 3)).astype(np.float32)},
                 "b": rng.standard_normal(4).astype(np.float32)}
        jp, js = jax_adamw_update(jp, grads, js, JaxAdamWConfig(**cfg))
        tp, ts = adamw_update(tp, params_from_jax(grads), ts, AdamWConfig(**cfg))
    for key, want, got in _pairs(jax.device_get(jp), params_to_numpy(tp)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=key)
    want = jax.device_get(js)
    got = opt_state_to_numpy(ts)
    assert int(got["step"]) == int(want["step"]) == 3
    for key, w, g in _pairs(want["nu"], got["nu"]):
        np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=key)
