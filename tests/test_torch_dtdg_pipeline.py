"""The port's DTDG snapshot link pipeline holds against the reference's.

Both ``DTDGLinkPipeline``s run on the first 600 events of the ``tiny``
stream at hourly snapshots (``d_embed`` 16), the port on the CPU (the plain
segment sum). The reference draws the parameters and, through
``jax.random``, the negatives; the port takes the parameters through
``repro_torch.convert`` and the negatives by standing the reference's draws
in for ``SnapshotTensor.negatives``. Held against the reference: val and
test MRR within 1e-4 (before and after a reference epoch), each train step's
loss (1e-5), every gradient (1e-4 of the leaf's largest entry), the carried
state (2e-5) and the AdamW update, and checkpoints in both directions (bit
for bit). Held within the port: the compiled path against the hook path and
a chunked epoch against a whole one (bit-identical), the mid-epoch cursor
resume, the empty val split, ``Experiment`` routing (the node task's too)
and the row purity of the port's own negatives.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.core import RECIPE_DTDG_SNAPSHOT as JAX_RECIPE
from repro.core import RecipeRegistry as JaxRegistry
from repro.core.negatives import snapshot_negatives as jax_snapshot_negatives
from repro.models.tg import snapshot as jsnap
from repro.models.tg.common import bce_link_loss as jax_bce_link_loss
from repro.models.tg.common import link_decoder as jax_link_decoder
from repro.optim import adamw_update as jax_adamw_update
from repro.train.loop import DTDGLinkPipeline as JaxPipeline
from repro_torch.convert import (
    opt_state_from_jax,
    opt_state_to_numpy,
    params_from_jax,
    params_to_numpy,
    state_from_jax,
)
from repro_torch.core import (
    RECIPE_DTDG_SNAPSHOT,
    TRAIN_KEY,
    RecipeRegistry,
    SnapshotTensor,
    snapshot_negatives,
)
from repro_torch.core.batch import Batch
from repro_torch.data import generate
from repro_torch.models.tg.common import bce_link_loss
from repro_torch.tg import DataSpec, Experiment, ModelSpec, TrainSpec
from repro_torch.train.loop import DTDGLinkPipeline, SnapshotLinkTrainer
from repro_torch.train.nodeprop import DTDGNodePipeline

MODELS = ("gcn", "gclstm", "tgcn")
KW = dict(snapshot_unit="h", d_embed=16, seed=3)
MRR_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-7
STATE_TOL = dict(rtol=2e-5, atol=2e-5)
STEPS = 3


@pytest.fixture(scope="module")
def stream():
    return generate("tiny").slice_events(0, 600)


@pytest.fixture
def reference_negatives(monkeypatch):
    """Stand the reference's ``jax.random`` draws in for the port's."""
    def negatives(self, seed, num_negatives, rows=None):
        if rows is None:
            rows = np.arange(self.num_snapshots)
        draws = jax_snapshot_negatives(seed, self.num_nodes, self.capacity,
                                       num_negatives, rows)
        return torch.as_tensor(np.array(draws), device=self.src.device)

    monkeypatch.setattr(SnapshotTensor, "negatives", negatives)


def _pair(name, small_stream, stream, **kw):
    jp = JaxPipeline(name, small_stream, **KW, **kw)
    tp = DTDGLinkPipeline(name, stream, device="cpu", **KW, **kw)
    _sync(jp, tp)
    return jp, tp


def _sync(jp, tp):
    """Give the port the reference's parameters, optimizer and model state."""
    tp.load_params(params_from_jax(jax.device_get(jp.params)))
    tp.load_opt_state(opt_state_from_jax(jax.device_get(jp.opt_state)))
    tp.load_model_state(state_from_jax(jax.device_get(jp.model_state)))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def _states(state):
    """A recurrent state of either package as a list of numpy arrays."""
    items = state if isinstance(state, tuple) else (state,)
    return [s.detach().numpy() if isinstance(s, torch.Tensor)
            else np.asarray(jax.device_get(s)) for s in items]


@pytest.mark.parametrize("name", MODELS)
def test_val_and_test_mrr_match_jax(name, small_stream, stream,
                                    reference_negatives):
    jp, tp = _pair(name, small_stream, stream)
    assert tp._split_pairs("val") == jp._split_pairs("val")
    for _ in range(2):  # at init, then after one reference epoch
        for split in ("val", "test"):
            want, _ = jp.evaluate(split)
            got, _ = tp.evaluate(split)
            assert abs(got - want) <= MRR_TOL, (split, got, want)
        jp.train_epoch()
        _sync(jp, tp)


@pytest.mark.parametrize("name", MODELS)
def test_train_steps_match_jax(name, small_stream, stream, reference_negatives):
    """Each step from the reference's parameters, optimizer state and carried
    recurrent state: the loss, every gradient, the new state, and the AdamW
    update on the reference's gradients."""
    jp, tp = _pair(name, small_stream, stream)
    apply = jsnap.make_apply(name, jp.cfg)

    def loss_fn(params, state, x):
        z, new_state = apply(params, x["src"], x["dst"], x["mask"], state)
        h_src = z[x["nsrc"]]
        pos = jax_link_decoder(params["decoder"], h_src, z[x["ndst"]])
        neg = jax_link_decoder(params["decoder"], h_src, z[x["neg"]])
        return jax_bce_link_loss(pos, neg, x["nmask"]), new_state

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    lo, _ = jp._split_pairs("train")
    jxs = jp._pair_xs(lo, lo + STEPS, jp.num_negatives)
    txs = tp._pair_xs(lo, lo + STEPS, tp.num_negatives)
    state = jp.model_state
    for i in range(STEPS):
        (loss, new_state), grads = grad_fn(
            jp.params, state, jax.tree_util.tree_map(lambda v: v[i], jxs))
        tp.load_params(params_from_jax(jax.device_get(jp.params)))
        tp.load_model_state(state_from_jax(jax.device_get(state)))
        pos, neg, t_state = tp._scores(tp.params, {k: v[i] for k, v in txs.items()},
                                       tp.model_state)
        t_loss = bce_link_loss(pos, neg, txs["nmask"][i])
        assert abs(t_loss.item() - float(loss)) <= LOSS_TOL, (i, t_loss, loss)
        t_grads = params_to_numpy(tp._grads(t_loss))
        for want, got in zip(_leaves(jax.device_get(grads)), _leaves(t_grads)):
            atol = GRAD_RTOL * float(np.abs(want).max()) + GRAD_FLOOR
            np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol)
        for want, got in zip(_states(new_state), _states(t_state)):
            np.testing.assert_allclose(got, want, **STATE_TOL)
        # AdamW on the reference's gradients gives the reference's update.
        tp.load_opt_state(opt_state_from_jax(jax.device_get(jp.opt_state)))
        tp._update(params_from_jax(jax.device_get(grads)))
        jp.params, jp.opt_state = jax_adamw_update(jp.params, grads,
                                                   jp.opt_state, jp.opt_cfg)
        for want, got in zip(_leaves(jax.device_get(jp.params)),
                             _leaves(params_to_numpy(tp.params))):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        state = new_state


@pytest.mark.parametrize("name", MODELS)
def test_compiled_and_hook_paths_are_bit_identical(name, stream):
    comp = DTDGLinkPipeline(name, stream, compiled=True, device="cpu", **KW)
    hook = DTDGLinkPipeline(name, stream, compiled=False, device="cpu", **KW)
    assert comp.train_epoch()[0] == hook.train_epoch()[0]
    _assert_trees_equal(params_to_numpy(comp.params),
                        params_to_numpy(hook.params))
    _assert_trees_equal(opt_state_to_numpy(comp.opt_state),
                        opt_state_to_numpy(hook.opt_state))
    for split in ("val", "test"):
        assert comp.evaluate(split)[0] == hook.evaluate(split)[0]


def test_chunked_epoch_matches_the_whole_epoch(stream):
    whole = DTDGLinkPipeline("tgcn", stream, device="cpu", **KW)
    chunked = DTDGLinkPipeline("tgcn", stream, chunk_size=5, device="cpu", **KW)
    assert whole.train_epoch()[0] == chunked.train_epoch()[0]
    _assert_trees_equal(params_to_numpy(whole.params),
                        params_to_numpy(chunked.params))
    assert whole.evaluate("val")[0] == chunked.evaluate("val")[0]
    chunked.evaluate("test")
    chunked.chunk_size = 3
    chunked.train_epoch()
    assert len(chunked._xs_cache) <= chunked._XS_CACHE_MAX


def test_empty_val_split_keeps_test_pairs(stream):
    tp = DTDGLinkPipeline("gcn", stream, val_ratio=0.0, test_ratio=0.3,
                          device="cpu", **KW)
    vlo, vhi = tp._split_pairs("val")
    tlo, thi = tp._split_pairs("test")
    assert vlo == vhi and thi > tlo
    assert tp.evaluate("val")[0] == 0.0
    assert tp.evaluate("test")[0] > 0.0
    t_lo, t_hi = tp._split_pairs("train")
    assert 0 == t_lo <= t_hi == vlo and thi == tp.snapshots.num_snapshots - 1


def test_mid_epoch_cursor_resume(stream, tmp_path):
    """Chunks run up to a checkpoint, restored into a fresh pipeline and
    finished there, give the uninterrupted epoch's parameters bit for bit."""
    kw = dict(KW, seed=1)
    full = DTDGLinkPipeline("gclstm", stream, device="cpu", **kw)
    loss_full, _ = full.train_epoch()
    half = DTDGLinkPipeline("gclstm", stream, chunk_size=2, device="cpu", **kw)
    first = half.train_chunk() + half.train_chunk()
    mid = half.snapshot_cursor
    assert mid == 4
    half.save_checkpoint(str(tmp_path), 7)
    resumed = DTDGLinkPipeline("gclstm", stream, device="cpu", **kw)
    assert resumed.restore_checkpoint(str(tmp_path)) == 7
    assert resumed.snapshot_cursor == mid
    loss_rest, _ = resumed.train_epoch()
    assert resumed.snapshot_cursor == 0
    _assert_trees_equal(params_to_numpy(full.params),
                        params_to_numpy(resumed.params))
    lo, hi = full._split_pairs("train")
    rest = hi - mid
    np.testing.assert_allclose((sum(first) + loss_rest * rest) / (len(first) + rest),
                               loss_full, rtol=1e-6)
    assert full.evaluate("val")[0] == resumed.evaluate("val")[0]


@pytest.mark.parametrize("name", ["gclstm", "tgcn"])
def test_checkpoints_cross_between_packages(name, small_stream, stream, tmp_path):
    jp = JaxPipeline(name, small_stream, chunk_size=2, **KW)
    jp.train_chunk()
    jp.save_checkpoint(str(tmp_path / "jax"), 1)
    tp = DTDGLinkPipeline(name, stream, device="cpu", **KW)
    assert tp.restore_checkpoint(str(tmp_path / "jax")) == 1
    assert tp.snapshot_cursor == jp._cursor == 2
    _assert_trees_equal(jax.device_get(jp.params), params_to_numpy(tp.params))
    _assert_trees_equal(jax.device_get(jp.opt_state),
                        opt_state_to_numpy(tp.opt_state))
    for a, b in zip(_states(jp.model_state), _states(tp.model_state)):
        np.testing.assert_array_equal(a, b)

    tp.chunk_size = 2
    tp.train_chunk()
    tp.save_checkpoint(str(tmp_path / "port"), 2)
    back = JaxPipeline(name, small_stream, **KW)
    assert back.restore_checkpoint(str(tmp_path / "port")) == 2
    assert back._cursor == 4
    _assert_trees_equal(params_to_numpy(tp.params), jax.device_get(back.params))
    for a, b in zip(_states(tp.model_state), _states(back.model_state)):
        np.testing.assert_array_equal(a, b)


def test_experiment_compiles_the_snapshot_quadrant(tmp_path):
    exp = Experiment(data=DataSpec("tiny", discretization="h"),
                     model=ModelSpec("gclstm", {"d_embed": 8}),
                     train=TrainSpec(eval_negatives=5, chunk_size=7, epochs=1,
                                     eval_every=1, ckpt_dir=str(tmp_path),
                                     ckpt_every=1))
    assert Experiment.from_json(exp.to_json()) == exp
    pipe = exp.compile(device="cpu")
    assert isinstance(pipe, DTDGLinkPipeline) and SnapshotLinkTrainer is DTDGLinkPipeline
    assert pipe.device == torch.device("cpu")
    assert (pipe.cfg.d_embed, pipe.eval_negatives, pipe.chunk_size) == (8, 5, 7)
    out = exp.run(device="cpu", splits=("val", "test"))
    assert len(out["history"]["loss"]) == 1 and len(out["history"]["ckpts"]) == 1
    assert all(0.0 < v <= 1.0 for v in out["metrics"].values())
    with pytest.raises(ValueError, match="not a snapshot"):
        Experiment(data=DataSpec("tiny", discretization="h"),
                   model=ModelSpec("tgat")).compile(device="cpu")
    with pytest.raises(ValueError, match="event-stream"):
        Experiment(data=DataSpec("tiny"),
                   model=ModelSpec("gcn")).compile(device="cpu")
    # The node task compiles the snapshot models to the node pipeline; it
    # needs the label window, and refuses link-only models.
    node = Experiment(data=DataSpec("tiny", discretization="h"),
                      model=ModelSpec("gcn", {"d_embed": 8, "num_cats": 6}),
                      task="node").compile(device="cpu")
    assert isinstance(node, DTDGNodePipeline) and node.num_cats == 6
    with pytest.raises(ValueError, match="needs DataSpec.discretization"):
        Experiment(data=DataSpec("tiny"), model=ModelSpec("gcn"),
                   task="node").compile(device="cpu")
    with pytest.raises(ValueError, match="not a node-task model"):
        Experiment(data=DataSpec("tiny", discretization="h"),
                   model=ModelSpec("tgat"), task="node").compile(device="cpu")


def test_legacy_run_epoch_shim(stream):
    tp = SnapshotLinkTrainer("gcn", stream, device="cpu", **KW)
    loss, _ = tp.run_epoch(train=True)
    assert np.isfinite(loss)
    with pytest.warns(DeprecationWarning):
        mrr, _ = tp.run_epoch(train_frac=0.5, train=False)
    assert 0.0 <= mrr <= 1.0


def test_snapshot_negatives_are_row_pure():
    """A bulk draw equals every row drawn alone, the hooks give the same
    rows, and draws depend on nothing but (seed, m, row)."""
    bulk = snapshot_negatives(3, 100, 8, 5, np.arange(20))
    assert bulk.shape == (20, 8, 5) and bulk.dtype == torch.int32
    for row in (0, 7, 19):
        assert torch.equal(bulk[row], snapshot_negatives(3, 100, 8, 5, [row])[0])
    scattered = snapshot_negatives(3, 100, 8, 5, [19, 2, 7])
    assert torch.equal(scattered, bulk[[19, 2, 7]])
    assert not torch.equal(snapshot_negatives(4, 100, 8, 5, [0])[0], bulk[0])
    assert snapshot_negatives(3, 100, 8, 4, [0]).shape == (1, 8, 4)
    assert int(bulk.min()) >= 0 and int(bulk.max()) < 100

    m = RecipeRegistry.build(RECIPE_DTDG_SNAPSHOT, num_nodes=100, capacity=8,
                             num_negatives=5, eval_negatives=2, seed=3,
                             device="cpu")
    with m.activate(TRAIN_KEY):
        for row in range(6):
            b = Batch({"src": np.zeros(8, np.int64), "dst": np.zeros(8, np.int64),
                       "time": np.zeros(8, np.int64)},
                      meta={"snapshot_row": row})
            assert torch.equal(m.execute(b)["neg"], bulk[row])
    assert any("SnapshotNegativeHook" in k for k in m.state_dict())
    # The reference's recipe checkpoints its hooks under the same keys.
    jm = JaxRegistry.build(JAX_RECIPE, num_nodes=100, capacity=8,
                           num_negatives=5, eval_negatives=2, seed=3)
    assert sorted(jm.state_dict()) == sorted(m.state_dict())
