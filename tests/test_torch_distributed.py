"""The port's multi-rank CTDG pipeline and data-parallel trainer.

Worlds of 2 and 4 gloo ranks on the CPU (``tests/_torch_dist.py``), each
run once per module:

* 2 ranks: the 1-D node mesh, ``SamplerSpec(device=True, shards=2)`` on
  ``tiny.slice_events(0, 300)`` with 2-layer TGAT (narrow widths), gives an
  epoch loss equal to the one-device port's with the same spec unsharded
  (the reference's ``test_sharded_pipeline_matches_single_device``), the
  sampler state and parameters bit-equal too; GraphMixer over the 2 x 1
  ``("data", "nodes")`` mesh (``data_shards=2``, no fused layer, the
  reference's stateless branch) within 1e-4 of its one-device epoch and
  val MRR; ``DataParallelTrainer``
  matches the single-device AdamW step and ``int8_ef`` tracks the
  uncompressed run (the reference's tests' data and bounds);
* 4 ranks, the 2 x 2 ``("data", "nodes")`` mesh: 2-layer TGAT with
  ``fused="ref"`` within 1e-4 of the one-device epoch in loss and every
  parameter (the reference's ``test_2d_pipeline_matches_single_device``),
  val MRR within 1e-4; its checkpoint restores on one device (1 x 1) and
  the next epoch ends within 1e-4 of the mesh's; one TGN step (the second)
  held against the reference's step built in this process: the reference's
  ``tgn.link_scores`` on each data shard's permuted sub-batch, the loss
  normalized by the global term count, and ``sync_state_masked_psum`` under
  ``jax.vmap``, to the harness's tolerances.

The reference's own refusals (``data_shards > 1`` with a host sampler,
``tpnet`` with ``data_shards > 1``) are held in
``tests/test_torch_uniform_sampler.py``.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.distributed.sharding import sync_state_masked_psum
from repro.models.tg import tgn as jtgn
from repro.models.tg.common import bce_link_loss_parts
from repro.optim import AdamWConfig, adamw_init, adamw_update
from repro.train.loop import CTDGLinkPipeline as JaxPipeline
from tests._torch_dist import run_world

FWD = dict(rtol=2e-5, atol=2e-5)   # tests/kernels/harness.py, float32
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-7
TOL_2D = 1e-4


def _dp_payload():
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((1, 16, 8)).astype(np.float32)}


@pytest.fixture(scope="module")
def world2():
    return run_world(["pipeline_1d", "graphmixer_2d", "dp"], 2,
                     {"dp": _dp_payload()})


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ckpt2d"))
    return run_world(["pipeline_2d", "tgn_2d", "dp"], 4,
                     {"pipeline_2d": {"dir": d}, "dp": _dp_payload()})


def test_1d_sharded_pipeline_equals_one_device(world2):
    for res in (r["pipeline_1d"] for r in world2):
        assert res["mesh"] == ("data",) and not res["use_2d"]
        assert not res["exposed"]  # the recipe exposes no sharded block
    r0 = world2[0]["pipeline_1d"]
    assert r0["loss"] == r0["one_loss"], (r0["loss"], r0["one_loss"])
    for a, b in zip(r0["params"], r0["one_params"]):
        np.testing.assert_array_equal(a, b)
    got = dict(_leaves(r0["state"]))
    for key, v in _leaves(r0["one_state"]):
        np.testing.assert_array_equal(got[key], v, err_msg=key)
    assert world2[1]["pipeline_1d"]["loss"] == r0["loss"]


def test_2d_stateless_pipeline_matches_one_device(world2):
    r0 = world2[0]["graphmixer_2d"]
    assert r0["mesh"] == (2, 1)
    assert abs(r0["loss"] - r0["one_loss"]) < TOL_2D, (r0["loss"], r0["one_loss"])
    assert abs(r0["mrr"] - r0["one_mrr"]) < TOL_2D, (r0["mrr"], r0["one_mrr"])
    assert world2[1]["graphmixer_2d"]["loss"] == r0["loss"]


def test_dp_trainer_matches_single_device(world2, world4):
    x = jnp.asarray(_dp_payload()["x"])
    params = {"w": jnp.eye(8)}
    g = jax.grad(lambda p: ((x[0] @ p["w"] - 1.0) ** 2).mean())(params)
    want, _ = adamw_update(params, g, adamw_init(params), AdamWConfig(lr=1e-2))
    for ranks in (world2, world4):
        for res in ranks:
            np.testing.assert_allclose(res["dp"]["w_after_one"],
                                       np.asarray(want["w"]), rtol=1e-5, atol=1e-5)


def test_int8_error_feedback_tracks_uncompressed(world2, world4):
    for ranks in (world2, world4):
        dp = ranks[0]["dp"]
        assert dp["int8_ef"][-1] < 1.2 * dp["none"][-1] + 1e-3, dp
        assert dp["none"][-1] < dp["none"][0]  # it trains
        for r in ranks[1:]:  # replicated
            assert r["dp"]["none"] == dp["none"]
            assert r["dp"]["int8_ef"] == dp["int8_ef"]


def test_2d_pipeline_matches_one_device(world4):
    r0 = world4[0]["pipeline_2d"]
    assert r0["mesh"] == (("data", "nodes"), (2, 2))
    assert r0["buf_rows"] == -(-80 // 2)
    assert r0["one_mesh"] is None
    assert abs(r0["loss"] - r0["one_loss"]) < TOL_2D, (r0["loss"], r0["one_loss"])
    d = max(float(np.max(np.abs(a - b)))
            for a, b in zip(r0["params"], r0["one_params"]))
    assert d < TOL_2D, d
    assert abs(r0["mrr"] - r0["one_mrr"]) < TOL_2D, (r0["mrr"], r0["one_mrr"])
    for res in world4[1:]:  # every rank holds the same parameters
        for a, b in zip(res["pipeline_2d"]["params2"], r0["params2"]):
            np.testing.assert_array_equal(a, b)


def test_2d_checkpoint_restores_on_one_device(world4):
    r0 = world4[0]["pipeline_2d"]
    assert r0["written"] == ["ckpt_0"] and r0["path"].endswith("ckpt_0")
    assert abs(r0["restored_loss2"] - r0["loss2"]) < TOL_2D, (
        r0["restored_loss2"], r0["loss2"])
    d = max(float(np.max(np.abs(a - b)))
            for a, b in zip(r0["restored_params2"], r0["params2"]))
    assert d < TOL_2D, d


def _unfused(fn, *args):
    """``fn`` jitted for ``args``' shapes at XLA's backend optimization
    level 0, which contracts no ``dt * w + b`` into an FMA (ROADMAP C: the
    reference then rounds its time encoding as the port does)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _reference_step(res):
    """The reference's 2-D TGN step on the recorded batch: loss, summed
    gradients and the synced memory of each data shard."""
    cfg = jtgn.TGNConfig(**res["cfg"])
    B, ds = res["B"], res["data_shards"]
    bl = B // ds
    batch = res["batch"]
    S = batch["seed_nodes"].shape[0]
    perm = JaxPipeline._seed_perm(types.SimpleNamespace(batch_size=B,
                                                        data_shards=ds), S)
    subs = []
    for d in range(ds):
        sub = {}
        for key, v in batch.items():
            if key in ("nbr_buf", "edge_feat_table") or not np.shape(v):
                sub[key] = v
            elif v.shape[0] == B:
                sub[key] = v[d * bl:(d + 1) * bl]
            elif v.shape[0] % S == 0:
                m = v.shape[0] // S
                rows = perm if m == 1 else (perm[:, None] * m + np.arange(m)).reshape(-1)
                n = rows.shape[0] // ds
                sub[key] = v[rows[d * n:(d + 1) * n]]
            else:
                sub[key] = v
        subs.append({k: jnp.asarray(v) for k, v in sub.items()})
    params = jax.tree.map(jnp.asarray, res["params"])
    state = jax.tree.map(jnp.asarray, res["state"])

    def parts(p, sub):
        (pos, neg), new_state = jtgn.link_scores(p, cfg, state, sub, bl,
                                                 fused="ref")
        num, den = bce_link_loss_parts(pos, neg, sub["batch_mask"])
        return num, (den, new_state)

    step = _unfused(jax.value_and_grad(parts, has_aux=True), params, subs[0])
    outs = [step(params, sub) for sub in subs]
    # Each shard's gradient of num / D, D the global term count.
    D = jnp.maximum(sum(den for (_, (den, _)), _ in outs), 1.0)
    loss, grads, states, touched = 0.0, None, [], []
    for sub, ((num, (_, new_state)), g) in zip(subs, outs):
        loss = loss + num
        g = jax.tree.map(lambda x: x / D, g)
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        states.append(new_state)
        nodes = jnp.concatenate([sub["src"], sub["dst"]])
        mm = jnp.concatenate([sub["batch_mask"], sub["batch_mask"]])
        touched.append(jnp.zeros(cfg.num_nodes, bool).at[nodes].max(mm))
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    synced = jax.vmap(lambda st, m: sync_state_masked_psum(st, m, "data"),
                      axis_name="data")(stacked, jnp.stack(touched))
    return float(loss / D), grads, synced


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def test_tgn_2d_step_matches_the_reference(world4):
    res = world4[0]["tgn_2d"]
    want_loss, want_grads, synced = _reference_step(res)
    np.testing.assert_allclose(res["loss"], want_loss, **FWD)
    got = dict(_leaves(res["grads"]))
    for name, want in _leaves(jax.device_get(want_grads)):
        want = np.asarray(want)
        atol = GRAD_RTOL * float(np.abs(want).max()) + GRAD_FLOOR
        np.testing.assert_allclose(got[name], want, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=name)
    for d, r in enumerate(world4):  # rank (d, n): data shard d's sync
        tg = r["tgn_2d"]
        np.testing.assert_allclose(tg["new_state"]["memory"],
                                   np.asarray(synced["memory"][d // 2]), **FWD)
        np.testing.assert_array_equal(tg["new_state"]["last_update"],
                                      np.asarray(synced["last_update"][d // 2]))
        assert tg["loss"] == res["loss"]
    # The sync leaves both data shards with one memory, and the touched
    # rows moved.
    np.testing.assert_array_equal(np.asarray(synced["memory"][0]),
                                  np.asarray(synced["memory"][1]))
    assert not np.array_equal(res["new_state"]["memory"], res["state"]["memory"])
