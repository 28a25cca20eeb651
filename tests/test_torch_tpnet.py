"""TPNet in the port against the JAX reference on the CPU.

Parameters (``r0`` included: a ``jax.random.normal`` draw) come from the
reference's ``init`` through ``convert``, its state through
``state_from_jax``. Held:

* ``init_state`` (``R[0]`` is ``r0`` bit for bit, ``last`` int32 zeros) and
  ``scores_pairwise`` on a warmed state (2e-5);
* ``update_state`` over chained batches with repeated nodes, equal times
  within a batch and padded events (node 0, time 0, ``batch_mask`` False, as
  ``PadBatchHook`` pads): ``R`` within 2e-5, ``last`` bit-exact and int32,
  layer l reading this batch's layer l-1; a node that only padded events
  name keeps its rows and ``last`` bit for bit;
* the reference's per-node ``segment_max`` gives -inf on an empty segment;
  the port never reads that value (an untouched node's rows come back bit
  for bit);
* ``link_scores`` (2e-5), its new state, and the gradients (1e-4 of the
  leaf's largest entry + 1e-7): only the score MLP gets one, ``r0``'s is
  exactly zero in both packages;
* a ``tiny`` pipeline (no neighbors: the recipe runs with k = 1): val MRR
  within 1e-4 of the reference's from the same parameters, the tie rule (a
  negative equal to the destination takes the positive's logit) patched
  into the reference in this test only, the state after it equal, and a
  checkpoint round trip that brings ``{"R", "last"}`` back bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import generate as jax_generate
from repro.models.tg import tpnet as jtp
from repro.models.tg.common import bce_link_loss as jax_bce
from repro.tg.specs import SamplerSpec as JaxSamplerSpec
from repro.train.loop import CTDGLinkPipeline as JaxPipeline
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.data import generate
from repro_torch.models.tg import tpnet
from repro_torch.models.tg.common import bce_link_loss
from repro_torch.tg import SamplerSpec
from repro_torch.train.loop import CTDGLinkPipeline
from tests._torch_zoo import (
    FWD,
    MRR_TOL,
    assert_grads_close,
    grads_of,
    jax_batch,
    port_params,
    sync,
    torch_batch,
)

N, B, NEG = 10, 16, 4
SMALL = dict(d_rp=8, d_hidden=16)


@pytest.fixture(scope="module")
def model():
    jcfg = jtp.TPNetConfig(num_nodes=N, **SMALL)
    return jcfg, tpnet.TPNetConfig(**vars(jcfg)), jtp.init(jax.random.PRNGKey(7), jcfg)


def _events(rng, t0, n_pad=0, only_pad_node=None):
    """B events over N nodes (repeats, equal times), the last ``n_pad``
    padded as ``PadBatchHook`` pads (src = dst = 0, t = 0, masked)."""
    lo = 0 if only_pad_node is None else 1
    src = rng.integers(lo, N, B)
    dst = rng.integers(lo, N, B)
    t = np.sort(t0 + rng.integers(0, 3000, B) // 1000 * 1000)
    mask = np.ones(B, bool)
    if n_pad:
        src[-n_pad:] = dst[-n_pad:] = t[-n_pad:] = 0
        mask[-n_pad:] = False
    return {"src": src, "dst": dst, "time": t, "batch_mask": mask,
            "neg": rng.integers(0, N, (B, NEG))}


def _states_close(got, want):
    np.testing.assert_allclose(got["R"].numpy(), np.asarray(want["R"]), **FWD)
    assert got["last"].dtype == torch.int32
    np.testing.assert_array_equal(got["last"].numpy(), np.asarray(want["last"]))


def test_init_state_and_pairwise_scores(model):
    jcfg, cfg, jp = model
    tp = params_from_jax(jax.device_get(jp))
    state = tpnet.init_state(tp, cfg)
    js = jtp.init_state(jp, jcfg)
    want = jax.device_get(js)
    assert state["R"].shape == (3, N, 8)
    np.testing.assert_array_equal(state["R"].numpy(), want["R"])
    np.testing.assert_array_equal(state["R"][0].numpy(), np.asarray(jp["r0"]))
    _states_close(state, want)
    rng = np.random.default_rng(0)
    ts = state
    for b in range(3):
        hb = _events(rng, 10_000 * (b + 1))
        js = jtp.update_state(jp, jcfg, js, *(jnp.asarray(hb[k]) for k in ("src", "dst", "time")))
        ts = tpnet.update_state(tp, cfg, ts, *(torch.from_numpy(hb[k]) for k in ("src", "dst", "time")))
    u, v = rng.integers(0, N, (2, 5, 7))
    t = np.full((5, 7), 50_000)
    want_s = jtp.scores_pairwise(jp, jcfg, js, jnp.asarray(u), jnp.asarray(v), jnp.asarray(t))
    got_s = tpnet.scores_pairwise(tp, cfg, ts, torch.from_numpy(u), torch.from_numpy(v),
                                  torch.from_numpy(t))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **FWD)


def test_update_state_over_chained_batches(model):
    jcfg, cfg, jp = model
    tp = params_from_jax(jax.device_get(jp))
    rng = np.random.default_rng(1)
    js = jtp.init_state(jp, jcfg)
    ts = state_from_jax(jax.device_get(js))
    for b, n_pad in enumerate((0, 3, 0, 5, 1)):
        hb = _events(rng, 5_000 * (b + 1), n_pad)
        assert len(np.unique(hb["src"][: B - n_pad])) < B - n_pad  # repeats
        js = jtp.update_state(jp, jcfg, js, *(jnp.asarray(hb[k]) for k in
                                               ("src", "dst", "time", "batch_mask")))
        ts = tpnet.update_state(tp, cfg, ts, *(torch.from_numpy(hb[k]) for k in
                                                ("src", "dst", "time", "batch_mask")))
        _states_close(ts, js)
        np.testing.assert_array_equal(ts["R"][0].numpy(), np.asarray(jp["r0"]))
    assert float(ts["R"][2].abs().max()) > 0  # layer 2 read layer 1's update

    # Node 0 only in padded events: neither decays, adds nor moves ``last``.
    hb = _events(rng, 40_000, n_pad=4, only_pad_node=0)
    new = tpnet.update_state(tp, cfg, ts, *(torch.from_numpy(hb[k]) for k in
                                            ("src", "dst", "time", "batch_mask")))
    assert torch.equal(new["R"][:, 0], ts["R"][:, 0])
    assert new["last"][0] == ts["last"][0]
    want = jtp.update_state(jp, jcfg, js, *(jnp.asarray(hb[k]) for k in
                                            ("src", "dst", "time", "batch_mask")))
    _states_close(new, want)


def test_empty_segments_are_never_read(model):
    jcfg, cfg, jp = model
    # The reference's per-node decay over a node no event names is -inf ...
    dec = jax.ops.segment_max(jnp.ones(4), jnp.array([1, 1, 2, 2]), N)
    assert np.isneginf(np.asarray(dec)[[0, 3, 9]]).all()
    # ... and neither package reads it: untouched rows come back unchanged.
    tp = params_from_jax(jax.device_get(jp))
    rng = np.random.default_rng(2)
    js = jtp.init_state(jp, jcfg)
    ts = state_from_jax(jax.device_get(js))
    src, dst = np.array([1, 2, 1]), np.array([2, 3, 3])
    t = np.array([100, 100, 200])
    ts = {"R": ts["R"] + torch.from_numpy(rng.standard_normal((3, N, 8)).astype(np.float32)),
          "last": ts["last"]}
    js = {"R": jnp.asarray(ts["R"].numpy()), "last": js["last"]}
    got = tpnet.update_state(tp, cfg, ts, torch.from_numpy(src), torch.from_numpy(dst),
                             torch.from_numpy(t))
    want = jtp.update_state(jp, jcfg, js, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(t))
    untouched = [0, 4, 5, 6, 7, 8, 9]
    assert torch.equal(got["R"][:, untouched], ts["R"][:, untouched])
    assert np.isfinite(np.asarray(want["R"])).all()
    _states_close(got, want)


def test_link_scores_and_gradients_match(model):
    jcfg, cfg, jp = model
    rng = np.random.default_rng(3)
    js = jtp.init_state(jp, jcfg)
    for b in range(3):
        hb = _events(rng, 10_000 * (b + 1))
        js = jtp.update_state(jp, jcfg, js, *(jnp.asarray(hb[k]) for k in ("src", "dst", "time")))
    hb = _events(rng, 50_000, n_pad=2)
    hb["neg"][:3, 1] = hb["dst"][:3]  # negatives drawn as the destination
    bt, tb = jax_batch(hb), torch_batch(hb)

    def jax_loss(p):
        (pos, neg), new = jtp.link_scores(p, jcfg, js, bt, B)
        return jax_bce(pos, neg, bt["batch_mask"]), (pos, neg, new)

    (want_loss, (want_pos, want_neg, want_new)), want_g = jax.jit(
        jax.value_and_grad(jax_loss, has_aux=True))(jp)
    tp = port_params(jp)
    (pos, neg), new = tpnet.link_scores(tp, cfg, state_from_jax(jax.device_get(js)), tb, B)
    np.testing.assert_allclose(pos.detach().numpy(), np.asarray(want_pos), **FWD)
    np.testing.assert_allclose(neg.detach().numpy(), np.asarray(want_neg), **FWD)
    assert (neg[:3, 1] == pos[:3]).all()  # the exact tie
    assert not new["R"].requires_grad
    _states_close(new, want_new)
    loss = bce_link_loss(pos, neg, tb["batch_mask"])
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    grads = grads_of(loss, tp)
    assert_grads_close(want_g, grads, "tpnet")
    assert not np.asarray(want_g["r0"]).any() and not grads["r0"].any()


def _tie_patched(link_scores):
    """The reference's ``link_scores`` with the port's exact-tie rule."""
    def patched(params, cfg, state, batch, batch_size):
        (pos, neg), new = link_scores(params, cfg, state, batch, batch_size)
        if neg is not None:
            neg = jnp.where(batch["neg"] == batch["dst"][:, None], pos[:, None], neg)
        return (pos, neg), new
    return patched


def test_tiny_pipeline_mrr_state_and_checkpoint(monkeypatch, tmp_path):
    kw = dict(batch_size=64, eval_negatives=5, model_kwargs=SMALL)
    monkeypatch.setattr(jtp, "link_scores", _tie_patched(jtp.link_scores))
    jp = JaxPipeline("tpnet", jax_generate("tiny"), sampler_spec=JaxSamplerSpec(), **kw)
    tp = CTDGLinkPipeline("tpnet", generate("tiny"), sampler_spec=SamplerSpec(),
                          device="cpu", **kw)
    assert [h.k for h in tp.manager.hooks() if hasattr(h, "sampler")] == [1]
    sync(jp, tp)
    want, _ = jp.evaluate("val")
    got, _ = tp.evaluate("val")
    assert abs(got - want) <= MRR_TOL, (got, want)
    _states_close(tp.model_state, jax.device_get(jp.model_state))

    saved = {k: v.clone() for k, v in tp.model_state.items()}
    tp.save_checkpoint(str(tmp_path), 3)
    tp.reset_epoch_state()
    assert not torch.equal(tp.model_state["R"], saved["R"])
    assert tp.restore_checkpoint(str(tmp_path)) == 3
    for k in saved:
        assert tp.model_state[k].dtype == saved[k].dtype
        assert torch.equal(tp.model_state[k], saved[k])
