"""GraphMixer in the port, with the norms and the fixed time encoding it
needs, against the JAX reference on the CPU.

Parameters come from the reference's ``init`` through ``convert``; batches
from the reference's TGB link recipe on the ``tiny`` stream. Held:

* ``layer_norm`` and ``rms_norm`` (float32 2e-5; ``rms_norm`` of bfloat16
  inputs to one bfloat16 rounding), and the fixed time encoding's arrays
  bit for bit;
* the fixed encoding at wikipedia's time deltas (up to 2.6e6 s, so theta up
  to 2.6e6 rad with ``w_0 = 1``), the reference computed under
  ``jax.disable_jit()`` (ROADMAP C, "Rounding under jit"): the largest gap
  measured on the CPU is 6.0e-8 (half a float32 ulp of cos near 1), held
  to 2e-5;
* ``embed`` and ``link_scores`` (2e-5) and every gradient (1e-4 of the
  leaf's largest entry + 1e-7). The reference runs jitted here: the fixed
  encoding's phase ``b`` is 0, so a fused ``dt * w + b`` rounds as the
  port's separate product does;
* the "fixed" encoding trains: its arrays get non-zero gradients in both
  packages and one AdamW step moves them alike (the reference's optimizer
  has no mask);
* ``tiny`` pipelines on the host and the device recency samplers: val MRR
  within 1e-4 of the reference's pipeline from the same parameters.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import generate as jax_generate
from repro.models.tg import graphmixer as jgm
from repro.models.tg.common import bce_link_loss as jax_bce
from repro.nn import norm as jnorm
from repro.nn import time_encode as jte
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.tg.specs import SamplerSpec as JaxSamplerSpec
from repro.train.loop import CTDGLinkPipeline as JaxPipeline
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data import generate
from repro_torch.models.tg import graphmixer
from repro_torch.models.tg.common import bce_link_loss
from repro_torch.nn import norm, time_encode
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.tg import SamplerSpec
from repro_torch.train.loop import CTDGLinkPipeline
from tests._torch_zoo import (
    FWD,
    MRR_TOL,
    assert_grads_close,
    grads_of,
    jax_batch,
    pairs,
    port_params,
    recipe_batches,
    sync,
    torch_batch,
)

B, NEG, K = 64, 5, 6
SMALL = dict(d_model=16, d_time=8)
LARGE_DT = 2.6e6
LARGE_DT_GAP = 2e-5


@pytest.mark.parametrize("shape", [(7, 16), (3, 5, 172)])
def test_layer_norm_matches_the_reference(shape):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    jp = jnorm.layer_norm_init(shape[-1])
    jp = {"scale": jnp.asarray(rng.standard_normal(shape[-1]), jnp.float32),
          "bias": jnp.asarray(rng.standard_normal(shape[-1]), jnp.float32)}
    want = np.asarray(jnorm.layer_norm(jp, jnp.asarray(x)))
    got = norm.layer_norm(params_from_jax(jax.device_get(jp)), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    ones = norm.layer_norm_init(shape[-1])
    assert torch.equal(ones["scale"], torch.ones(shape[-1]))
    assert torch.equal(ones["bias"], torch.zeros(shape[-1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_the_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = np.asarray(jnorm.rms_norm({"scale": jnp.asarray(scale)}, jx)
                      .astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = norm.rms_norm({"scale": torch.from_numpy(scale)}, tx)
    assert got.dtype == tx.dtype
    tol = FWD if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    assert torch.equal(norm.rms_norm_init(64)["scale"], torch.ones(64))


@pytest.mark.parametrize("dim", [8, 100])
def test_fixed_time_encoding_arrays_are_bit_equal(dim):
    want = jax.device_get(jte.time_encode_init(jax.random.PRNGKey(0), dim,
                                               learnable=False))
    got = time_encode.time_encode_init(torch.Generator(), dim, learnable=False)
    for name in ("w", "b"):
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    assert float(got["w"][0]) == 1.0 and not got["b"].any()


def test_fixed_time_encoding_at_wikipedia_time_deltas():
    rng = np.random.default_rng(2)
    dt = np.concatenate([rng.uniform(0, LARGE_DT, 4000),
                         [0.0, 1.0, LARGE_DT]]).astype(np.float32)
    jp = jte.time_encode_init(jax.random.PRNGKey(0), 100, learnable=False)
    with jax.disable_jit():
        want = np.asarray(jte.time_encode(jp, jnp.asarray(dt)))
    got = time_encode.time_encode(params_from_jax(jax.device_get(jp)),
                                  torch.from_numpy(dt)).numpy()
    gap = float(np.abs(got - want).max())
    assert gap <= LARGE_DT_GAP, gap


@pytest.fixture(scope="module")
def model_batch():
    data = jax_generate("tiny")
    cfg = jgm.GraphMixerConfig(num_nodes=data.num_nodes, d_edge=data.edge_feat_dim,
                               k=K, **SMALL)
    params = jgm.init(jax.random.PRNGKey(4), cfg)
    batch = recipe_batches(data, 4, k=K, batch_size=B, eval_negatives=NEG)[3]
    # Seeds with some, all and no neighbor slots valid.
    rows = batch["nbr_mask"].sum(-1)
    assert (rows == 0).any() and (rows == K).any() and ((rows > 0) & (rows < K)).any()
    return cfg, params, batch


def _jax_loss(params, cfg, bt):
    pos, neg = jgm.link_scores(params, cfg, bt, B)
    return jax_bce(pos, neg, bt["batch_mask"]), (pos, neg)


def test_embed_and_link_scores_match(model_batch):
    jcfg, jp, hb = model_batch
    cfg = graphmixer.GraphMixerConfig(**vars(jcfg))
    bt, tb = jax_batch(hb), torch_batch(hb)
    tp = params_from_jax(jax.device_get(jp))
    want_h = np.asarray(jax.jit(jgm.embed, static_argnums=1)(jp, jcfg, bt))
    want_pos, want_neg = jax.jit(jgm.link_scores, static_argnums=(1, 3))(
        jp, jcfg, bt, B)
    np.testing.assert_allclose(graphmixer.embed(tp, cfg, tb).numpy(), want_h, **FWD)
    pos, neg = graphmixer.link_scores(tp, cfg, tb, B)
    np.testing.assert_allclose(pos.numpy(), np.asarray(want_pos), **FWD)
    np.testing.assert_allclose(neg.numpy(), np.asarray(want_neg), **FWD)
    assert neg.shape == (B, NEG)


def test_gradients_match_and_the_fixed_encoding_trains(model_batch):
    jcfg, jp, hb = model_batch
    cfg = graphmixer.GraphMixerConfig(**vars(jcfg))
    bt, tb = jax_batch(hb), torch_batch(hb)
    (want_loss, _), want_g = jax.jit(jax.value_and_grad(
        _jax_loss, has_aux=True), static_argnums=1)(jp, jcfg, bt)
    tp = port_params(jp)
    pos, neg = graphmixer.link_scores(tp, cfg, tb, B)
    loss = bce_link_loss(pos, neg, tb["batch_mask"])
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    grads = grads_of(loss, tp)
    assert_grads_close(want_g, grads, "graphmixer")
    # The "fixed" time encoding has gradients in both packages ...
    for name in ("w", "b"):
        assert np.abs(np.asarray(want_g["time"][name])).max() > 0
        assert grads["time"][name].abs().max() > 0
    # ... and one AdamW step of each package moves it alike.
    jnew, _ = jax.jit(jax_adamw_update, static_argnums=3)(
        jp, want_g, jax_adamw_init(jp), JaxAdamWConfig())
    tnew, _ = adamw_update(params_from_jax(jax.device_get(jp)),
                           params_from_jax(jax.device_get(want_g)),
                           opt_state_from_jax(jax.device_get(jax_adamw_init(jp))),
                           AdamWConfig())
    moved = np.asarray(jnew["time"]["w"]) != np.asarray(jp["time"]["w"])
    assert moved.any()
    for key, want, got in pairs(jax.device_get(jnew), tnew):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7,
                                   err_msg=key)


@pytest.mark.parametrize("device_sampler", [False, True], ids=["host", "device"])
def test_tiny_pipeline_mrr_matches_the_reference(device_sampler):
    kw = dict(batch_size=B, eval_negatives=NEG, model_kwargs=SMALL)
    jp = JaxPipeline("graphmixer", jax_generate("tiny"),
                     sampler_spec=JaxSamplerSpec(k=K, device=device_sampler), **kw)
    tp = CTDGLinkPipeline("graphmixer", generate("tiny"),
                          sampler_spec=SamplerSpec(k=K, device=device_sampler),
                          device="cpu", **kw)
    assert not any(k == "nbr_buf" for h in tp.manager.hooks() for k in h.produces)
    sync(jp, tp)
    want, _ = jp.evaluate("val")
    got, _ = tp.evaluate("val")
    assert abs(got - want) <= MRR_TOL, (got, want)
    with pytest.raises(ValueError, match="no fused twin"):
        CTDGLinkPipeline("graphmixer", generate("tiny"), fused="ref", device="cpu", **kw)
