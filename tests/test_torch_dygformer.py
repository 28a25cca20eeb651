"""DyGFormer in the port against the JAX reference on the CPU.

Parameters come from the reference's ``init`` through ``convert``. Held:

* the co-occurrence counts, bit for bit, on ids with repeats, padding (-1)
  and masked slots;
* ``embed_pairs`` and ``link_scores`` (2e-5) and every gradient (1e-4 of
  the leaf's largest entry + 1e-7) at ``patch_size`` 1 and 2, on a
  numpy-seeded batch whose time deltas stay below 100 s. The reference runs
  jitted: at the ``tiny`` stream's deltas (up to 8.6e4 s) its jitted
  learnable time encoding moves the logits by up to 5e-5 against its own
  op-by-op run (``jax.disable_jit()``, 40 s a gradient here), and the
  encoding at large deltas is held in ``tests/test_torch_graphmixer.py``
  and ``tests/test_torch_tgat.py``;
* a ``K`` that ``patch_size`` does not divide is refused, as the reference
  fails on it;
* the negative layout (negative j of positive i at ``2B + i*Nn + j``) and
  the exact-tie rule: a negative with the positive destination's inputs
  takes the positive's logit (ROADMAP C, "MRR ties");
* a ``tiny`` pipeline on the host recency sampler: val MRR within 1e-4 of
  the reference's pipeline from the same parameters, with the tie rule
  patched into the reference's ``link_scores`` in this test only (as
  ``tests/test_torch_host_pipeline.py`` does for TGN).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import generate as jax_generate
from repro.models.tg import dygformer as jdyg
from repro.models.tg.common import bce_link_loss as jax_bce
from repro.tg.specs import SamplerSpec as JaxSamplerSpec
from repro.train.loop import CTDGLinkPipeline as JaxPipeline
from repro_torch.data import generate
from repro_torch.models.tg import dygformer
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

B, NEG, K, N, D_EDGE = 16, 3, 4, 12, 6
SMALL = dict(d_model=16, d_time=8, d_cooc=4)
TIED = ((0, 1), (5, 0), (9, 2))  # (positive i, negative j) drawn as dst_i


def _batch(seed=0):
    """A seed-aligned batch ``[src (B) | dst (B) | neg (B*NEG)]`` with small
    time deltas, repeated neighbor ids (co-occurrence counts above 1), empty
    and partly masked rows, and the negatives of ``TIED`` equal to their
    positive's destination, inputs and all."""
    rng = np.random.default_rng(seed)
    S = 2 * B + B * NEG
    seeds = rng.integers(0, N, S)
    t = rng.integers(50, 100, B)
    seed_t = np.concatenate([t, t, np.repeat(t, NEG)])
    ids = rng.integers(0, 5, (S, K))
    times = seed_t[:, None] - rng.integers(1, 50, (S, K))
    mask = rng.random((S, K)) < 0.7
    mask[rng.random(S) < 0.15] = False
    eids = rng.integers(0, 40, (S, K))
    for i, j in TIED:
        r = 2 * B + i * NEG + j
        seeds[r] = seeds[B + i]
        ids[r], times[r], mask[r], eids[r] = ids[B + i], times[B + i], mask[B + i], eids[B + i]
    feats = rng.standard_normal((S, K, D_EDGE)).astype(np.float32)
    for i, j in TIED:
        feats[2 * B + i * NEG + j] = feats[B + i]
    ids, times, eids = (np.where(mask, a, fill) for a, fill in
                        ((ids, -1), (times, 0), (eids, -1)))
    feats = feats * mask[..., None]
    bm = np.ones(B, bool)
    bm[-2:] = False
    return {"seed_nodes": seeds, "seed_times": seed_t, "nbr_ids": ids,
            "nbr_times": times, "nbr_eids": eids, "nbr_mask": mask,
            "nbr_feats": feats, "batch_mask": bm}


def _configs(patch_size):
    jcfg = jdyg.DyGFormerConfig(num_nodes=N, d_edge=D_EDGE, k=K,
                                patch_size=patch_size, **SMALL)
    return jcfg, dygformer.DyGFormerConfig(**vars(jcfg))


def test_cooc_counts_are_bit_exact():
    rng = np.random.default_rng(3)
    a, b = rng.integers(-1, 4, (2, 50, 9))
    am, bm = rng.random((2, 50, 9)) < 0.6
    want = np.asarray(jdyg._cooc_counts(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(am), jnp.asarray(bm)))
    got = dygformer.cooc_counts(torch.from_numpy(a), torch.from_numpy(b),
                                torch.from_numpy(am), torch.from_numpy(bm))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 1  # repeats counted


@pytest.mark.parametrize("patch_size", [1, 2])
def test_link_scores_and_gradients_match(patch_size):
    jcfg, cfg = _configs(patch_size)
    jp = jdyg.init(jax.random.PRNGKey(patch_size), jcfg)
    hb = _batch()
    bt, tb = jax_batch(hb), torch_batch(hb)

    def jax_loss(p):
        pos, neg = jdyg.link_scores(p, jcfg, bt, B)
        return jax_bce(pos, neg, bt["batch_mask"]), (pos, neg)

    (want_loss, (want_pos, want_neg)), want_g = jax.jit(
        jax.value_and_grad(jax_loss, has_aux=True))(jp)
    tp = port_params(jp)
    pos, neg = dygformer.link_scores(tp, cfg, tb, B)
    np.testing.assert_allclose(pos.detach().numpy(), np.asarray(want_pos), **FWD)
    np.testing.assert_allclose(neg.detach().numpy(), np.asarray(want_neg), **FWD)
    # The tied negatives carry the positive's logit bit for bit.
    for i, j in TIED:
        assert neg[i, j] == pos[i]
    loss = bce_link_loss(pos, neg, tb["batch_mask"])
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    assert_grads_close(want_g, grads_of(loss, tp), f"patch_size {patch_size}")

    # embed_pairs on its own, and its negative layout.
    u = dygformer._gather_side(tb, torch.arange(B), cfg)
    v = dygformer._gather_side(tb, torch.arange(B, 2 * B), cfg)
    ju = jdyg._gather_side(bt, jnp.arange(B), jcfg)
    jv = jdyg._gather_side(bt, jnp.arange(B, 2 * B), jcfg)
    want_u, want_v = jax.jit(jdyg.embed_pairs, static_argnums=1)(jp, jcfg, ju, jv)
    with torch.no_grad():
        got_u, got_v = dygformer.embed_pairs(tp, cfg, u, v)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), **FWD)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **FWD)


def test_a_patch_size_that_does_not_divide_k_is_refused():
    jcfg = jdyg.DyGFormerConfig(num_nodes=N, d_edge=D_EDGE, k=3, patch_size=2, **SMALL)
    hb = _batch()
    hb = {k: (v[:, :3] if k.startswith("nbr_") else v) for k, v in hb.items()}
    with pytest.raises(Exception):
        jdyg.link_scores(jdyg.init(jax.random.PRNGKey(0), jcfg), jcfg,
                         jax_batch(hb), B)
    cfg = dygformer.DyGFormerConfig(**vars(jcfg))
    with pytest.raises(ValueError, match="divisible by patch_size"):
        dygformer.init(cfg, torch.Generator())
    params = dygformer.init(dygformer.DyGFormerConfig(
        **{**vars(jcfg), "k": 4}), torch.Generator())
    with pytest.raises(ValueError, match="divisible by patch_size"):
        dygformer.link_scores(params, cfg, torch_batch(hb), B)


def _tie_patched(link_scores):
    """The reference's ``link_scores`` with the port's exact-tie rule: a
    negative whose inputs equal the positive destination's takes the
    positive's logit."""
    def patched(params, cfg, batch, batch_size):
        pos, neg = link_scores(params, cfg, batch, batch_size)
        if neg is None:
            return pos, neg
        S = batch["seed_nodes"].shape[0]
        nn_ = neg.shape[1]
        d = jnp.repeat(jnp.arange(batch_size, 2 * batch_size), nn_)
        w = jnp.arange(2 * batch_size, S)
        same = ((batch["seed_nodes"][w] == batch["seed_nodes"][d])
                & (batch["seed_times"][w] == batch["seed_times"][d]))
        for name in ("nbr_ids", "nbr_times", "nbr_eids", "nbr_mask"):
            same = same & (batch[name][w] == batch[name][d]).all(-1)
        return pos, jnp.where(same.reshape(batch_size, nn_), pos[:, None], neg)
    return patched


def test_tiny_pipeline_mrr_matches_the_reference(monkeypatch):
    kw = dict(batch_size=64, eval_negatives=5, model_kwargs=SMALL)
    monkeypatch.setattr(jdyg, "link_scores", _tie_patched(jdyg.link_scores))
    jp = JaxPipeline("dygformer", jax_generate("tiny"),
                     sampler_spec=JaxSamplerSpec(k=6), **kw)
    tp = CTDGLinkPipeline("dygformer", generate("tiny"),
                          sampler_spec=SamplerSpec(k=6), device="cpu", **kw)
    sync(jp, tp)
    want, _ = jp.evaluate("val")
    got, _ = tp.evaluate("val")
    assert abs(got - want) <= MRR_TOL, (got, want)
