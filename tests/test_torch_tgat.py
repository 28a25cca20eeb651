"""1-layer TGAT in the port holds against the JAX model on the same batch
(2-layer TGAT: ``tests/test_torch_tgat2.py``).

The reference's parameters move into the port with ``params_from_jax``;
one batch from the device-recency recipe goes through JAX
``tgat.link_scores`` (``fused="ref"`` and ``fused=False``) and the port's
(fused plain version and classic path). Tolerance 2e-5.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.core import DGDataLoader as JaxLoader, DGraph as JaxGraph
from repro.core import RECIPE_TGB_LINK as JAX_LINK, RecipeRegistry as JaxRecipes
from repro.data import generate
from repro.models.tg import tgat as jtgat
from repro.tg.specs import SamplerSpec as JaxSamplerSpec
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.models.tg import tgat

TOL = dict(rtol=2e-5, atol=2e-5)
B, NEG, K = 64, 5, 10


@pytest.fixture(scope="module")
def setup():
    data = generate("tiny")
    cfg = jtgat.TGATConfig(num_nodes=data.num_nodes, d_edge=data.edge_feat_dim,
                           k=K, num_layers=1)
    params = jtgat.init(jax.random.PRNGKey(3), cfg)
    m = JaxRecipes.build(JAX_LINK, num_nodes=data.num_nodes,
                         spec=JaxSamplerSpec(k=K, num_hops=1, device=True,
                                             expose_buffer=True),
                         batch_size=B, eval_negatives=NEG,
                         edge_feats=data.edge_feats,
                         edge_feat_dim=data.edge_feat_dim)
    with m.activate("eval"):
        batches = [b for _, b in zip(range(6), JaxLoader(JaxGraph(data), m,
                                                         batch_size=B))]
    host = {k: np.asarray(v) for k, v in batches[-1].as_dict().items()}
    return cfg, params, host


def _jax_batch(host):
    return {k: jax.numpy.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in host.items()}


def _torch_batch(host):
    return {k: torch.from_numpy(np.array(v, np.int32 if v.dtype == np.int64 else v.dtype))
            for k, v in host.items()}


def test_params_from_jax_round_trips(setup):
    _, params, _ = setup
    tree = jax.device_get(params)
    back = params_to_numpy(params_from_jax(tree))

    def walk(a, b):
        assert set(a) == set(b)
        for key in a:
            if isinstance(a[key], dict):
                walk(a[key], b[key])
            else:
                assert b[key].dtype == np.float32
                np.testing.assert_array_equal(np.asarray(a[key]), b[key])

    walk(tree, back)


def test_port_init_matches_reference_shapes(setup):
    cfg, params, _ = setup
    mine = tgat.init(tgat.TGATConfig(**vars(cfg)), torch.Generator().manual_seed(0))
    ref_shapes = jax.tree.map(lambda x: tuple(x.shape), jax.device_get(params))

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in t.items()}

    assert shapes(mine) == ref_shapes


@pytest.mark.parametrize("fused", ["ref", False], ids=["fused", "classic"])
def test_link_scores_match_jax(setup, fused):
    cfg, params, host = setup
    jpos, jneg = jtgat.link_scores(params, cfg, _jax_batch(host), B, fused=fused)
    tcfg = tgat.TGATConfig(**vars(cfg))
    tparams = params_from_jax(jax.device_get(params))
    tpos, tneg = tgat.link_scores(tparams, tcfg, _torch_batch(host), B,
                                  fused=fused)
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), **TOL)
    np.testing.assert_allclose(tneg.numpy(), np.asarray(jneg), **TOL)


def test_fused_and_classic_paths_agree_and_keep_ties(setup):
    cfg, params, host = setup
    tcfg = tgat.TGATConfig(**vars(cfg))
    tparams = params_from_jax(jax.device_get(params))
    batch = _torch_batch(host)
    fpos, fneg = tgat.link_scores(tparams, tcfg, batch, B)  # auto: fused ref
    cpos, cneg = tgat.link_scores(tparams, tcfg, batch, B, fused=False)
    np.testing.assert_allclose(fpos.numpy(), cpos.numpy(), **TOL)
    np.testing.assert_allclose(fneg.numpy(), cneg.numpy(), **TOL)
    # A negative that is the positive destination scores an exact tie.
    same = host["neg"] == host["dst"][:, None]
    assert same.any()
    assert (fneg.numpy()[same] == np.broadcast_to(
        fpos.numpy()[:, None], same.shape)[same]).all()


def test_default_tgat_builds_two_layers_and_two_hops():
    """``ModelSpec("tgat")`` with no kwargs is the reference's default
    TGAT: two layers, and the pipeline's hooks sample two hops of k = 20."""
    from repro_torch.data import generate as tgenerate
    from repro_torch.tg import Experiment, ModelSpec

    pipe = Experiment(model=ModelSpec("tgat")).compile(data=tgenerate("tiny"),
                                                        device="cpu")
    assert pipe.cfg.num_layers == 2 and pipe.cfg.k == 20
    assert {"attn_1", "merge_1"} <= set(pipe.params)
    hook = next(h for h in pipe.manager.hooks()
                if type(h).__name__ == "RecencyNeighborHook")
    assert hook.num_hops == 2 and hook.k == 20
