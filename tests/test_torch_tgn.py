"""TGN in the port holds against the JAX model on the same batches.

The reference's parameters move into the port with ``params_from_jax`` and
its memory with ``state_from_jax``. Batches come from the reference's TGB
link recipe on the ``tiny`` stream, once over the host recency sampler (the
classic path: pre-gathered neighbors and edge features) and once over the
device sampler with the packed buffer exposed (the fused path). The memory
is warmed by the reference's ``update_memory`` over earlier batches, so the
embeddings read non-zero memory and ``last_update``. Held: ``embed`` on both
paths and ``link_scores`` (f32 2e-5), ``update_memory`` (memory 2e-5;
``last_update`` and the set of touched nodes bit-exact, a node's message
taken from its largest stacked event index), the port's init shapes, and that no gradient reaches the new
state.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DGDataLoader as JaxLoader, DGraph as JaxGraph
from repro.core import RECIPE_TGB_LINK as JAX_LINK, RecipeRegistry as JaxRecipes
from repro.data import generate
from repro.models.tg import tgn as jtgn
from repro.tg.specs import SamplerSpec as JaxSamplerSpec
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.models.tg import tgn

TOL = dict(rtol=2e-5, atol=2e-5)
B, NEG, K = 64, 5, 10
WARM = 5


def _batches(data, device):
    m = JaxRecipes.build(JAX_LINK, num_nodes=data.num_nodes,
                         spec=JaxSamplerSpec(k=K, num_hops=1, device=device,
                                             expose_buffer=True if device else None),
                         batch_size=B, eval_negatives=NEG,
                         edge_feats=data.edge_feats,
                         edge_feat_dim=data.edge_feat_dim)
    with m.activate("eval"):
        out = [b for _, b in zip(range(WARM + 1),
                                 JaxLoader(JaxGraph(data), m, batch_size=B))]
    return [{k: np.asarray(v) for k, v in b.as_dict().items()} for b in out]


def _jax_batch(host):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in host.items()}


def _torch_batch(host):
    return {k: torch.from_numpy(np.array(v, np.int32 if v.dtype == np.int64
                                         else v.dtype))
            for k, v in host.items()}


@pytest.fixture(scope="module")
def setup():
    data = generate("tiny")
    cfg = jtgn.TGNConfig(num_nodes=data.num_nodes, d_edge=data.edge_feat_dim,
                         k=K, d_model=32, d_time=16, d_memory=24)
    params = jtgn.init(jax.random.PRNGKey(5), cfg)
    host, dev = _batches(data, False), _batches(data, True)
    state = jtgn.init_state(cfg)
    for b in host[:WARM]:
        state = jtgn.update_memory(params, cfg, state, _jax_batch(b))
    assert float(jnp.abs(state["memory"]).max()) > 0
    return cfg, params, state, host[WARM], dev[WARM]


def _port(cfg, params, state):
    return (tgn.TGNConfig(**vars(cfg)), params_from_jax(jax.device_get(params)),
            state_from_jax(jax.device_get(state)))


def test_state_from_jax_keeps_the_layout(setup):
    cfg, _, state, _, _ = setup
    mine = state_from_jax(jax.device_get(state))
    assert mine["memory"].dtype == torch.float32
    assert mine["last_update"].dtype == torch.int32
    np.testing.assert_array_equal(mine["last_update"].numpy(),
                                  np.asarray(state["last_update"]))
    fresh = tgn.init_state(tgn.TGNConfig(**vars(cfg)))
    ref = jtgn.init_state(cfg)
    for key in ("memory", "last_update"):
        assert tuple(fresh[key].shape) == tuple(ref[key].shape)
        assert not fresh[key].any()


def test_port_init_matches_reference_shapes(setup):
    cfg, params, _, _, _ = setup
    mine = tgn.init(tgn.TGNConfig(**vars(cfg)), torch.Generator().manual_seed(0))
    ref_shapes = jax.tree.map(lambda x: tuple(x.shape), jax.device_get(params))

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in t.items()}

    assert shapes(mine) == ref_shapes


@pytest.mark.parametrize("path", ["classic", "fused"])
def test_embed_matches_jax(setup, path):
    cfg, params, state, host, dev = setup
    batch, fused = (host, False) if path == "classic" else (dev, "ref")
    want = jtgn.embed(params, cfg, state, _jax_batch(batch), fused=fused)
    tcfg, tparams, tstate = _port(cfg, params, state)
    got = tgn.embed(tparams, tcfg, tstate, _torch_batch(batch), fused=fused)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_classic_and_fused_embeds_agree(setup):
    """The host-sampled (classic) and device-sampled (fused) batches hold the
    same neighborhoods, so the two paths embed alike."""
    cfg, params, state, host, dev = setup
    for key in ("seed_nodes", "nbr_ids", "nbr_times", "nbr_eids", "nbr_mask"):
        np.testing.assert_array_equal(host[key], dev[key], err_msg=key)
    tcfg, tparams, tstate = _port(cfg, params, state)
    a = tgn.embed(tparams, tcfg, tstate, _torch_batch(host))  # auto: classic
    b = tgn.embed(tparams, tcfg, tstate, _torch_batch(dev))   # auto: fused
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), **TOL)


def test_update_memory_matches_jax(setup):
    cfg, params, state, host, _ = setup
    want = jtgn.update_memory(params, cfg, state, _jax_batch(host))
    tcfg, tparams, tstate = _port(cfg, params, state)
    got = tgn.update_memory(tparams, tcfg, tstate, _torch_batch(host))
    assert got["last_update"].dtype == torch.int32
    np.testing.assert_array_equal(got["last_update"].numpy(),
                                  np.asarray(want["last_update"]))
    np.testing.assert_allclose(got["memory"].numpy(), np.asarray(want["memory"]),
                               **TOL)
    # Touched = the endpoints of the valid events; the rest keep their bits.
    m = host["batch_mask"]
    touched = np.zeros(cfg.num_nodes, bool)
    touched[np.concatenate([host["src"][m], host["dst"][m]])] = True
    changed = (got["memory"] != tstate["memory"]).any(-1).numpy()
    assert not changed[~touched].any()
    assert changed[touched].all()
    np.testing.assert_array_equal(got["last_update"].numpy()[~touched],
                                  tstate["last_update"].numpy()[~touched])


def test_update_memory_last_event_wins():
    """A node with several events takes the message of the largest index in
    the stacked ``[src copies | dst copies]``, as the reference's
    ``segment_max`` does: its dst copy of an event beats its src copy of a
    later one (node 1 below keeps time 3 from event 0, not 5 from event 1).
    Padded events touch nothing. Held against the reference, bit for bit in
    ``last_update``."""
    cfg = jtgn.TGNConfig(num_nodes=6, d_edge=3, d_model=8, d_time=4,
                         d_memory=5)
    params = jtgn.init(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(0)
    host = {"src": np.array([0, 1, 0, 2, 4, 0], np.int32),
            "dst": np.array([1, 0, 2, 0, 5, 3], np.int32),
            "time": np.array([3, 5, 5, 9, 11, 0], np.int32),
            "edge_feats": rng.standard_normal((6, 3)).astype(np.float32),
            "batch_mask": np.array([1, 1, 1, 1, 1, 0], bool)}
    state = {"memory": jnp.asarray(rng.standard_normal((6, 5)), jnp.float32),
             "last_update": jnp.asarray([1, 2, 0, 0, 0, 7], jnp.int32)}
    want = jtgn.update_memory(params, cfg, state, _jax_batch(host))
    tcfg, tparams, tstate = _port(cfg, params, state)
    got = tgn.update_memory(tparams, tcfg, tstate, _torch_batch(host))
    np.testing.assert_array_equal(got["last_update"].numpy(),
                                  np.asarray(want["last_update"]))
    np.testing.assert_array_equal(got["last_update"].numpy(), [9, 3, 5, 0, 11, 11])
    np.testing.assert_allclose(got["memory"].numpy(), np.asarray(want["memory"]),
                               **TOL)
    np.testing.assert_array_equal(got["memory"][3].numpy(), tstate["memory"][3].numpy())


@pytest.mark.parametrize("path", ["classic", "fused"])
def test_link_scores_match_jax_and_keep_state_out_of_autograd(setup, path):
    cfg, params, state, host, dev = setup
    batch, fused = (host, None) if path == "classic" else (dev, "ref")
    (jpos, jneg), jstate = jtgn.link_scores(params, cfg, state, _jax_batch(batch),
                                            B, fused=fused)
    tcfg, tparams, tstate = _port(cfg, params, state)
    tparams = jax.tree.map(lambda t: t.requires_grad_(True), tparams)
    (pos, neg), new = tgn.link_scores(tparams, tcfg, tstate, _torch_batch(batch),
                                      B, fused=fused)
    np.testing.assert_allclose(pos.detach().numpy(), np.asarray(jpos), **TOL)
    np.testing.assert_allclose(neg.detach().numpy(), np.asarray(jneg), **TOL)
    np.testing.assert_array_equal(new["last_update"].numpy(),
                                  np.asarray(jstate["last_update"]))
    np.testing.assert_allclose(new["memory"].numpy(),
                               np.asarray(jstate["memory"]), **TOL)
    assert pos.requires_grad and not new["memory"].requires_grad
