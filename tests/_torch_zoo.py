"""Shared pieces of the port's CTDG-zoo parity tests
(``tests/test_torch_{graphmixer,dygformer,tpnet,uniform_sampler}.py``):
batches from the reference's link recipe on the ``tiny`` stream, the same
batch as JAX and as torch tensors, gradient comparison, and pipelines of
both packages from the same parameters."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import DGDataLoader as JaxLoader, DGraph as JaxGraph
from repro.core import RECIPE_TGB_LINK as JAX_LINK, RecipeRegistry as JaxRecipes
from repro.tg.specs import SamplerSpec as JaxSamplerSpec
from repro_torch.convert import (
    opt_state_from_jax,
    params_from_jax,
    state_from_jax,
)

FWD = dict(rtol=2e-5, atol=2e-5)     # tests/kernels/harness.py, float32
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-7   # of the leaf's largest entry
MRR_TOL = 1e-4


def recipe_batches(data, n, *, k, batch_size=64, eval_negatives=5,
                   key="eval", kind="recency", num_hops=1):
    """The first ``n`` batches of the reference's TGB link recipe over
    ``data`` (host sampler), as dicts of numpy arrays."""
    m = JaxRecipes.build(JAX_LINK, num_nodes=data.num_nodes,
                         spec=JaxSamplerSpec(kind=kind, k=k, num_hops=num_hops),
                         batch_size=batch_size, eval_negatives=eval_negatives,
                         edge_feats=data.edge_feats,
                         edge_feat_dim=data.edge_feat_dim)
    if kind == "uniform":
        for h in m.hooks():
            if hasattr(h, "build"):
                h.build(data.src, data.dst, data.edge_t,
                        np.arange(len(data.src), dtype=np.int64))
    with m.activate(key):
        out = [b for _, b in zip(range(n),
                                 JaxLoader(JaxGraph(data), m, batch_size=batch_size))]
    return [{k_: np.asarray(v) for k_, v in b.as_dict().items()} for b in out]


def jax_batch(host):
    """A numpy batch as the reference stages it (int64 narrowed to int32)."""
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in host.items()}


def torch_batch(host):
    """The same batch as CPU tensors (int64 narrowed to int32)."""
    return {k: torch.from_numpy(np.array(v, np.int32 if v.dtype == np.int64
                                         else v.dtype))
            for k, v in host.items()}


def port_params(params):
    """The reference's parameters as leaf tensors that require grad."""
    def leaf(tree):
        if isinstance(tree, dict):
            return {k: leaf(v) for k, v in tree.items()}
        return tree.requires_grad_(True)
    return leaf(params_from_jax(jax.device_get(params)))


def pairs(ref, port, prefix=""):
    """(name, reference leaf, port leaf) over two nested dicts."""
    for k in ref:
        if isinstance(ref[k], dict):
            yield from pairs(ref[k], port[k], f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(ref[k]), port[k]


def assert_grads_close(want_tree, got_tree, what=""):
    """Every gradient leaf within GRAD_RTOL of the leaf's largest entry
    (plus GRAD_FLOOR); returns the worst error over that allowance's
    scale, ``max |got - want| / (max |want| + GRAD_FLOOR / GRAD_RTOL)``."""
    worst = 0.0
    for name, want, got in pairs(jax.device_get(want_tree), got_tree):
        got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
        scale = float(np.abs(want).max())
        atol = GRAD_RTOL * scale + GRAD_FLOOR
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=f"{what} {name}")
        worst = max(worst, float(np.abs(got - want).max())
                    / (scale + GRAD_FLOOR / GRAD_RTOL))
    return worst


def grads_of(loss, params):
    """d loss / d params as a nested dict of tensors (zeros where unused)."""
    leaves = []

    def walk(tree):
        for v in tree.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)
    walk(params)
    gs = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def build(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = build(v)
            else:
                g = next(gs)
                out[k] = torch.zeros_like(v) if g is None else g
        return out
    return build(params)


def sync(jp, tp):
    """Give the port pipeline the reference's parameters, optimizer and
    model state."""
    tp.load_params(params_from_jax(jax.device_get(jp.params)))
    tp.load_opt_state(opt_state_from_jax(jax.device_get(jp.opt_state)))
    if tp.stateful:
        tp.load_model_state(state_from_jax(jax.device_get(jp.model_state)))


__all__ = ["FWD", "GRAD_RTOL", "GRAD_FLOOR", "MRR_TOL", "recipe_batches",
           "jax_batch", "torch_batch", "port_params", "pairs",
           "assert_grads_close", "grads_of", "sync"]
