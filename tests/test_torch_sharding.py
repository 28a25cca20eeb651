"""The port's ``distributed.sharding``, ``compression`` and shard-aware
fused layer against the reference.

In process: the logical-axis rules (``logical_spec`` against the
reference's rule arithmetic on the same axis sizes), ``shard`` (the
identity without a mesh, refused under one: ROADMAP A6),
``node_rows_per_shard``, and ``quantize_int8`` bit-equal to the
reference's. In worlds of 2 and 3 gloo ranks (``tests/_torch_dist.py``,
each run once per module):

* the meshes over the world, and the ones it cannot hold refused;
* ``fused_temporal_layer_sharded`` (plain version) over the node shards of
  a recency buffer: the output bit-equal to the port's one-device layer
  (one owner per seed, exact zeros elsewhere) and within the harness's
  float32 tolerance of the reference's ``fused_temporal_layer(mode="ref")``
  and of its ``fused_temporal_layer_sharded(mode="ref")`` under
  ``jax.vmap`` over the same blocks (the two packages round differently:
  XLA and ATen, up to 3.7e-6 on these inputs, so not to the bit across
  packages); every operand's gradient within 1e-6 of the one-device
  gradient (the reference's ``test_sharded_fused_layer_bit_parity``
  bound) and within the harness's 1e-4 of the reference's;
* ``sync_state_masked_psum`` and ``psum_compressed`` (each scheme) against
  the reference's run under ``jax.vmap(..., axis_name=...)`` over the
  stacked per-rank inputs, and the int8 error feedback bit-equal.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jcomp
from repro.distributed import sharding as jsh
from repro.kernels.temporal_attention import ops as jops
from repro_torch.core import DeviceRecencySampler
from repro_torch.distributed import compression, sharding
from repro_torch.kernels.temporal_attention import fused_temporal_layer
from tests._torch_dist import run_world

FWD = dict(rtol=2e-5, atol=2e-5)     # tests/kernels/harness.py, float32
GRAD = dict(rtol=1e-4, atol=1e-4)
SHARD_GRAD = dict(rtol=1e-6, atol=1e-6)
WORLDS = (2, 3)
N, K, H, D, S = 23, 4, 2, 8, 16
D_TIME, D_EDGE, E = 6, 5, 60


def test_logical_spec_follows_the_reference_rules():
    rules = dict(jsh.DEFAULT_RULES)
    for sizes in ({"data": 2, "model": 4}, {"pod": 2, "data": 2, "model": 2}):
        fake = types.SimpleNamespace(shape=sizes, axis_names=tuple(sizes))
        for logical, shape in ((("batch", "mlp"), (8, 16)),
                               (("batch", "mlp"), (8, 5)),
                               (("batch", None), (3, 5)),
                               (("seq_shard", "heads", "nodes"), (12, 8, 6)),
                               (("vocab", "embed_fsdp"), (6, 4))):
            want = jsh._mesh_axes_for(logical, rules, fake, shape)
            assert list(sharding.logical_spec(logical, mesh=sizes,
                                              shape=shape)) == want
            assert list(sharding.logical_spec(logical, mesh=sizes)) == \
                jsh._mesh_axes_for(logical, rules, fake)
    assert sharding.logical_spec(("batch",)) == ()
    assert sharding.DEFAULT_RULES == jsh.DEFAULT_RULES


def test_shard_is_the_identity_without_a_mesh_and_refused_under_one():
    x = torch.arange(6.0)
    assert sharding.shard(x, "batch") is x
    with sharding.sharding_context({"data": 2}):
        assert sharding.get_mesh() == {"data": 2}
        with pytest.raises(NotImplementedError, match="A6"):
            sharding.shard(x, "batch")
    assert sharding.get_mesh() is None
    assert sharding.get_rules() == sharding.DEFAULT_RULES


def test_rows_per_shard_and_int8_quantization_match_the_reference():
    for n, s in ((23, 2), (23, 3), (9000, 4), (1, 5)):
        assert sharding.node_rows_per_shard(n, s) == jsh.node_rows_per_shard(n, s)
    rng = np.random.default_rng(0)
    for scale in (1e-3, 1.0, 300.0):
        x = (rng.standard_normal((7, 33)) * scale).astype(np.float32)
        q, s = compression.quantize_int8(torch.from_numpy(x))
        jq, js = jcomp.quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            compression.dequantize_int8(q, s).numpy(),
            np.asarray(jcomp.dequantize_int8(jq, js)))


# ----------------------------------------------------------------------
def _fused_payload():
    rng = np.random.default_rng(0)
    plain = DeviceRecencySampler(N, K, device="cpu")
    for _ in range(3):
        src, dst = rng.integers(0, N, 20), rng.integers(0, N, 20)
        t = np.sort(rng.integers(0, 50, 20))
        plain.update(src, dst, t, rng.integers(0, E, 20))
    f32 = lambda *s, sc=0.25: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    diff = {"q": f32(S, H, D), "k_table": f32(N, H, D), "v_table": f32(N, H, D),
            "time_w": f32(D_TIME, sc=0.1), "time_b": f32(D_TIME, sc=0.1),
            "wt_k": f32(D_TIME, H * D), "wt_v": f32(D_TIME, H * D),
            "we_k": f32(D_EDGE, H * D), "we_v": f32(D_EDGE, H * D)}
    aux = {"seeds": rng.integers(0, N, S).astype(np.int32),
           "seed_times": np.full(S, 60, np.int32),
           "edge_feats": f32(E, D_EDGE, sc=1.0)}
    aux["seeds"][:3] = -1  # padded seeds: zero rows on every shard
    return {"N": N, "K": K, "state": plain.state_dict(), "diff": diff,
            "aux": aux, "buf": plain.packed_buffer.numpy()}


def _sync_payload(world):
    rng = np.random.default_rng(world)
    return {"state": {"memory": rng.standard_normal((world, 9, 3)).astype(np.float32),
                      "last_update": rng.integers(0, 1000, (world, 9)).astype(np.int32)},
            "touched": rng.random((world, 9)) < 0.5}


def _compression_payload(world):
    rng = np.random.default_rng(10 + world)
    return {"grads": {"w": rng.standard_normal((world, 4, 5)).astype(np.float32),
                      "b": (rng.standard_normal((world, 5)) * 1e-3).astype(np.float32)},
            "err": {"w": (rng.standard_normal((world, 4, 5)) * 1e-2).astype(np.float32),
                    "b": (rng.standard_normal((world, 5)) * 1e-5).astype(np.float32)}}


@pytest.fixture(scope="module", params=WORLDS)
def world(request):
    w = request.param
    payload = {"fused": _fused_payload(), "sync": _sync_payload(w),
               "compression": _compression_payload(w)}
    return w, payload, run_world(["mesh", "fused", "sync", "compression"], w,
                                 payload)


def test_meshes_over_the_world_and_refusals(world):
    w, _, ranks = world
    for rank, res in enumerate(ranks):
        m = res["mesh"]
        assert m["node"] == (("nodes",), w, rank)
        assert m["same_mesh"]
        assert "world holds" in m["node_more"] and "world holds" in m["node_fewer"]
        assert "world holds" in m["2d_more"]
        if w % 2 == 0:
            names, d, n, node_ranks = m["2d"]
            assert names == ("data", "nodes") and (d, n) == divmod(rank, w // 2)
            assert node_ranks == [d * (w // 2) + i for i in range(w // 2)]
        names, shape = m["debug"]
        assert names == ("data", "model") and int(np.prod(shape)) == w


def test_sharded_fused_layer_is_bit_equal_to_one_device(world):
    w, payload, ranks = world
    p = payload["fused"]
    diff = {k: torch.tensor(v, requires_grad=True) for k, v in p["diff"].items()}
    aux = {k: torch.tensor(v) for k, v in p["aux"].items()}
    out = fused_temporal_layer(diff["q"], diff["k_table"], diff["v_table"],
                               aux["seeds"], aux["seed_times"],
                               torch.tensor(p["buf"]), mode="ref",
                               edge_feats=aux["edge_feats"],
                               **{k: v for k, v in diff.items()
                                  if k not in ("q", "k_table", "v_table")})
    grads = torch.autograd.grad(torch.sin(out).sum(), list(diff.values()))
    for res in ranks:
        got = res["fused"]
        np.testing.assert_array_equal(got["out"], out.detach().numpy())
        assert (got["out"][:3] == 0).all()
        for name, g in zip(diff, grads):
            np.testing.assert_allclose(got["grads"][name], g.numpy(),
                                       err_msg=name, **SHARD_GRAD)


@pytest.fixture(scope="module")
def fused_reference():
    """The reference's ``fused_temporal_layer(mode="ref")`` on the one-device
    buffer: output and gradients (seed times 60, slot times below 50: no
    delta where XLA's FMA would move the time encoding)."""
    p = _fused_payload()
    aux = {k: jnp.asarray(v) for k, v in p["aux"].items()}
    buf = jnp.asarray(p["buf"])

    def loss(d):
        o = jops.fused_temporal_layer(d["q"], d["k_table"], d["v_table"],
                                      aux["seeds"], aux["seed_times"], buf,
                                      mode="ref", edge_feats=aux["edge_feats"],
                                      **{k: v for k, v in d.items()
                                         if k not in ("q", "k_table", "v_table")})
        return jnp.sum(jnp.sin(o)), o

    (_, want), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in p["diff"].items()})
    return want, g


def test_sharded_fused_layer_matches_the_reference(world, fused_reference):
    """Against the reference's single-device layer, and its own
    ``fused_temporal_layer_sharded(mode="ref")`` run under ``jax.vmap``
    over the stacked per-shard blocks (axis ``"nodes"``), which is
    bit-equal to its single-device layer (its contract) and within the
    harness's tolerance of the port's sharded output on every shard."""
    w, payload, ranks = world
    want, g = fused_reference
    p = payload["fused"]
    per = jsh.node_rows_per_shard(N, w)
    blocks = np.zeros((w, per + 1, K, 3), np.int32)
    blocks[..., 0] = blocks[..., 2] = -1
    for s_ in range(w):
        rows = p["buf"][s_ * per:min((s_ + 1) * per, N)]
        blocks[s_, :len(rows)] = rows
    aux = {k: jnp.asarray(v) for k, v in p["aux"].items()}
    diff = {k: jnp.asarray(v) for k, v in p["diff"].items()}
    sharded = jax.jit(jax.vmap(lambda b: jops.fused_temporal_layer_sharded(
        diff["q"], diff["k_table"], diff["v_table"], aux["seeds"],
        aux["seed_times"], b, axis="nodes", rows_per_shard=per, mode="ref",
        edge_feats=aux["edge_feats"],
        **{k: v for k, v in diff.items() if k not in ("q", "k_table", "v_table")}),
        axis_name="nodes"))(jnp.asarray(blocks))
    for s_ in range(w):
        np.testing.assert_array_equal(np.asarray(sharded[s_]), np.asarray(want))
    for rank, res in enumerate(ranks):
        got = res["fused"]
        np.testing.assert_allclose(got["out"], np.asarray(sharded[rank]), **FWD)
        for name, gw in g.items():
            np.testing.assert_allclose(got["grads"][name].reshape(gw.shape),
                                       np.asarray(gw), err_msg=name, **GRAD)


def test_masked_sync_matches_the_reference_under_vmap(world):
    w, payload, ranks = world
    p = payload["sync"]
    want = jax.jit(jax.vmap(
        lambda st, m: jsh.sync_state_masked_psum(st, m, "data"),
        axis_name="data"))(
        {k: jnp.asarray(v) for k, v in p["state"].items()},
        jnp.asarray(p["touched"]))
    for rank, res in enumerate(ranks):
        np.testing.assert_allclose(res["sync"]["memory"],
                                   np.asarray(want["memory"][rank]), **FWD)
        np.testing.assert_array_equal(res["sync"]["last_update"],
                                      np.asarray(want["last_update"][rank]))
    # Rows touched on one rank take its value exactly; untouched rows keep
    # the local one.
    touched = p["touched"]
    mem = p["state"]["memory"]
    for rank, res in enumerate(ranks):
        one = touched.sum(0) == 1
        owner = touched.argmax(0)
        np.testing.assert_array_equal(res["sync"]["memory"][one],
                                      mem[owner[one], np.flatnonzero(one)])
        none = touched.sum(0) == 0
        np.testing.assert_array_equal(res["sync"]["memory"][none], mem[rank][none])


@pytest.mark.parametrize("scheme", ["none", "bf16", "int8_ef"])
def test_compressed_psum_matches_the_reference_under_vmap(world, scheme):
    w, payload, ranks = world
    p = payload["compression"]
    grads = {k: jnp.asarray(v) for k, v in p["grads"].items()}
    err = {k: jnp.asarray(v) for k, v in p["err"].items()}

    def body(g, e):
        wire, new_e, _ = jcomp.compress_grads(g, e, scheme)
        return jcomp.psum_compressed(wire, scheme, "data"), new_e

    # Level 0 contracts no ``g + e - q * s`` into an FMA: the reference then
    # rounds the error feedback as it does op by op.
    red, new_err = jax.jit(jax.vmap(body, axis_name="data")).lower(
        grads, err).compile(
        compiler_options={"xla_backend_optimization_level": 0})(grads, err)
    for rank, res in enumerate(ranks):
        got = res["compression"][scheme]
        for k in grads:
            np.testing.assert_allclose(got["reduced"][k], np.asarray(red[k][rank]),
                                       err_msg=k, **FWD)
            np.testing.assert_array_equal(got["err"][k], np.asarray(new_err[k][rank]))
