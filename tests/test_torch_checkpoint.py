"""Checkpoints cross between the packages, in both directions.

The reference (``repro.train.loop.CTDGLinkPipeline``, ``fused="ref"``) and
the port (``device="cpu"``) run the quickstart at ``scale=0.01``: 1-layer
TGAT, device recency sampler k=10, batch 200. A checkpoint holds the
parameters, the AdamW state and the sampler buffers, in the reference's
layout (``ckpt_<step>/manifest.json`` + ``leaf_<i>.npy``, keys joined by
``/`` in sorted order). Whatever one package writes, the other restores
bit for bit. The epoch after a restore runs freely, so it is held to the
reference's own spread in an epoch's mean loss (1e-2; see
``tests/test_torch_train.py`` for why training is chaotic here).
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest

from repro.data import generate as jax_generate
from repro.tg.specs import SamplerSpec as JaxSamplerSpec
from repro.train.loop import CTDGLinkPipeline as JaxPipeline
from repro_torch.convert import (
    opt_state_from_jax,
    opt_state_to_numpy,
    params_from_jax,
    params_to_numpy,
)
from repro_torch.data import generate
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.tg import SamplerSpec
from repro_torch.train.loop import CTDGLinkPipeline

KW = dict(batch_size=200, eval_negatives=20, model_kwargs={"num_layers": 1})
EPOCH_LOSS_TOL = 1e-2


@pytest.fixture(scope="module")
def pipelines():
    jp = JaxPipeline("tgat", jax_generate("wikipedia", scale=0.01),
                     sampler_spec=JaxSamplerSpec(device=True, k=10),
                     fused="ref", **KW)
    tp = CTDGLinkPipeline("tgat", generate("wikipedia", scale=0.01),
                          sampler_spec=SamplerSpec(device=True, k=10),
                          device="cpu", **KW)
    tp.load_params(params_from_jax(jax.device_get(jp.params)))
    tp.load_opt_state(opt_state_from_jax(jax.device_get(jp.opt_state)))
    return jp, tp


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _assert_same_state(jp, tp):
    """Parameters, optimizer state and sampler buffers bit-equal."""
    for name, want, got in (
            ("params", jax.device_get(jp.params), params_to_numpy(tp.params)),
            ("opt", jax.device_get(jp.opt_state),
             opt_state_to_numpy(tp.opt_state)),
            ("hooks", jp.manager.state_dict(), tp.manager.state_dict())):
        want, got = _flat(want), _flat(got)
        assert sorted(want) == sorted(got), name
        for k in want:
            assert got[k].dtype == want[k].dtype, (name, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}/{k}")


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_checkpoints_cross_both_ways(pipelines, tmp_path):
    jp, tp = pipelines
    jp.train_epoch()
    ref_path = jp.save_checkpoint(str(tmp_path / "ref"), 1)

    # Reference -> port: the restored state is the reference's, bit for bit.
    assert tp.restore_checkpoint(str(tmp_path / "ref")) == 1
    _assert_same_state(jp, tp)
    assert tp.params["nodes"]["emb"].requires_grad

    # Port -> reference, and the two manifests describe the same layout.
    port_path = tp.save_checkpoint(str(tmp_path / "port"), 1)
    want, got = _manifest(ref_path), _manifest(port_path)
    strip = lambda m: [(e["key"], e["file"], e["shape"], e["dtype"])  # noqa: E731
                       for e in m["leaves"]]
    assert strip(got) == strip(want)
    assert got["step"] == want["step"] == 1
    assert got["extra"] == want["extra"] == {"model_name": "tgat"}
    snapshot = _flat(jax.device_get(jp.params))
    jp.params = jax.tree.map(lambda x: x * 0, jp.params)  # overwritten below
    assert jp.restore_checkpoint(str(tmp_path / "port")) == 1
    _assert_same_state(jp, tp)
    for k, v in _flat(jax.device_get(jp.params)).items():
        np.testing.assert_array_equal(v, snapshot[k], err_msg=k)

    # Epoch 2 from the crossed state, in both packages.
    want_loss, _ = jp.train_epoch()
    got_loss, _ = tp.train_epoch()
    assert abs(got_loss - want_loss) <= EPOCH_LOSS_TOL, (got_loss, want_loss)


def test_torn_checkpoints_are_skipped_and_retention_keeps_three(tmp_path):
    d = str(tmp_path)
    tree = {"b": {"y": np.arange(3, dtype=np.int32)},
            "a": np.ones((2, 2), np.float32), "skip": None}
    for step in range(5):
        ckpt.save(d, step, tree, extra_meta={"step": step})
    assert sorted(ckpt.all_steps(d)) == [2, 3, 4]
    assert [e["key"] for e in _manifest(os.path.join(d, "ckpt_4"))["leaves"]] \
        == ["a", "b/y"]
    os.makedirs(os.path.join(d, "ckpt_9.tmp"))  # an unfinished write
    assert ckpt.latest_step(d) == 4

    leaf = os.path.join(d, "ckpt_4", "leaf_1.npy")
    with open(leaf, "r+b") as f:
        f.truncate(os.path.getsize(leaf) - 4)
    assert not ckpt.is_intact(os.path.join(d, "ckpt_4"))
    assert ckpt.latest_step(d) == 3
    with pytest.raises(RuntimeError, match="torn"):
        ckpt.restore(d, 4)
    flat, step, meta = ckpt.restore(d)
    assert step == 3 and meta == {"step": 3} and sorted(flat) == ["a", "b/y"]
    got, _, _ = ckpt.restore(d, target={"a": 0, "b": {"y": 0}})
    np.testing.assert_array_equal(got["b"]["y"], [0, 1, 2])
    with pytest.raises(KeyError):
        ckpt.assemble(flat, {"c": 0})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"))
