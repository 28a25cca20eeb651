"""The port's inference slice as a whole holds against the JAX pipeline.

Both ``CTDGLinkPipeline``s run 1-layer TGAT over the device recency sampler
(k=10) on synthetic ``wikipedia`` at ``scale=0.01``, the port on the CPU
with the reference's parameters (``params_from_jax``): the hooks produce
the same tensors batch by batch, and ``evaluate("val")`` MRRs agree within
1e-4. The tolerance covers float ties: MRR counts an exact tie as half a
rank, and the reference's two decoder passes can round a negative equal to
the positive destination apart from it, while the port keeps the tie.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.core import DGDataLoader as JaxLoader, DGraph as JaxGraph
from repro.data import generate as jax_generate
from repro.tg.specs import SamplerSpec as JaxSamplerSpec
from repro.train.loop import CTDGLinkPipeline as JaxPipeline
from repro_torch.convert import params_from_jax
from repro_torch.data import generate
from repro_torch.tg import DataSpec, Experiment, ModelSpec, SamplerSpec, TrainSpec
from repro_torch.train.loop import CTDGLinkPipeline

MRR_TOL = 1e-4
KW = dict(batch_size=200, eval_negatives=20, model_kwargs={"num_layers": 1})


@pytest.fixture(scope="module")
def pipelines():
    jp = JaxPipeline("tgat", jax_generate("wikipedia", scale=0.01),
                     sampler_spec=JaxSamplerSpec(device=True, k=10),
                     fused="ref", **KW)
    tp = CTDGLinkPipeline("tgat", generate("wikipedia", scale=0.01),
                          sampler_spec=SamplerSpec(device=True, k=10),
                          device="cpu", **KW)
    tp.load_params(params_from_jax(jax.device_get(jp.params)))
    return jp, tp


@pytest.mark.parametrize("key", ["train", "eval"])
def test_hook_outputs_match_on_first_batches(pipelines, key):
    jp, tp = pipelines
    jp.reset_epoch_state()
    tp.reset_epoch_state()
    with jp.manager.activate(key):
        jb = [b for _, b in zip(range(3), JaxLoader(JaxGraph(jp.train_data),
                                                   jp.manager, batch_size=200))]
    with tp.manager.activate(key):
        tb = [b for _, b in zip(range(3), tp._loader(tp.train_data))]
    for j, t in zip(jb, tb):
        assert set(j.keys()) == set(t.keys())
        for name in j.keys():
            want = np.asarray(j[name])
            got = t[name].cpu().numpy()
            if want.dtype == np.int64:
                want = want.astype(np.int32)  # staged as int32 in both
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_evaluate_val_mrr_matches_jax(pipelines):
    jp, tp = pipelines
    want, _ = jp.evaluate("val")
    got, _ = tp.evaluate("val")
    assert abs(got - want) <= MRR_TOL, (got, want)
    # The classic pre-gathered path gives the same ranking.
    tp.fused = False
    try:
        classic, _ = tp.evaluate("val")
    finally:
        tp.fused = None
    assert abs(classic - got) <= MRR_TOL


def test_experiment_compiles_the_link_quadrant_on_cpu():
    exp = Experiment(data=DataSpec("tiny"), model=ModelSpec("tgat", {"num_layers": 1}),
                     sampler=SamplerSpec(kind="recency", k=4, device=True),
                     train=TrainSpec(batch_size=100, eval_negatives=5))
    pipe = exp.compile(device="cpu")
    assert pipe.device == torch.device("cpu")
    mrr, _ = pipe.evaluate("test")
    assert 0.0 < mrr <= 1.0
    assert Experiment.from_json(exp.to_json()) == exp
    # The rest of the CTDG zoo compiles.
    for name, kw in (("graphmixer", {"d_model": 16, "d_time": 8}),
                     ("dygformer", {"d_model": 16, "d_time": 8, "d_cooc": 4}),
                     ("tpnet", {"d_rp": 8, "d_hidden": 16})):
        pipe = Experiment(data=DataSpec("tiny"), model=ModelSpec(name, kw),
                          sampler=SamplerSpec(k=4),
                          train=TrainSpec(batch_size=100, eval_negatives=5)
                          ).compile(device="cpu")
        assert pipe.model_name == name and pipe.cfg.num_nodes == 80
    # A mesh-sharded uniform sampler compiles over an initialized world:
    # here one gloo rank, so one shard holding every node (the multi-rank
    # runs are tests/test_torch_{sharded_sampler,distributed}.py); two
    # shards ask for ranks this world lacks and are refused.
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    with pytest.MonkeyPatch.context() as mp:
        for key, value in env.items():
            mp.setenv(key, value)
        assert init_distributed("gloo", device="cpu") == torch.device("cpu")
    try:
        sharded = Experiment(data=DataSpec("tiny"),
                             model=ModelSpec("tgat", {"num_layers": 1}),
                             sampler=SamplerSpec(kind="uniform", k=4, device=True,
                                                 shards=1, partition="degree"),
                             train=TrainSpec(batch_size=100, eval_negatives=5))
        pipe = sharded.compile(device="cpu")
        hooks = [h for h in pipe.manager.hooks() if hasattr(h, "sampler")]
        assert hooks[0].sampler._mesh.mesh_dim_names == ("data",)
        assert hooks[0].sampler.partition == "degree"
        mrr, _ = pipe.evaluate("test")
        assert 0.0 < mrr <= 1.0
        with pytest.raises(ValueError, match="world holds 1"):
            Experiment(data=DataSpec("tiny"),
                       sampler=SamplerSpec(kind="uniform", device=True, shards=2)
                       ).compile(device="cpu")
    finally:
        dist.destroy_process_group()
    # With snapshots the quadrant is DTDG: an event-stream model is refused
    # (tests/test_torch_dtdg_pipeline.py compiles the snapshot models).
    with pytest.raises(ValueError, match="not a snapshot"):
        Experiment(data=DataSpec("tiny", discretization="h")).compile(device="cpu")
