"""Rank programs of the port's multi-rank CPU tests.

``run_world(names, world, payload)`` starts ``world`` processes with
``torch.multiprocessing`` from a forkserver (one per test process, torch
and the port imported there once, so a rank starts without importing them
again; the server is a fresh process, not a fork of the test process and
its threads); each joins a gloo group on the CPU through a
file store in a fresh temporary directory (no port to race for between
test workers) and runs the named programs below in order, every rank the
same Python (``launch.mesh.init_distributed``, the torchrun path, is held
in ``tests/test_torch_imports.py`` and ``tests/test_torch_pipeline.py``). Each rank's ``{name: result}`` is saved and the list, indexed by
rank, returned. The programs import the port only; the tests hold their
results against the reference in the parent process.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch


def _entry(rank, world, names, payload, out):
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=world)
    try:
        results = {name: PROGRAMS[name](payload.get(name)) for name in names}
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


_PRELOAD = ["torch", "torch.distributed", "repro_torch.train.loop",
            "repro_torch.distributed", "repro_torch.launch.mesh"]


def run_world(names, world: int, payload=None):
    """Run the programs ``names`` on ``world`` gloo ranks; returns the
    per-rank ``{name: result}`` dicts."""
    import multiprocessing

    payload = payload or {}
    multiprocessing.set_forkserver_preload(_PRELOAD)
    with tempfile.TemporaryDirectory() as out:
        torch.multiprocessing.start_processes(
            _entry, args=(world, list(names), payload, out), nprocs=world,
            join=True, start_method="forkserver")
        return [torch.load(os.path.join(out, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def _np(t):
    return t.detach().cpu().numpy().copy()


def _block(blk):
    return {"ids": _np(blk.nbr_ids), "times": _np(blk.nbr_times),
            "eids": _np(blk.nbr_eids), "mask": _np(blk.mask)}


# ----------------------------------------------------------------------
# Samplers
# ----------------------------------------------------------------------
def recency_program(p):
    """The node-sharded recency sampler over the payload's batches (a
    sample of the payload's seeds after each update), its canonical state;
    then the one-shard state ``p["state1"]`` loaded and the last batches
    replayed, and this mesh's state loaded by a one-device sampler, which
    replays them too."""
    import torch.distributed as dist

    from repro_torch.core import DeviceRecencySampler
    from repro_torch.distributed.sharding import make_node_mesh

    mesh = make_node_mesh(dist.get_world_size(), "nodes")
    sh = DeviceRecencySampler(p["N"], p["K"], device="cpu", mesh=mesh,
                              mesh_axis="nodes")

    def replay(sampler, batches):
        outs = []
        for (src, dst, t, eids, valid), seeds in batches:
            sampler.update(src, dst, t, eids, valid=valid)
            outs.append(_block(sampler.sample(seeds)))
        return outs

    pairs = list(zip(p["batches"], p["seeds"]))
    res = {"rows_per_shard": sh.rows_per_shard,
           "block_rows": int(sh.packed_buffer.shape[0]),
           "samples": replay(sh, pairs), "state": sh.state_dict(),
           "buffer_ids": _np(sh.buffer_ids), "rank": dist.get_rank()}
    sh.load_state_dict(p["state1"])
    res["resumed"] = replay(sh, pairs[1:])
    one = DeviceRecencySampler(p["N"], p["K"], device="cpu")
    one.load_state_dict(res["state"])
    sh.load_state_dict(res["state"])
    res["one_from_sharded"] = replay(one, pairs[:1])
    res["sharded_again"] = replay(sh, pairs[:1])
    return res


def uniform_program(p):
    """The node-sharded uniform sampler under both partitions: samples of
    the payload's queries, the canonical state, and a one-shard state
    loaded and replayed."""
    import torch.distributed as dist

    from repro_torch.core import DeviceUniformSampler
    from repro_torch.distributed.sharding import make_node_mesh

    mesh = make_node_mesh(dist.get_world_size(), "nodes")
    res = {}
    for partition in ("rows", "degree"):
        sh = DeviceUniformSampler(p["N"], p["K"], seed=3, device="cpu",
                                  mesh=mesh, mesh_axis="nodes",
                                  partition=partition)
        sh.build(*p["stream"])
        out = {"bounds": (sh._adj["lo"], sh._adj["hi"]), "L": sh._adj["L"],
               "samples": [_block(sh.sample(s, q)) for s, q in p["queries"]],
               "prefix": [tuple(_np(x) for x in sh.prefix(s, q))
                          for s, q in p["queries"][:1]],
               "state": sh.state_dict()}
        sh.load_state_dict(p["state1"])
        out["resumed"] = [_block(sh.sample(s, q)) for s, q in p["queries"][1:]]
        res[partition] = out
    return res


# ----------------------------------------------------------------------
# Meshes, collectives and the fused layer
# ----------------------------------------------------------------------
def mesh_program(p):
    """Meshes over the world, the ones it cannot hold refused."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_debug_mesh

    world = dist.get_world_size()
    res = {}
    m = sharding.make_node_mesh(world, "nodes")
    res["node"] = (m.mesh_dim_names, sharding.axis_size(m, "nodes"),
                   sharding.axis_index(m, "nodes"))
    res["same_mesh"] = sharding.make_node_mesh(world, "nodes") is m
    for what, fn in (("node_more", lambda: sharding.make_node_mesh(world + 1)),
                     ("node_fewer", lambda: sharding.make_node_mesh(1)),
                     ("2d_more", lambda: sharding.make_2d_mesh(world, 2))):
        try:
            fn()
            res[what] = None
        except ValueError as exc:
            res[what] = str(exc)
    if world % 2 == 0:
        m2 = sharding.make_2d_mesh(2, world // 2)
        res["2d"] = (m2.mesh_dim_names, sharding.axis_index(m2, "data"),
                     sharding.axis_index(m2, "nodes"),
                     dist.get_process_group_ranks(sharding.axis_group(m2, "nodes")))
    dm = make_debug_mesh()
    res["debug"] = (dm.mesh_dim_names, tuple(dm.mesh.shape))
    return res


def fused_program(p):
    """``fused_temporal_layer_sharded`` (plain version) over this world's
    node shards of the payload's buffer: the output and the gradients of
    ``sum(sin(out))`` for every differentiable operand."""
    import torch.distributed as dist

    from repro_torch.core import DeviceRecencySampler
    from repro_torch.distributed.sharding import axis_group, make_node_mesh
    from repro_torch.kernels.temporal_attention import (
        fused_temporal_layer_sharded,
    )

    mesh = make_node_mesh(dist.get_world_size(), "nodes")
    sh = DeviceRecencySampler(p["N"], p["K"], device="cpu", mesh=mesh,
                              mesh_axis="nodes")
    sh.load_state_dict(p["state"])
    diff = {k: torch.tensor(v, requires_grad=True) for k, v in p["diff"].items()}
    aux = {k: torch.tensor(v) for k, v in p["aux"].items()}
    out = fused_temporal_layer_sharded(
        diff["q"], diff["k_table"], diff["v_table"], aux["seeds"],
        aux["seed_times"], sh.packed_buffer, group=axis_group(mesh, "nodes"),
        rows_per_shard=sh.rows_per_shard, mode="ref",
        edge_feats=aux.get("edge_feats"),
        **{k: v for k, v in diff.items()
           if k not in ("q", "k_table", "v_table")})
    grads = torch.autograd.grad(torch.sin(out).sum(), list(diff.values()))
    return {"out": _np(out),
            "grads": {k: _np(g) for k, g in zip(diff, grads)}}


def sync_program(p):
    """``sync_state_masked_psum`` of this rank's state and mask."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import sync_state_masked_psum

    r = dist.get_rank()
    state = {k: torch.tensor(v[r]) for k, v in p["state"].items()}
    out = sync_state_masked_psum(state, torch.tensor(p["touched"][r]),
                                 dist.group.WORLD)
    return {k: _np(v) for k, v in out.items()}


def compression_program(p):
    """``compress_grads`` and ``psum_compressed`` of this rank's gradients
    under each scheme, and the int8 error feedback it keeps."""
    import torch.distributed as dist

    from repro_torch.distributed import compression as comp

    r = dist.get_rank()
    grads = {k: torch.tensor(v[r]) for k, v in p["grads"].items()}
    err = {k: torch.tensor(v[r]) for k, v in p["err"].items()}
    res = {}
    for scheme in ("none", "bf16", "int8_ef"):
        wire, new_err, _ = comp.compress_grads(grads, err, scheme)
        red = comp.psum_compressed(wire, scheme, dist.group.WORLD)
        res[scheme] = {"reduced": {k: _np(v) for k, v in red.items()},
                       "err": {k: _np(v) for k, v in new_err.items()}}
    return res


def dp_program(p):
    """``DataParallelTrainer`` over the world: one uncompressed step from
    the identity, and 30 steps each without compression and with
    ``int8_ef`` (the reference's tests' loss and data)."""
    import torch.distributed as dist

    from repro_torch.distributed import DataParallelTrainer
    from repro_torch.distributed.sharding import make_node_mesh
    from repro_torch.optim import AdamWConfig

    mesh = make_node_mesh(dist.get_world_size(), "data")
    x = torch.tensor(p["x"])

    def loss_fn(params, state, batch):
        return ((batch["x"] @ params["w"] - 1.0) ** 2).mean(), (state, None)

    res = {}
    for scheme in ("none", "int8_ef"):
        params = {"w": torch.eye(x.shape[-1])}
        tr = DataParallelTrainer(loss_fn, mesh, AdamWConfig(lr=1e-2),
                                 compression=scheme)
        opt, err = tr.init(params)
        tr.build_step(stateful=False)
        losses = []
        for i in range(30):
            params, opt, err, _, loss = tr.step(params, opt, err, {}, {"x": x})
            losses.append(float(loss))
            if i == 0 and scheme == "none":
                res["w_after_one"] = _np(params["w"])
        res[scheme] = losses
    return res


# ----------------------------------------------------------------------
# The CTDG pipeline on meshes
# ----------------------------------------------------------------------
PIPE = dict(batch_size=100, seed=0, device="cpu")
# 2-layer TGAT (the reference's default depth, the hop-2 frontier sharded
# too) at narrow widths.
TGAT = {"d_model": 16, "d_time": 8}
TGN = {"d_model": 16, "d_time": 8, "d_memory": 16}


def _tiny():
    from repro_torch.data import generate

    return generate("tiny").slice_events(0, 300)


def _params(pipe):
    from repro_torch.tree import tree_leaves

    return [_np(x) for x in tree_leaves(pipe.params)]


def pipeline_1d_program(p):
    """One epoch of 2-layer TGAT with ``SamplerSpec(device=True,
    shards=world)`` (the 1-D node mesh, model steps replicated); rank 0
    also runs the one-device pipeline with the same spec unsharded."""
    import torch.distributed as dist

    from repro_torch.tg import SamplerSpec
    from repro_torch.train.loop import CTDGLinkPipeline

    data = _tiny()
    w = dist.get_world_size()
    pipe = CTDGLinkPipeline("tgat", data, sampler_spec=SamplerSpec(
        device=True, shards=w), model_kwargs=TGAT, **PIPE)
    res = {"mesh": pipe._mesh.mesh_dim_names, "use_2d": pipe._use_2d,
           "exposed": any("nbr_buf" in h.produces for h in pipe.manager.hooks()),
           "loss": pipe.train_epoch()[0], "params": _params(pipe),
           "state": pipe.manager.state_dict()}
    if dist.get_rank() == 0:
        one = CTDGLinkPipeline("tgat", data, sampler_spec=SamplerSpec(
            device=True, expose_buffer=False), model_kwargs=TGAT, **PIPE)
        res["one_loss"] = one.train_epoch()[0]
        res["one_params"] = _params(one)
        res["one_state"] = one.manager.state_dict()
    return res


def graphmixer_2d_program(p):
    """GraphMixer (no fused layer: the reference's stateless branch) with
    ``data_shards=world`` over the 2-D mesh ``(world, 1)``: one epoch and
    val MRR; rank 0 also runs them on one device."""
    import torch.distributed as dist

    from repro_torch.tg import SamplerSpec
    from repro_torch.train.loop import CTDGLinkPipeline

    data = _tiny()
    kw = dict(sampler_spec=SamplerSpec(device=True, k=4),
              model_kwargs={"d_model": 16, "d_time": 8}, **PIPE)
    pipe = CTDGLinkPipeline("graphmixer", data, data_shards=dist.get_world_size(),
                            **kw)
    res = {"mesh": tuple(pipe._mesh.mesh.shape), "loss": pipe.train_epoch()[0],
           "mrr": pipe.evaluate("val")[0]}
    if dist.get_rank() == 0:
        one = CTDGLinkPipeline("graphmixer", data, **kw)
        res["one_loss"] = one.train_epoch()[0]
        res["one_mrr"] = one.evaluate("val")[0]
    return res


def _build_2d(data, ds, ns, model="tgat", kwargs=TGAT):
    from repro_torch.tg import SamplerSpec
    from repro_torch.train.loop import CTDGLinkPipeline

    spec = SamplerSpec(kind="recency", device=True, shards=ns,
                       expose_buffer=True if ns else None)
    return CTDGLinkPipeline(model, data, sampler_spec=spec, data_shards=ds,
                            fused="ref", model_kwargs=kwargs, **PIPE)


def pipeline_2d_program(p):
    """2-layer TGAT on the 2 x (world / 2) mesh with ``fused="ref"``: one
    epoch (loss, parameters), val MRR, a checkpoint written then
    (``p["dir"]``) and a second epoch; rank 0 also runs the same on one
    device (1 x 1), the second epoch from the mesh's checkpoint."""
    import torch.distributed as dist

    data = _tiny()
    w = dist.get_world_size()
    pipe = _build_2d(data, 2, w // 2)
    res = {"mesh": (pipe._mesh.mesh_dim_names, tuple(pipe._mesh.mesh.shape)),
           "buf_rows": pipe._buf_rows, "loss": pipe.train_epoch()[0],
           "params": _params(pipe), "mrr": pipe.evaluate("val")[0]}
    res["path"] = pipe.save_checkpoint(p["dir"], 0)
    res["written"] = os.listdir(p["dir"])
    res["loss2"] = pipe.train_epoch()[0]
    res["params2"] = _params(pipe)
    if dist.get_rank() == 0:
        one = _build_2d(data, 1, None)
        res["one_mesh"] = one._mesh
        res["one_loss"] = one.train_epoch()[0]
        res["one_params"] = _params(one)
        res["one_mrr"] = one.evaluate("val")[0]
        one.restore_checkpoint(p["dir"])
        res["restored_loss2"] = one.train_epoch()[0]
        res["restored_params2"] = _params(one)
    return res


def tgn_2d_program(p):
    """TGN on the 2 x (world / 2) mesh (``fused="ref"``): one train step,
    then the second recorded: the full batch with the canonical pre-update
    buffer, the parameters and memory before it, its loss, the gradients
    it applied and the memory after the masked sync."""
    import torch.distributed as dist

    from repro_torch.core import TRAIN_KEY
    from repro_torch.tree import tree_map

    def params_to_numpy(tree):  # copies: AdamW updates in place
        return tree_map(_np, tree)

    data = _tiny()
    w = dist.get_world_size()
    pipe = _build_2d(data, 2, w // 2, model="tgn", kwargs=TGN)
    seen = {}
    update = pipe._update

    def spy(grads):
        seen["grads"] = params_to_numpy(grads)
        update(grads)

    pipe.reset_epoch_state()
    with pipe.manager.activate(TRAIN_KEY):
        for i, batch in enumerate(pipe._loader(pipe.train_data)):
            if i == 1:
                break
            pipe._train_step(batch)
        # The canonical buffer the batch was sampled from: every node
        # shard's block, one owner per row.
        per, lo = pipe._buf_rows, pipe._buf_rows * pipe._mesh.get_local_rank("nodes")
        n = pipe.cfg.num_nodes
        full = torch.zeros((n + 1, batch["nbr_buf"].shape[1], 3), dtype=torch.int32)
        m = max(min(lo + per, n) - lo, 0)
        full[lo:lo + m] = batch["nbr_buf"][:m]
        dist.all_reduce(full, group=pipe._node_group)
        full[n] = torch.tensor([-1, 0, -1], dtype=torch.int32)
        host = {k: _np(batch[k]) for k in batch.keys() if k != "nbr_buf"}
        host["nbr_buf"] = _np(full)
        res = {"batch": host, "params": params_to_numpy(pipe.params),
               "state": {k: _np(v) for k, v in pipe.model_state.items()}}
        pipe._update = spy
        res["loss"] = float(pipe._train_step(batch))
        res["grads"] = seen["grads"]
        res["new_state"] = {k: _np(v) for k, v in pipe.model_state.items()}
        res["params_after"] = params_to_numpy(pipe.params)
    res["B"], res["data_shards"] = pipe.batch_size, pipe.data_shards
    res["cfg"] = dict(num_nodes=pipe.cfg.num_nodes, d_edge=pipe.cfg.d_edge,
                      k=pipe.cfg.k, **TGN)
    return res


PROGRAMS = {
    "recency": recency_program,
    "uniform": uniform_program,
    "mesh": mesh_program,
    "fused": fused_program,
    "sync": sync_program,
    "compression": compression_program,
    "dp": dp_program,
    "pipeline_1d": pipeline_1d_program,
    "graphmixer_2d": graphmixer_2d_program,
    "pipeline_2d": pipeline_2d_program,
    "tgn_2d": tgn_2d_program,
}
