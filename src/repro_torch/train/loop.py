"""Link prediction pipelines (CTDG and DTDG) and the epoch engine.

  * ``CTDGLinkPipeline`` — the TGB link recipe over the recency or the
    uniform sampler (on the host, or on the device), TGAT (1 or 2 layers),
    TGN, GraphMixer, DyGFormer or TPNet and one-vs-many MRR, on one device
    (``device="cuda"`` by default) or on a mesh of ranks (node-sharded
    samplers, data-sharded steps): ``train_epoch`` (masked BCE, backward
    through the attention kernels' backward kernels where the model has
    them, AdamW), ``evaluate(split)`` and checkpoints, with TGN's memory
    and TPNet's walk features threaded through as ``model_state``,
    following ``repro.train.loop.CTDGLinkPipeline``.
    The hooks and the staging of each batch run in the calling thread,
    between steps: with an eager step, ``PrefetchLoader``'s producer thread
    (the reference's choice when its sampler is on the device) contends
    with the step for the interpreter lock at every op and is slower
    (``chip_smoke.py --profile``, ``loader`` phase);
  * ``DTDGLinkPipeline`` (legacy alias ``SnapshotLinkTrainer``) — snapshot
    link prediction over the device ``SnapshotTensor`` with GCN, GCLSTM or
    T-GCN, every segment aggregation through the segment-sum kernel on the
    card; the reference's ``lax.scan`` epoch becomes a Python loop over
    prediction pairs running the same step (``SnapshotPairPipeline`` holds
    the split and pair plumbing);
  * the node task's pipelines (``DTDGNodePipeline``, ``EventNodePipeline``)
    live in ``train/nodeprop.py`` on ``SnapshotPairPipeline`` and
    ``_ParamsAndOptimizer``;
  * ``TrainLoop`` — the epoch engine: ``train_epoch`` / ``evaluate`` /
    ``save_checkpoint`` at the requested cadences, its history rebuilt from
    the telemetry records it emits;
  * the checkpoint bundle helpers (``save_bundle`` / ``restore_bundle`` /
    ``restore_with_saved_hooks``), in the reference's layout.

Pipeline surface (duck-typed, consumed by ``TrainLoop``):

  ``train_epoch() -> (mean_loss, seconds)``
  ``evaluate(split) -> (metric, seconds)``      # split in {val, test}
  ``save_checkpoint(ckpt_dir, step) -> path``
  ``restore_checkpoint(ckpt_dir, step=None) -> step``
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import (
    DGData,
    DGDataLoader,
    DGraph,
    EVAL_KEY,
    RECIPE_DTDG_SNAPSHOT,
    RECIPE_TGB_LINK,
    RecipeRegistry,
    TRAIN_KEY,
    TimeDelta,
    snapshot_tensor,
)
from repro_torch.core.batch import Batch
from repro_torch.core.tg_hooks import (
    DeviceRecencyNeighborHook,
    UniformNeighborHook,
    stage_batch,
)
from repro_torch.device import resolve_device
import torch.distributed as dist

from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.sharding import (
    all_reduce_flat,
    all_reduce_tree,
    axis_group,
    axis_index,
    make_2d_mesh,
    make_node_mesh,
    sync_state_masked_psum,
)
from repro_torch.models.tg import dygformer, graphmixer, snapshot, tgat, tgn, tpnet
from repro_torch.models.tg.common import (
    bce_link_loss,
    bce_link_loss_parts,
    link_decoder,
)
from repro_torch.obs import MemorySink, Telemetry
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.tg.specs import SamplerSpec
from repro_torch.train.metrics import mrr
from repro_torch.tree import tree_leaves, tree_map

CTDG_STATEFUL = {"tgn", "tpnet"}
CTDG_LINK_MODELS = {"tgat", "graphmixer", "dygformer"} | CTDG_STATEFUL
# The CTDG models: module with ``init``/``link_scores`` and its config class.
_CTDG_PORTED = {"tgat": (tgat, tgat.TGATConfig), "tgn": (tgn, tgn.TGNConfig),
                "graphmixer": (graphmixer, graphmixer.GraphMixerConfig),
                "dygformer": (dygformer, dygformer.DyGFormerConfig),
                "tpnet": (tpnet, tpnet.TPNetConfig)}
# The models with a fused attention path (``fused=``, the packed buffer).
_FUSED_MODELS = {"tgat", "tgn"}


# ----------------------------------------------------------------------
# Shared checkpoint machinery
# ----------------------------------------------------------------------
def restore_with_saved_hooks(ckpt_dir, step, target):
    """Two-phase restore with a checkpoint-shaped hooks subtree.

    Reads the flat checkpoint once, rebuilds the hooks subtree that was
    written (``hooks/<group>/<idx>/<state_key>/<leaf>`` keys) and assembles
    the rest into ``target``'s structure from the loaded leaves. Returns
    ``(tree, step, meta)`` with numpy leaves.
    """
    flat, step, meta = ckpt.restore(ckpt_dir, step, target=None)
    hooks: Dict[str, Dict] = {}
    for k, v in flat.items():
        if k.startswith("hooks/"):
            group, leaf = k[len("hooks/"):].rsplit("/", 1)
            hooks.setdefault(group, {})[leaf] = v
    target = dict(target)
    target["hooks"] = hooks
    return ckpt.assemble(flat, target), step, meta


def save_bundle(ckpt_dir: str, step: int, tree: Dict[str, Any],
                model_name: str, **extra_meta) -> str:
    """Write a pipeline checkpoint bundle (atomic step directory).

    ``tree`` is the ``{params, opt_state, hooks}`` contract the pipelines
    share; ``model_name`` (and any ``extra_meta``) rides the manifest so a
    restore can refuse another model. Returns the written path.
    """
    return ckpt.save(ckpt_dir, step, tree,
                     extra_meta={"model_name": model_name, **extra_meta})


def restore_bundle(ckpt_dir: str, step: Optional[int], target: Dict[str, Any],
                   model_name: str):
    """Restore a bundle written by ``save_bundle`` (by either package) into
    ``target``'s structure, validating the model name. Returns
    ``(tree, step)`` with numpy leaves."""
    tree, step, meta = restore_with_saved_hooks(ckpt_dir, step, target)
    if meta.get("model_name") not in (None, model_name):
        raise ValueError(
            f"checkpoint is for model {meta['model_name']!r}, "
            f"pipeline is {model_name!r}"
        )
    return tree, step


def weighted_mrr(pos_rows, neg_rows, mask_rows) -> float:
    """Per-row MRR weighted by the row's valid predictions, as the
    reference aggregates its DTDG eval: ``pos_rows`` (R, C), ``neg_rows``
    (R, C, M) and ``mask_rows`` (R, C) tensors, one prediction pair per row.
    Ties count half a rank (``metrics.mrr``). One host read."""
    pos = torch.as_tensor(pos_rows)
    neg = torch.as_tensor(neg_rows)
    m = torch.as_tensor(mask_rows).to(torch.float32)
    greater = (neg > pos[..., None]).sum(-1).float()
    ties = (neg == pos[..., None]).sum(-1).float()
    rr = 1.0 / (1.0 + greater + 0.5 * ties)
    w = m.sum(-1)
    row = (rr * m).sum(-1) / torch.clamp(w, min=1.0)
    out = (row.double() * w.double()).sum() / torch.clamp(w.double().sum(),
                                                           min=1.0)
    return float(out)


# ----------------------------------------------------------------------
# The epoch engine
# ----------------------------------------------------------------------
def history_from_records(records) -> Dict[str, Any]:
    """Rebuild a ``TrainLoop.fit`` history dict from telemetry records.

    Consumes the ``train/epoch`` / ``train/eval`` / ``train/ckpt`` span
    records one ``fit`` emits (in order) and returns ``{"loss",
    "train_secs", "eval", "ckpts"}`` with the values the pipeline produced
    (they ride the span attributes verbatim). Other records are ignored.
    """
    history: Dict[str, Any] = {"loss": [], "train_secs": [], "eval": [],
                               "ckpts": []}
    for r in records:
        if r.get("kind") != "span":
            continue
        attrs = r.get("attrs", {})
        if r["name"] == "train/epoch":
            history["loss"].append(attrs["loss"])
            history["train_secs"].append(attrs["secs"])
        elif r["name"] == "train/eval":
            history["eval"].append((attrs["epoch"], attrs["metric"]))
        elif r["name"] == "train/ckpt":
            history["ckpts"].append(attrs["path"])
    return history


class TrainLoop:
    """Multi-epoch driver over any pipeline with the standard surface.

    ``fit`` runs ``epochs`` training epochs, evaluates ``eval_split`` every
    ``eval_every`` epochs (0 = never) and writes a checkpoint to
    ``ckpt_dir`` every ``ckpt_every`` epochs (0 = never), and returns::

        {"loss": [...], "train_secs": [...],
         "eval": [(epoch, metric), ...], "ckpts": [path, ...]}

    Every ``fit`` emits ``train/epoch`` / ``train/eval`` / ``train/ckpt``
    spans through ``telemetry`` (the pipeline's own by default), and the
    history is rebuilt from those records (``history_from_records``).
    """

    def __init__(self, pipeline, telemetry: Optional[Telemetry] = None):
        self.pipeline = pipeline
        if telemetry is None:
            telemetry = getattr(pipeline, "telemetry", None)
        # A private instance when neither the caller nor the pipeline has
        # one: fit() attaches its history sink here.
        self.telemetry = telemetry if telemetry is not None else Telemetry()

    def fit(self, epochs: int = 1, eval_every: int = 0,
            eval_split: str = "val", ckpt_dir: Optional[str] = None,
            ckpt_every: int = 0, log=None) -> Dict[str, Any]:
        """Run the epoch loop; see the class docstring for the contract."""
        tel = self.telemetry
        mem = tel.attach(MemorySink())  # tee: history comes from records
        try:
            for epoch in range(epochs):
                with tel.span("train/epoch", epoch=epoch) as sp:
                    loss, secs = self.pipeline.train_epoch()
                    sp["loss"], sp["secs"] = loss, secs
                if log is not None:
                    log(f"epoch {epoch}: loss={loss:.4f} ({secs:.1f}s)")
                if eval_every and (epoch + 1) % eval_every == 0:
                    with tel.span("train/eval", epoch=epoch,
                                  split=eval_split) as sp:
                        metric, _ = self.pipeline.evaluate(eval_split)
                        sp["metric"] = metric
                    if log is not None:
                        log(f"epoch {epoch}: {eval_split} "
                            f"metric={metric:.4f}")
                if ckpt_dir and ckpt_every and (epoch + 1) % ckpt_every == 0:
                    with tel.span("train/ckpt", epoch=epoch) as sp:
                        sp["path"] = self.pipeline.save_checkpoint(
                            ckpt_dir, epoch)
        finally:
            tel.detach(mem)
        return history_from_records(mem.records)


# ----------------------------------------------------------------------
# Parameters and optimizer state, shared by the pipelines
# ----------------------------------------------------------------------
def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _on_device(t, device, dtype) -> torch.Tensor:
    """A fresh ``dtype`` copy of a tensor or array on ``device``."""
    t = t if isinstance(t, torch.Tensor) else torch.as_tensor(np.asarray(t))
    return t.detach().to(device=device, dtype=dtype).clone()


class _ParamsAndOptimizer:
    """Parameter and AdamW plumbing the pipelines share: the parameters are
    float32 leaf tensors that require grad on ``self.device``, the AdamW
    state mirrors them, and a step is ``_update(_grads(loss))``."""

    def load_params(self, params) -> None:
        """Install a parameter tree (nested dicts of tensors or arrays) on
        the pipeline's device as float32 leaf tensors that require grad."""
        self.params = tree_map(
            lambda t: _on_device(t, self.device, torch.float32)
            .requires_grad_(True), params)

    def load_opt_state(self, state) -> None:
        """Install an AdamW state ``{"mu", "nu", "step"}`` (tensors or
        arrays) on the pipeline's device: float32 moments, int32 step."""
        def moments(tree):
            return tree_map(
                lambda t: _on_device(t, self.device, torch.float32), tree)

        self.opt_state = {
            "mu": moments(state["mu"]), "nu": moments(state["nu"]),
            "step": _on_device(state["step"], self.device,
                               torch.int32).reshape(()),
        }

    def _grads(self, loss: torch.Tensor):
        """Gradients of ``loss`` for every parameter, as a tree shaped like
        ``params`` (zeros where a parameter is unused, as JAX gives)."""
        leaves = tree_leaves(self.params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return _unflatten(self.params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])

    def _update(self, grads) -> None:
        """One AdamW step on the parameters and the optimizer state."""
        self.params, self.opt_state = adamw_update(
            self.params, grads, self.opt_state, self.opt_cfg)


# ----------------------------------------------------------------------
# CTDG link prediction: event-stream pipeline
# ----------------------------------------------------------------------
class CTDGLinkPipeline(_ParamsAndOptimizer):
    """CTDG link prediction over the TGB link recipe.

    ``model_name`` is "tgat" (1 or 2 layers; the hooks sample one hop per
    layer unless ``SamplerSpec.num_hops`` says otherwise), "tgn",
    "graphmixer", "dygformer" or "tpnet" (which samples no neighbors: its
    recipe runs with k = 1, as the reference's), over
    ``SamplerSpec(kind="recency")`` or ``kind="uniform"``, on the host (the
    default, as in the reference) or with ``device=True``. The uniform
    hooks' adjacency is built once over the full stream at construction
    (the strict ``t < query_t`` filter keeps it leak-free). ``store`` (a
    ``repro_torch.storage.EventStore`` whose columns back ``data``, e.g.
    ``data = store.to_data()``) runs the stream out-of-core: the uniform
    adjacency comes from the streaming two-pass CSR, and the loader
    releases the store's pages after every batch
    (``storage/windows_released``). Parameters are leaf tensors with
    ``requires_grad``, from the port's seeded init (``torch.Generator``
    seeded with ``seed``) or from ``load_params`` (e.g. the reference's, via
    ``repro_torch.convert.params_from_jax``); the AdamW state (``lr``,
    default 1e-4) from ``adamw_init`` or ``load_opt_state``. A stateful
    model (``CTDG_STATEFUL``: TGN's memory, TPNet's ``{"R", "last"}``) keeps
    ``model_state``, reset with the epoch, advanced by every batch, saved
    with the checkpoint and installed by ``load_model_state``. ``fused``
    (TGAT and TGN only, as in the reference) forwards to the model's
    ``link_scores``: ``None`` runs the fused path when the batch carries the
    device recency sampler's buffer and the classic path otherwise (the
    CUDA kernels on the GPU, their plain versions on the CPU), ``"ref"`` the
    plain version of that path, ``False`` the classic path. ``telemetry``
    (a ``repro_torch.obs.Telemetry``) instruments the epochs, steps and the
    loader.

    **Meshes** (``docs/sharding.md``; every rank of an initialized world
    builds the same pipeline on its own ``device`` and sees the same
    batches). ``SamplerSpec.shards`` alone node-shards the device sampler
    over a 1-D mesh (``make_node_mesh``) and runs the model step replicated
    on every rank. ``data_shards > 1``, or ``shards`` with the recency
    buffer exposed to TGAT/TGN, runs the 2-D ``("data", "nodes")`` step
    (``make_2d_mesh(data_shards, shards or 1)``): each data coordinate
    takes its contiguous ``B / data_shards`` sub-stream of the batch (the
    seed-aligned tensors through ``_seed_perm``), the loss is
    ``local_sum / all_reduce(den)`` over the data group, the gradients are
    summed over the data group only, TGN's new memory goes through the
    masked mean (``sync_state_masked_psum``), the AdamW update runs
    replicated, and the fused layer runs shard-aware over each rank's
    buffer block (``fused_temporal_layer_sharded`` over the node group).
    Under a mesh the buffer is exposed when ``SamplerSpec.expose_buffer``
    says so, or (left ``None``) when the fused path can engage: ``fused``
    given, or a CUDA device, where it is the default. Refused as in the
    reference, each with a ``ValueError``: ``data_shards > 1`` without
    ``device=True``, a batch size that ``data_shards`` does not divide, and
    TPNet with ``data_shards > 1``. Checkpoints are mesh-agnostic: the
    sampler state is canonical and the parameters replicated; rank 0
    writes, every rank restores.
    """

    def __init__(
        self,
        model_name: str,
        data: DGData,
        batch_size: int = 200,
        k: int = 20,
        lr: Optional[float] = None,
        eval_negatives: int = 20,
        seed: int = 0,
        model_kwargs: Optional[Dict[str, Any]] = None,
        sampler_spec: Optional[SamplerSpec] = None,
        val_ratio: float = 0.15,
        test_ratio: float = 0.15,
        fused=None,
        store=None,
        telemetry: Optional[Telemetry] = None,
        device="cuda",
        data_shards: int = 1,
    ):
        if model_name not in CTDG_LINK_MODELS:
            raise ValueError(f"unknown CTDG model {model_name!r}")
        if fused is not None and model_name not in _FUSED_MODELS:
            raise ValueError(
                f"fused= applies to the TGAT/TGN fused attention path; "
                f"{model_name!r} has no fused twin")
        spec = sampler_spec or SamplerSpec(k=k)
        self.data_shards = int(data_shards)
        if self.data_shards < 1:
            raise ValueError("data_shards must be a positive integer")
        if self.data_shards > 1:
            if not spec.device:
                raise ValueError(
                    "data_shards > 1 requires SamplerSpec(device=True): the "
                    "2-D mesh step assumes device-staged batches and "
                    "mesh-placed sampler state (docs/sharding.md)")
            if batch_size % self.data_shards:
                raise ValueError(
                    f"batch_size {batch_size} must be divisible by "
                    f"data_shards {self.data_shards} (each data shard takes "
                    f"a contiguous time-ordered sub-stream of the batch)")
            if model_name == "tpnet":
                raise ValueError(
                    "data_shards > 1 supports tgat/tgn/graphmixer/dygformer;"
                    " tpnet's sketch state has no masked-psum sync recipe")
        self.device = resolve_device(device)
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.model_name = model_name
        self.data = data
        self._store = store
        self.batch_size = batch_size
        self.sampler_spec = spec
        self.fused = fused
        self.train_data, self.val_data, self.test_data = data.split(
            val_ratio, test_ratio)

        d_edge = data.edge_feat_dim
        n = data.num_nodes
        self._model, config = _CTDG_PORTED[model_name]
        kwargs = dict(model_kwargs or {})
        if model_name == "tpnet":
            self.cfg = config(num_nodes=n, **kwargs)
        else:
            self.cfg = config(num_nodes=n, d_edge=d_edge, k=spec.k, **kwargs)
        gen = torch.Generator().manual_seed(seed)
        self.load_params(self._model.init(self.cfg, gen, device=self.device))
        self.stateful = model_name in CTDG_STATEFUL
        self.model_state = self._init_state() if self.stateful else None

        # TGAT samples one hop per layer (at most two); the spec overrides.
        num_hops = (min(2, self.cfg.num_layers) if model_name == "tgat"
                    else 1)
        if spec.num_hops is not None:
            num_hops = spec.num_hops
        # Only TGAT and TGN read the packed buffer; under a mesh only the
        # shard-aware fused layer can, so it is exposed when that path can
        # engage (an explicit fused=, or CUDA, where it is the default).
        expose = spec.expose_buffer
        if expose is None and model_name not in _FUSED_MODELS:
            expose = False
        if expose is None and (spec.shards or self.data_shards > 1):
            expose = bool(fused) or self.device.type == "cuda"
        self._init_mesh(spec, expose)
        self.manager = RecipeRegistry.build(
            RECIPE_TGB_LINK,
            num_nodes=n,
            spec=SamplerSpec(kind=spec.kind,
                             k=1 if model_name == "tpnet" else self.cfg.k,
                             num_hops=num_hops, device=spec.device,
                             checkpoint_adjacency=spec.checkpoint_adjacency,
                             expose_buffer=expose, shards=spec.shards,
                             mesh_axis=spec.mesh_axis,
                             partition=spec.partition),
            mesh=self._mesh,
            mesh_axis=self._recipe_axis,
            batch_size=batch_size,
            eval_negatives=eval_negatives,
            # Full-stream features: sampled edge ids are global event
            # indices (the loader offsets sliced splits by eid_offset).
            edge_feats=data.edge_feats if d_edge else None,
            edge_feat_dim=d_edge,
            seed=seed,
            device=self.device,
        )
        for hook in self.manager.hooks():
            if not isinstance(hook, UniformNeighborHook):
                continue
            if store is not None:
                hook.build_from_store(store)
            else:
                hook.build(data.src, data.dst, data.edge_t,
                           np.arange(len(data.src), dtype=np.int64))
        # Node rows per shard of the sharded packed buffer: the
        # ``rows_per_shard`` the 2-D step hands the shard-aware layer.
        self._buf_rows = None
        if self._node_group is not None:
            for hook in self.manager.hooks():
                if isinstance(hook, DeviceRecencyNeighborHook):
                    self._buf_rows = hook.sampler.rows_per_shard
        self.opt_cfg = AdamWConfig(lr=1e-4 if lr is None else lr)
        self.opt_state = adamw_init(self.params)

    def _init_mesh(self, spec: SamplerSpec, expose) -> None:
        """The pipeline's mesh: the 2-D ``("data", "nodes")`` mesh when the
        step is data-sharded or reads a sharded buffer, the 1-D node mesh
        for ``shards`` alone, none otherwise."""
        self._mesh = None
        self._data_group = self._node_group = None
        self._data_index = 0
        self._recipe_axis = spec.mesh_axis
        self._use_2d = self.data_shards > 1 or bool(
            spec.shards and expose and spec.kind == "recency"
            and self.model_name in _FUSED_MODELS)
        self._perms: Dict[Tuple[int, int], torch.Tensor] = {}
        if self._use_2d:
            self._mesh = make_2d_mesh(self.data_shards, spec.shards or 1,
                                      device_type=self.device.type)
            self._recipe_axis = "nodes"
            self._data_group = axis_group(self._mesh, "data")
            self._node_group = axis_group(self._mesh, "nodes")
            self._data_index = axis_index(self._mesh, "data")
        elif spec.shards:
            self._mesh = make_node_mesh(spec.shards, spec.mesh_axis,
                                        device_type=self.device.type)

    def _init_state(self):
        """A stateful model's state at the start of an epoch, on the
        pipeline's device (TPNet's walk features start from ``r0``)."""
        if self.model_name == "tpnet":
            return tpnet.init_state(self.params, self.cfg)
        return self._model.init_state(self.cfg, self.device)

    def load_model_state(self, state) -> None:
        """Install a stateful model's state (tensors or arrays, e.g. the
        reference's via ``repro_torch.convert.state_from_jax``) on the
        pipeline's device, each leaf in the dtype of the model's
        ``init_state`` (float32 TGN memory and TPNet ``R``, int32
        ``last_update`` and ``last``)."""
        proto = self._init_state()
        self.model_state = tree_map(
            lambda t, p: _on_device(t, self.device, p.dtype), state, proto)

    def _loader(self, data: DGData):
        """Hook-processed batches of ``data`` with every host array staged
        on the device, in the calling thread (a ``loader/stage`` span per
        batch). The recipe's ``DeviceTransferHook`` has no contract, so the
        topological order may run it before the neighbor hook; the
        reference's ``PrefetchLoader`` stages the finished batch again, and
        so does this loop. With a store, its pages are released after each
        staged batch has been handed off (staging copied what it keeps)."""
        tel = self.telemetry
        on_batch = None
        if self._store is not None:
            store = self._store

            def on_batch():
                store.release()
                tel.count("storage/windows_released")

        it = iter(DGDataLoader(DGraph(data), self.manager,
                               batch_size=self.batch_size, on_batch=on_batch))
        while True:
            with tel.span("loader/stage"):
                batch = next(it, None)
                if batch is None:
                    return
                staged = stage_batch(batch, self.device)
            yield staged

    def _scores(self, batch, batch_size: Optional[int] = None):
        """``((pos, neg), new_state)``: the link logits of ``batch`` (of
        ``batch_size`` events, default the pipeline's) and the model state
        after it (``None`` for a stateless model; a stateful model's new
        state carries no autograd graph). A batch carrying a node-sharded
        buffer block runs the shard-aware fused layer."""
        B = self.batch_size if batch_size is None else batch_size
        kw = {}
        if self.model_name in _FUSED_MODELS:
            kw["fused"] = self.fused
            if "nbr_buf" in batch and self._buf_rows is not None:
                kw.update(node_axis=self._node_group, buf_rows=self._buf_rows)
        if self.stateful:
            return self._model.link_scores(
                self.params, self.cfg, self.model_state, batch, B, **kw)
        return self._model.link_scores(self.params, self.cfg, batch, B,
                                       **kw), None

    def _loss_and_state(self, batch):
        """The masked BCE link loss of ``batch`` (forward pass) and the
        model state after the batch."""
        (pos, neg), new_state = self._scores(batch)
        return bce_link_loss(pos, neg, batch["batch_mask"]), new_state

    def _loss(self, batch) -> torch.Tensor:
        """The masked BCE link loss of ``batch`` (forward pass)."""
        return self._loss_and_state(batch)[0]

    def _train_step(self, batch) -> torch.Tensor:
        """Loss, backward and one AdamW update on ``batch``, then the model
        state after it (the reference's step: the state is an input, the
        new state an auxiliary output, so no gradient reaches it); returns
        the loss as a device scalar, so nothing is read back to the host."""
        if self._use_2d:
            return self._train_step_2d(batch)
        loss, new_state = self._loss_and_state(batch)
        self._update(self._grads(loss))
        if self.stateful:
            self.model_state = new_state
        return loss.detach()

    def _eval_step(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """The link logits of ``batch``; a stateful model's state moves on."""
        if self._use_2d:
            return self._eval_step_2d(batch)
        with torch.no_grad():
            logits, new_state = self._scores(batch)
        if self.stateful:
            self.model_state = new_state
        return logits

    def _advance(self, batch) -> None:
        """Move a stateful model's state past ``batch`` without scoring it
        (the warm passes): the state the reference's eval step returns, whose
        scores it throws away (on the 2-D mesh: each data shard's update of
        its sub-stream, then the masked mean)."""
        if not self.stateful:
            return
        with torch.no_grad():
            if self._use_2d:
                local = self._local(batch)
                new = self._model.update_memory(self.params, self.cfg,
                                                self.model_state, local)
                self.model_state = self._synced(new, local)
            else:
                self.model_state = self._model.update_memory(
                    self.params, self.cfg, self.model_state, batch)

    # -- the 2-D ("data", "nodes") mesh step (docs/sharding.md) -----------
    def _seed_perm(self, S: int) -> np.ndarray:
        """Shard-major permutation of the stacked seed axis ``[src (B) |
        dst (B) | neg (B * Nn)]``: each contiguous ``1 / data_shards``
        slice of the permuted rows is that shard's own ``[src_l | dst_l |
        neg_l]`` stack at batch size ``B / data_shards`` (the reference's
        static permutation)."""
        B, ds = self.batch_size, self.data_shards
        nn = (S - 2 * B) // B
        bl = B // ds
        parts = []
        for d in range(ds):
            lo, hi = d * bl, (d + 1) * bl
            parts.append(np.arange(lo, hi))
            parts.append(B + np.arange(lo, hi))
            if nn:
                parts.append(2 * B + np.arange(lo * nn, hi * nn))
        return np.concatenate(parts).astype(np.int64)

    def _local_rows(self, S: int, m: int) -> torch.Tensor:
        """The rows of a seed-aligned ``(S * m, ...)`` tensor that this data
        shard takes (``m`` rows per seed: 1, or K for the hop-2 tensors)."""
        key = (S, m)
        if key not in self._perms:
            perm = self._seed_perm(S)
            if m > 1:
                perm = (perm[:, None] * m + np.arange(m)).reshape(-1)
            n = perm.shape[0] // self.data_shards
            d = self._data_index
            self._perms[key] = torch.as_tensor(perm[d * n:(d + 1) * n],
                                               device=self.device)
        return self._perms[key]

    def _local(self, batch) -> Dict[str, Any]:
        """This data shard's sub-batch: event-aligned ``(B, ...)`` tensors
        sliced to its contiguous sub-stream, seed-aligned ``(S, ...)`` and
        frontier-aligned ``(S * K, ...)`` ones through the shard-major
        permutation; the buffer block, the edge table and anything else
        kept whole (the reference's routing by leading dimension)."""
        B = self.batch_size
        bl = B // self.data_shards
        d = self._data_index
        S = int(batch["seed_nodes"].shape[0]) if "seed_nodes" in batch else -1
        out = {}
        for key in batch.keys():
            v = batch[key]
            shape = tuple(v.shape) if isinstance(v, torch.Tensor) else ()
            if key in ("nbr_buf", "edge_feat_table") or not shape:
                out[key] = v
            elif shape[0] == B:
                out[key] = v[d * bl:(d + 1) * bl]
            elif S > 0 and shape[0] % S == 0:
                out[key] = v[self._local_rows(S, shape[0] // S)]
            else:
                out[key] = v
        return out

    def _synced(self, new_state, local):
        """TGN's new memory after the DistTGL masked mean over the data
        group: the rows this shard's valid events touched."""
        mask = local["batch_mask"].to(torch.bool)
        nodes = torch.cat([local["src"], local["dst"]]).long()
        touched = torch.zeros(self.cfg.num_nodes, dtype=torch.bool,
                              device=self.device)
        touched[nodes[torch.cat([mask, mask])]] = True
        return sync_state_masked_psum(new_state, touched, self._data_group)

    def _step_2d(self, batch):
        """The 2-D step without its update: ``(loss, grads, new_state)``.
        This shard's ``local_sum / D``, ``D`` the all-reduced term count
        (parameter-independent), is differentiated; its gradients and loss
        sum are all-reduced over the data group in one call, so every rank
        holds the one-device gradient; a stateful model's new state comes
        back through the masked mean (``None`` otherwise)."""
        local = self._local(batch)
        (pos, neg), new_state = self._scores(
            local, self.batch_size // self.data_shards)
        num, den = bce_link_loss_parts(pos, neg, local["batch_mask"])
        denom = den.detach().reshape(1).clone()
        dist.all_reduce(denom, group=self._data_group)
        denom = torch.clamp(denom[0], min=1.0)
        grads = self._grads(num / denom)
        summed = all_reduce_tree({"grads": grads,
                                  "num": num.detach().reshape(1)},
                                 self._data_group)
        if self.stateful:
            new_state = self._synced(new_state, local)
        return summed["num"][0] / denom, summed["grads"], new_state

    def _train_step_2d(self, batch) -> torch.Tensor:
        """``_step_2d``, then the replicated AdamW update."""
        loss, grads, new_state = self._step_2d(batch)
        if self.stateful:
            self.model_state = new_state
        self._update(grads)
        return loss

    def _eval_step_2d(self, batch):
        """The 2-D eval step: this shard's logits placed in its rows of
        zero-filled ``(B,)`` / ``(B, Nn)`` tensors, summed over the data
        group (one owner per event: exact), so every rank has the batch's
        logits in event order; TGN's memory synced as in training."""
        local = self._local(batch)
        B, d = self.batch_size, self._data_index
        bl = B // self.data_shards
        with torch.no_grad():
            (pos, neg), new_state = self._scores(local, bl)
            full_pos = torch.zeros((B,) + tuple(pos.shape[1:]),
                                   dtype=pos.dtype, device=pos.device)
            full_pos[d * bl:(d + 1) * bl] = pos
            parts = [full_pos]
            if neg is not None:
                full_neg = torch.zeros((B,) + tuple(neg.shape[1:]),
                                       dtype=neg.dtype, device=neg.device)
                full_neg[d * bl:(d + 1) * bl] = neg
                parts.append(full_neg)
            summed = all_reduce_flat(parts, self._data_group)
            if self.stateful:
                self.model_state = self._synced(new_state, local)
        return summed[0], (summed[1] if neg is not None else None)

    def reset_epoch_state(self) -> None:
        """Clear hook/sampler state (and the model state) for an epoch."""
        self.manager.reset_state()
        if self.stateful:
            self.model_state = self._init_state()

    # -- checkpointing ---------------------------------------------------
    # The sampler buffers (and a stateful model's state) ride along with the
    # parameters and optimizer state, so a restored run resumes mid-stream
    # with warm neighbor state.
    def save_checkpoint(self, ckpt_dir: str, step: int) -> str:
        """Write a checkpoint (atomic step directory). Returns its path.
        On a mesh every rank calls it (the sharded samplers assemble their
        canonical state together), rank 0 writes, and all wait for it."""
        tree = {
            "params": self.params,
            "opt_state": self.opt_state,
            "hooks": self.manager.state_dict(),
        }
        if self.stateful:
            tree["model_state"] = self.model_state
        path = os.path.join(ckpt_dir, f"ckpt_{step}")
        if self._mesh is None or dist.get_rank() == 0:
            path = save_bundle(ckpt_dir, step, tree, self.model_name)
        if self._mesh is not None:
            dist.barrier()
        return path

    def restore_checkpoint(self, ckpt_dir: str,
                           step: Optional[int] = None) -> int:
        """Restore params, optimizer, hook (and model) state (written by
        either package, under any mesh shape or none); returns the step.
        On a mesh every rank restores and keeps its own sampler block."""
        target = {"params": self.params, "opt_state": self.opt_state}
        if self.stateful:
            target["model_state"] = self.model_state
        tree, step = restore_bundle(ckpt_dir, step, target, self.model_name)
        self.load_params(tree["params"])
        self.load_opt_state(tree["opt_state"])
        self.manager.load_state_dict(tree["hooks"])
        if self.stateful:
            self.load_model_state(tree["model_state"])
        return step

    # -- epochs ------------------------------------------------------------
    def train_epoch(self) -> Tuple[float, float]:
        """One epoch over the train split. Returns (mean loss, seconds)."""
        tel = self.telemetry
        with tel.span("ctdg/epoch", model=self.model_name) as sp:
            self.reset_epoch_state()
            t0 = time.perf_counter()
            losses = []
            with self.manager.activate(TRAIN_KEY):
                for batch in self._loader(self.train_data):
                    # The step only enqueues device work: the span bounds
                    # host time, the device's shows in the next batch's wait.
                    with tel.span("ctdg/step"):
                        losses.append(self._train_step(batch))
            # Read the losses back once, at the end of the epoch.
            losses = torch.stack(losses).cpu().tolist() if losses else []
            mean = float(np.mean(losses)) if losses else float("nan")
            secs = time.perf_counter() - t0
            sp["loss"], sp["steps"] = mean, len(losses)
        return mean, secs

    def evaluate(self, split: str = "val") -> Tuple[float, float]:
        """One-vs-many MRR on val/test (warm state from train[, val]).
        Returns ``(mrr, seconds of the scored pass)``."""
        tel = self.telemetry
        with tel.span("ctdg/eval", split=split) as sp:
            self.reset_epoch_state()
            # Warm the sampler through earlier splits without predicting.
            with tel.span("ctdg/warm"), self.manager.activate(TRAIN_KEY):
                warm = [self.train_data] + (
                    [self.val_data] if split == "test" else [])
                for d in warm:
                    for batch in self._loader(d):
                        self._advance(batch)
            data = self.val_data if split == "val" else self.test_data
            t0 = time.perf_counter()
            rrs, masks = [], []
            with self.manager.activate(EVAL_KEY):
                for batch in self._loader(data):
                    with tel.span("ctdg/eval_step"):
                        pos, neg = self._eval_step(batch)
                    w = float(batch["batch_mask"].sum())
                    rrs.append(mrr(pos, neg, batch["batch_mask"]) * w)
                    masks.append(w)
            out = float(np.sum(rrs) / max(np.sum(masks), 1.0))
            sp["mrr"] = out
        return out, time.perf_counter() - t0


# ----------------------------------------------------------------------
# Shared snapshot-pair plumbing
# ----------------------------------------------------------------------
class SnapshotPairPipeline:
    """Shared base of the snapshot pipelines.

    Owns the plumbing every snapshot-pair task repeats: tensorizing the
    stream into a ``SnapshotTensor`` on the device, mapping chronological
    ``DGData.split`` boundaries onto snapshot rows (a prediction pair
    ``p -> p+1`` belongs to the split containing its *predicted* snapshot
    ``p+1``), the ``_split_pairs`` ranges, and the FIFO-bounded cache of a
    chunk's stacked inputs.
    """

    # A chunk's inputs are pure functions of (snapshot tensor, task inputs);
    # cache the few ranges an epoch reuses, FIFO-evicting beyond this bound
    # so long-lived pipelines don't accumulate per-chunk device copies.
    _XS_CACHE_MAX = 8

    def _init_snapshots(self, data: DGData, unit, capacity, device,
                        val_ratio: float, test_ratio: float) -> None:
        """Tensorize ``data`` once and map split times to snapshot rows."""
        self.snapshots = snapshot_tensor(data, unit, capacity=capacity,
                                         device=device)
        self.capacity = self.snapshots.capacity
        T = self.snapshots.num_snapshots
        _, val_d, test_d = data.split(val_ratio, test_ratio)
        test_row = (
            self.snapshots.row_of_time(int(test_d.edge_t[0]))
            if test_d.num_edge_events else T
        )
        # An empty val split collapses onto the test boundary (val pairs
        # empty, test pairs intact) rather than swallowing the test split.
        val_row = (
            self.snapshots.row_of_time(int(val_d.edge_t[0]))
            if val_d.num_edge_events else test_row
        )
        self.set_split_rows(val_row, test_row)
        self._xs_cache: Dict[Tuple, Dict[str, Any]] = {}

    def set_split_rows(self, val_row: int, test_row: int) -> None:
        """Install (clamped) snapshot-row split boundaries: the first val
        row and the first test row. ``val_row == test_row`` means no val
        pairs."""
        T = self.snapshots.num_snapshots
        self._val_row = min(max(val_row, 1), T)
        self._test_row = min(max(test_row, self._val_row), T)

    def _split_pairs(self, split: str) -> Tuple[int, int]:
        """Prediction-pair range ``[lo, hi)`` for a split."""
        T = self.snapshots.num_snapshots
        if split == "train":
            return 0, max(self._val_row - 1, 0)
        if split == "val":
            return max(self._val_row - 1, 0), max(self._test_row - 1, 0)
        if split == "test":
            return max(self._test_row - 1, 0), max(T - 1, 0)
        raise ValueError(f"unknown split {split!r}")

    def _pair_slices(self, lo: int, hi: int) -> Dict[str, Any]:
        """The stacked current/predicted snapshot tensors for pairs
        ``[lo, hi)`` (pair p = snapshot p -> p+1)."""
        st = self.snapshots
        return {
            "src": st.src[lo:hi], "dst": st.dst[lo:hi],
            "mask": st.mask[lo:hi],
            "nsrc": st.src[lo + 1:hi + 1], "ndst": st.dst[lo + 1:hi + 1],
            "nmask": st.mask[lo + 1:hi + 1],
        }

    def _xs_cached(self, key: Tuple, build) -> Dict[str, Any]:
        """FIFO-bounded memoization of a chunk-input dict keyed by ``key``."""
        if key not in self._xs_cache:
            if len(self._xs_cache) >= self._XS_CACHE_MAX:
                self._xs_cache.pop(next(iter(self._xs_cache)))
            self._xs_cache[key] = build()
        return self._xs_cache[key]

    def _init_state(self):
        """The snapshot model's recurrent state at the start of a pass."""
        return snapshot.init_state(self.model_name, self.cfg, self.device)

    def load_model_state(self, state) -> None:
        """Install a recurrent state (``()``, one tensor or array, or a
        tuple of them, as ``init_state`` lays it out) on the device."""
        self.model_state = _state_map(
            lambda t: _on_device(t, self.device, torch.float32), state)


def _state_map(fn, state):
    """Apply ``fn`` to every tensor of a recurrent state (``()``, one
    tensor, or a tuple of tensors)."""
    if isinstance(state, tuple):
        return tuple(fn(t) for t in state)
    return fn(state)


# ----------------------------------------------------------------------
# DTDG link prediction: snapshot pipeline
# ----------------------------------------------------------------------
class DTDGLinkPipeline(SnapshotPairPipeline, _ParamsAndOptimizer):
    """DTDG link prediction over the snapshot tensor, on ``device``
    (``"cuda"`` by default).

    Snapshot t's embeddings predict the edges of snapshot t+1. The stream is
    tensorized once into a ``SnapshotTensor`` on the device. With
    ``compiled=True`` (the default) a split runs in chunks of
    ``chunk_size`` pairs (default: the whole split), each chunk's inputs and
    negatives prepared at once, then one step per pair; with
    ``compiled=False`` each pair's negatives come from the
    ``RECIPE_DTDG_SNAPSHOT`` hooks. Both run the same step function, so they
    are bit-identical, as the reference's scan and loop paths are.

    A train step is the reference's scan body: the model's apply on
    snapshot p from the carried recurrent state, BCE over snapshot p+1's
    edges and ``num_negatives`` negatives each, the gradient with respect to
    the parameters only (the carried state is an input, as in the scan),
    one AdamW update (``lr``, default 1e-3). The per-pair losses stay on the
    device and are read once per chunk. ``mode`` goes to every segment sum
    (``"auto"``: the CUDA kernel on the card, its plain version on the CPU;
    ``"ref"`` forces the plain version). Splits are chronological
    ``DGData.split`` boundaries mapped to snapshot rows; ``evaluate`` warms
    the recurrent state through every earlier snapshot with advance-only
    steps first. Checkpoints bundle ``{params, opt_state[, model_state],
    hooks, pipeline}`` in the reference's layout, ``pipeline`` holding the
    mid-epoch snapshot-pair cursor.
    """

    def __init__(
        self,
        model_name: str,
        data: DGData,
        snapshot_unit: TimeDelta | str = "h",
        d_embed: int = 128,
        lr: Optional[float] = None,
        num_negatives: int = 1,
        eval_negatives: int = 20,
        edge_capacity: Optional[int] = None,
        seed: int = 0,
        val_ratio: float = 0.15,
        test_ratio: float = 0.15,
        compiled: bool = True,
        chunk_size: Optional[int] = None,
        mode: str = "auto",
        device="cuda",
        telemetry: Optional[Telemetry] = None,
    ):
        if model_name not in snapshot.SNAPSHOT_MODELS:
            raise ValueError(f"unknown DTDG model {model_name!r}")
        self.device = resolve_device(device)
        self.model_name = model_name
        self.data = data
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.unit = TimeDelta.coerce(snapshot_unit)
        self.num_negatives = num_negatives
        self.eval_negatives = eval_negatives
        self._seed = seed
        self.compiled = compiled
        self.chunk_size = chunk_size
        self.mode = mode

        self._init_snapshots(data, self.unit, edge_capacity, self.device,
                             val_ratio, test_ratio)

        self.cfg = snapshot.SnapshotConfig(num_nodes=data.num_nodes,
                                           d_embed=d_embed)
        gen = torch.Generator().manual_seed(seed)
        self.load_params(snapshot.init_params(model_name, gen, self.cfg))
        self._apply = snapshot.make_apply(model_name, self.cfg)
        self._has_state = model_name != "gcn"
        self.model_state = self._init_state()

        self.manager = RecipeRegistry.build(
            RECIPE_DTDG_SNAPSHOT,
            num_nodes=data.num_nodes,
            capacity=self.capacity,
            num_negatives=num_negatives,
            eval_negatives=eval_negatives,
            seed=seed,
            device=self.device,
        )
        self.opt_cfg = AdamWConfig(lr=1e-3 if lr is None else lr)
        self.opt_state = adamw_init(self.params)
        self._cursor = 0  # next train pair (mid-epoch checkpoint resume)

    # ------------------------------------------------------------------
    def _scores(self, params, x, state):
        """The step function every path runs: the model on snapshot p, then
        the decoder's logits for snapshot p+1's edges (``pos`` (C,)) and
        their negatives (``neg`` (C, m)). A negative equal to the positive
        destination takes the positive's logit: its embedding row is the
        same, and MRR counts it as an exact tie."""
        z, new_state = self._apply(params, x["src"], x["dst"], x["mask"],
                                   state, mode=self.mode)
        ndst, neg_ids = x["ndst"].long(), x["neg"].long()
        h_src = z[x["nsrc"].long()]
        pos = link_decoder(params["decoder"], h_src, z[ndst])
        neg = link_decoder(params["decoder"], h_src, z[neg_ids])
        neg = torch.where(neg_ids == ndst[:, None], pos[:, None], neg)
        return pos, neg, new_state

    def _train_step(self, x) -> torch.Tensor:
        """Loss, gradient and one AdamW update on pair ``x``; carries the
        new recurrent state on. Returns the loss as a device scalar."""
        pos, neg, new_state = self._scores(self.params, x, self.model_state)
        loss = bce_link_loss(pos, neg, x["nmask"])
        self._update(self._grads(loss))
        self.model_state = _state_map(torch.Tensor.detach, new_state)
        return loss.detach()

    @torch.no_grad()
    def _eval_step(self, state, x):
        pos, neg, new_state = self._scores(self.params, x, state)
        return new_state, pos, neg

    @torch.no_grad()
    def _advance_step(self, state, p: int):
        st = self.snapshots
        _, new_state = self._apply(self.params, st.src[p], st.dst[p],
                                   st.mask[p], state, mode=self.mode)
        return new_state

    # ------------------------------------------------------------------
    def _pair_xs(self, lo: int, hi: int, m: int) -> Dict[str, Any]:
        """Stacked inputs for prediction pairs ``[lo, hi)`` (pair p =
        snapshot p -> p+1) with ``m`` negatives per predicted edge."""
        def build():
            rows = np.arange(lo + 1, hi + 1)
            return {**self._pair_slices(lo, hi),
                    "neg": self.snapshots.negatives(self._seed, m, rows)}

        return self._xs_cached((lo, hi, m), build)

    def _pair_x(self, p: int, neg) -> Dict[str, Any]:
        """One pair's tensors (hook path), with hook-produced negatives."""
        st = self.snapshots
        return {
            "src": st.src[p], "dst": st.dst[p], "mask": st.mask[p],
            "nsrc": st.src[p + 1], "ndst": st.dst[p + 1],
            "nmask": st.mask[p + 1], "neg": neg,
        }

    def _hook_negatives(self, p: int):
        """Run the predicted snapshot through the active hook pipeline and
        return its ``neg`` draws (identical to the compiled path's)."""
        st = self.snapshots
        batch = Batch(
            {"src": st.src[p + 1], "dst": st.dst[p + 1],
             "time": np.full(st.capacity, (st.t0 + p + 1) * st.ticks,
                             dtype=np.int64),
             "snap_mask": st.mask[p + 1]},
            meta={"snapshot_row": p + 1},
        )
        return self.manager.execute(batch)["neg"]

    def _chunks(self, lo: int, hi: int):
        step = self.chunk_size or max(hi - lo, 1)
        for start in range(lo, hi, step):
            yield start, min(start + step, hi)

    def reset_epoch_state(self) -> None:
        """Reset hook cursors and the recurrent state (start of an epoch)."""
        self.manager.reset_state()
        self.model_state = self._init_state()

    @property
    def snapshot_cursor(self) -> int:
        """Next train snapshot pair to run: the mid-epoch resume cursor
        carried in checkpoints as ``pipeline/snapshot_cursor``."""
        return self._cursor

    # ------------------------------------------------------------------
    def train_chunk(self) -> Optional[list]:
        """Run ONE chunk from the current snapshot cursor (compiled mode).

        Runs the next ``chunk_size`` snapshot pairs, advances the cursor
        (checkpointed as ``pipeline/snapshot_cursor``) and returns the
        chunk's per-pair losses, read from the device once. Returns ``None``
        once the train split is exhausted (and zeroes the cursor so the next
        call starts a fresh epoch). A checkpoint written between calls
        restores to exactly this boundary."""
        if not self.compiled:
            raise RuntimeError("train_chunk requires compiled=True")
        lo, hi = self._split_pairs("train")
        start = max(self._cursor, lo)
        if start >= hi:
            self._cursor = 0
            return None
        if self._cursor == 0:
            self.reset_epoch_state()
        chi = min(start + (self.chunk_size or max(hi - lo, 1)), hi)
        tel = self.telemetry
        with tel.span("dtdg/chunk", lo=start, hi=chi):
            xs = self._pair_xs(start, chi, self.num_negatives)
            losses = []
            for i in range(chi - start):
                with tel.span("dtdg/step"):
                    losses.append(self._train_step(
                        {k: v[i] for k, v in xs.items()}))
            out = torch.stack(losses).cpu().tolist()
        self._cursor = chi
        return out

    def train_epoch(self) -> Tuple[float, float]:
        """One epoch over the train split. Returns (mean loss, seconds).

        A restored mid-epoch snapshot cursor resumes from where the
        checkpoint left off."""
        tel = self.telemetry
        with tel.span("dtdg/epoch", model=self.model_name,
                      compiled=self.compiled) as sp:
            lo, hi = self._split_pairs("train")
            if self._cursor == 0:
                self.reset_epoch_state()
            start = max(self._cursor, lo)
            t0 = time.perf_counter()
            losses = []
            if self.compiled:
                while True:
                    chunk_losses = self.train_chunk()
                    if chunk_losses is None:
                        break
                    losses.extend(chunk_losses)
            else:
                steps = []
                with self.manager.activate(TRAIN_KEY):
                    for p in range(start, hi):
                        x = self._pair_x(p, self._hook_negatives(p))
                        with tel.span("dtdg/step"):
                            steps.append(self._train_step(x))
                        self._cursor = p + 1
                losses = torch.stack(steps).cpu().tolist() if steps else []
            self._cursor = 0
            secs = time.perf_counter() - t0
            mean = float(np.mean(losses)) if losses else 0.0
            sp["loss"], sp["pairs"] = mean, len(losses)
        return mean, secs

    def evaluate(self, split: str = "val") -> Tuple[float, float]:
        """One-vs-many MRR on val/test. Returns (MRR, seconds).

        The recurrent state is warmed from scratch through all earlier
        snapshots with advance-only steps (carried across the split
        boundary), then the split's pairs are scored. The training state is
        left as it was (checkpoint-resume safety)."""
        tel = self.telemetry
        with tel.span("dtdg/eval", split=split) as sp:
            lo, hi = self._split_pairs(split)
            self.manager.reset_state()
            t0 = time.perf_counter()
            state = self._init_state()
            if self._has_state:
                for p in range(lo):
                    state = self._advance_step(state, p)
            pos_rows, neg_rows, mask_rows = [], [], []
            if self.compiled:
                for clo, chi in self._chunks(lo, hi):
                    xs = self._pair_xs(clo, chi, self.eval_negatives)
                    for i in range(chi - clo):
                        state, pos, neg = self._eval_step(
                            state, {k: v[i] for k, v in xs.items()})
                        pos_rows.append(pos)
                        neg_rows.append(neg)
                    mask_rows.append(xs["nmask"])
            else:
                with self.manager.activate(EVAL_KEY):
                    for p in range(lo, hi):
                        x = self._pair_x(p, self._hook_negatives(p))
                        state, pos, neg = self._eval_step(state, x)
                        pos_rows.append(pos)
                        neg_rows.append(neg)
                        mask_rows.append(x["nmask"][None])
            out = 0.0
            if pos_rows:
                out = weighted_mrr(torch.stack(pos_rows), torch.stack(neg_rows),
                                   torch.cat(mask_rows))
            sp["mrr"] = out
        return out, time.perf_counter() - t0

    # -- checkpointing ---------------------------------------------------
    # Params + optimizer state + recurrent model state + hook cursors + the
    # snapshot-pair cursor, so a restored run resumes mid-epoch at the
    # right snapshot with the right negative draws.
    def _ckpt_tree(self) -> Dict[str, Any]:
        tree = {
            "params": self.params,
            "opt_state": self.opt_state,
            "hooks": self.manager.state_dict(),
            "pipeline": {"snapshot_cursor": np.int64(self._cursor)},
        }
        if self._has_state:
            tree["model_state"] = self.model_state
        return tree

    def save_checkpoint(self, ckpt_dir: str, step: int) -> str:
        """Write a checkpoint (atomic step directory). Returns its path."""
        return save_bundle(ckpt_dir, step, self._ckpt_tree(), self.model_name,
                           trainer="snapshot")

    def restore_checkpoint(self, ckpt_dir: str, step: Optional[int] = None) -> int:
        """Restore params, optimizer and model state, hook cursors and the
        snapshot cursor (written by either package); returns the step."""
        target = {k: v for k, v in self._ckpt_tree().items() if k != "hooks"}
        tree, step = restore_bundle(ckpt_dir, step, target, self.model_name)
        self.load_params(tree["params"])
        self.load_opt_state(tree["opt_state"])
        self.manager.load_state_dict(tree["hooks"])
        self._cursor = int(np.asarray(tree["pipeline"]["snapshot_cursor"]))
        if self._has_state:
            self.load_model_state(tree["model_state"])
        return step

    def run_epoch(self, train_frac: Optional[float] = None,
                  train: bool = True) -> Tuple[float, float]:
        """Legacy shim: ``train=True`` -> ``train_epoch()``; otherwise
        ``evaluate('val')``. ``train_frac`` is ignored (splits come from
        ``DGData.split``), and passing it warns."""
        if train_frac is not None:
            import warnings

            warnings.warn(
                "run_epoch(train_frac=...) is ignored; splits come from "
                "DGData.split — pass val_ratio/test_ratio to the pipeline "
                "and use train_epoch()/evaluate() instead",
                DeprecationWarning,
                stacklevel=2,
            )
        if train:
            return self.train_epoch()
        return self.evaluate("val")


SnapshotLinkTrainer = DTDGLinkPipeline
