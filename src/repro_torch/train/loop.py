"""CTDG link prediction: the event-stream pipeline and the epoch engine.

  * ``CTDGLinkPipeline`` — the TGB link recipe over the device recency
    sampler, 1-layer TGAT and one-vs-many MRR, on one device
    (``device="cuda"`` by default): ``train_epoch`` (masked BCE, backward
    through the fused layer's backward kernel, AdamW), ``evaluate(split)``
    and checkpoints, following ``repro.train.loop.CTDGLinkPipeline``.
    The hooks and the staging of each batch run in the calling thread,
    between steps: with an eager step, ``PrefetchLoader``'s producer thread
    (the reference's choice when its sampler is on the device) contends
    with the step for the interpreter lock at every op and is slower
    (``chip_smoke.py --profile``, ``loader`` phase);
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

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import (
    DGData,
    DGDataLoader,
    DGraph,
    EVAL_KEY,
    RECIPE_TGB_LINK,
    RecipeRegistry,
    TRAIN_KEY,
)
from repro_torch.core.tg_hooks import stage_batch
from repro_torch.device import resolve_device
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.models.tg import tgat
from repro_torch.models.tg.common import bce_link_loss
from repro_torch.obs import MemorySink, Telemetry
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.tg.specs import SamplerSpec
from repro_torch.train.metrics import mrr
from repro_torch.tree import tree_leaves, tree_map

CTDG_LINK_MODELS = {"tgat", "graphmixer", "dygformer", "tgn", "tpnet"}


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
# CTDG link prediction: event-stream pipeline
# ----------------------------------------------------------------------
def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _on_device(t, device, dtype) -> torch.Tensor:
    """A fresh ``dtype`` copy of a tensor or array on ``device``."""
    t = t if isinstance(t, torch.Tensor) else torch.as_tensor(np.asarray(t))
    return t.detach().to(device=device, dtype=dtype).clone()


class CTDGLinkPipeline:
    """CTDG link prediction over the TGB link recipe.

    Ported: ``model_name="tgat"`` (1 layer) with
    ``SamplerSpec(kind="recency", device=True)``; other models and
    samplers raise ``NotImplementedError``. Parameters are leaf tensors
    with ``requires_grad``, from the port's seeded init (``torch.Generator``
    seeded with ``seed``) or from ``load_params`` (e.g. the reference's,
    via ``repro_torch.convert.params_from_jax``); the AdamW state
    (``lr``, default 1e-4) from ``adamw_init`` or ``load_opt_state``.
    ``fused`` forwards to ``tgat.link_scores``: ``None`` runs the fused
    path (the CUDA kernels on the GPU, their plain version on the CPU),
    ``"ref"`` forces the plain version, ``False`` the classic pre-gathered
    path. ``telemetry`` (a ``repro_torch.obs.Telemetry``) instruments the
    epochs, steps and the loader.
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
        telemetry: Optional[Telemetry] = None,
        device="cuda",
    ):
        if model_name not in CTDG_LINK_MODELS:
            raise ValueError(f"unknown CTDG model {model_name!r}")
        if model_name != "tgat":
            raise NotImplementedError(
                f"{model_name!r} is not ported yet (ROADMAP A: the rest of "
                f"the CTDG zoo); the port runs 'tgat'")
        spec = sampler_spec or SamplerSpec(k=k, device=True)
        if spec.kind != "recency" or not spec.device or spec.shards:
            raise NotImplementedError(
                "the port's pipeline runs the single-device recency sampler "
                "(SamplerSpec(kind='recency', device=True)); other samplers "
                "are later slices (ROADMAP A)")
        self.device = resolve_device(device)
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.model_name = model_name
        self.data = data
        self.batch_size = batch_size
        self.sampler_spec = spec
        self.fused = fused
        self.train_data, self.val_data, self.test_data = data.split(
            val_ratio, test_ratio)

        d_edge = data.edge_feat_dim
        n = data.num_nodes
        self.cfg = tgat.TGATConfig(num_nodes=n, d_edge=d_edge, k=spec.k,
                                   **dict(model_kwargs or {}))
        gen = torch.Generator().manual_seed(seed)
        self.load_params(tgat.init(self.cfg, gen, device=self.device))

        self.manager = RecipeRegistry.build(
            RECIPE_TGB_LINK,
            num_nodes=n,
            spec=SamplerSpec(kind="recency", k=self.cfg.k, device=True,
                             expose_buffer=spec.expose_buffer),
            batch_size=batch_size,
            eval_negatives=eval_negatives,
            # Full-stream features: sampled edge ids are global event
            # indices (the loader offsets sliced splits by eid_offset).
            edge_feats=data.edge_feats if d_edge else None,
            edge_feat_dim=d_edge,
            seed=seed,
            device=self.device,
        )
        self.opt_cfg = AdamWConfig(lr=1e-4 if lr is None else lr)
        self.opt_state = adamw_init(self.params)

    # ------------------------------------------------------------------
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

    def _loader(self, data: DGData):
        """Hook-processed batches of ``data`` with every host array staged
        on the device, in the calling thread (a ``loader/stage`` span per
        batch). The recipe's ``DeviceTransferHook`` has no contract, so the
        topological order may run it before the neighbor hook; the
        reference's ``PrefetchLoader`` stages the finished batch again, and
        so does this loop."""
        tel = self.telemetry
        it = iter(DGDataLoader(DGraph(data), self.manager,
                               batch_size=self.batch_size))
        while True:
            with tel.span("loader/stage"):
                batch = next(it, None)
                if batch is None:
                    return
                staged = stage_batch(batch, self.device)
            yield staged

    def _loss(self, batch) -> torch.Tensor:
        """The masked BCE link loss of ``batch`` (forward pass)."""
        pos, neg = tgat.link_scores(self.params, self.cfg, batch,
                                    self.batch_size, fused=self.fused)
        return bce_link_loss(pos, neg, batch["batch_mask"])

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

    def _train_step(self, batch) -> torch.Tensor:
        """Loss, backward and one AdamW update on ``batch`` (the stateless
        step of the reference); returns the loss as a device scalar, so
        nothing is read back to the host."""
        loss = self._loss(batch)
        self._update(self._grads(loss))
        return loss.detach()

    def _eval_step(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.no_grad():
            return tgat.link_scores(self.params, self.cfg, batch,
                                    self.batch_size, fused=self.fused)

    def reset_epoch_state(self) -> None:
        """Clear hook/sampler state for an epoch."""
        self.manager.reset_state()

    # -- checkpointing ---------------------------------------------------
    # The sampler buffers ride along with the parameters and optimizer
    # state, so a restored run resumes mid-stream with warm neighbor state.
    def save_checkpoint(self, ckpt_dir: str, step: int) -> str:
        """Write a checkpoint (atomic step directory). Returns its path."""
        tree = {
            "params": self.params,
            "opt_state": self.opt_state,
            "hooks": self.manager.state_dict(),
        }
        return save_bundle(ckpt_dir, step, tree, self.model_name)

    def restore_checkpoint(self, ckpt_dir: str,
                           step: Optional[int] = None) -> int:
        """Restore params, optimizer and hook state (written by either
        package); returns the step."""
        target = {"params": self.params, "opt_state": self.opt_state}
        tree, step = restore_bundle(ckpt_dir, step, target, self.model_name)
        self.load_params(tree["params"])
        self.load_opt_state(tree["opt_state"])
        self.manager.load_state_dict(tree["hooks"])
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
                    for _ in self._loader(d):
                        pass
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
