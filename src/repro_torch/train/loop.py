"""CTDG link prediction: the event-stream pipeline's inference surface.

``CTDGLinkPipeline`` assembles the TGB link recipe over the device recency
sampler, 1-layer TGAT and one-vs-many MRR evaluation, on one device
(``device="cuda"`` by default). ``evaluate(split)`` follows the reference
(``repro.train.loop.CTDGLinkPipeline.evaluate``): a warm pass through the
earlier splits that only runs the hooks, then the split's batches scored
one-vs-many. Batches come from the plain ``DGDataLoader``: the reference's
``PrefetchLoader`` (pinned host buffers, a side stream) is a later slice.
Training (``train_epoch``, AdamW, the backward kernel) and checkpoints come
with the training slice.
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
from repro_torch.models.tg import tgat
from repro_torch.tg.specs import SamplerSpec
from repro_torch.train.metrics import mrr

CTDG_LINK_MODELS = {"tgat", "graphmixer", "dygformer", "tgn", "tpnet"}


class CTDGLinkPipeline:
    """CTDG link prediction over the TGB link recipe (inference surface).

    Ported: ``model_name="tgat"`` (1 layer) with
    ``SamplerSpec(kind="recency", device=True)``; other models and
    samplers raise ``NotImplementedError``. Parameters come from the port's
    seeded init (``torch.Generator`` seeded with ``seed``) or from
    ``load_params`` (e.g. the reference's, via
    ``repro_torch.convert.params_from_jax``). ``fused`` forwards to
    ``tgat.link_scores``: ``None`` runs the fused path (the CUDA kernel on
    the GPU, its plain version on the CPU), ``"ref"`` forces the plain
    version, ``False`` the classic pre-gathered path.
    """

    def __init__(
        self,
        model_name: str,
        data: DGData,
        batch_size: int = 200,
        k: int = 20,
        eval_negatives: int = 20,
        seed: int = 0,
        model_kwargs: Optional[Dict[str, Any]] = None,
        sampler_spec: Optional[SamplerSpec] = None,
        val_ratio: float = 0.15,
        test_ratio: float = 0.15,
        fused=None,
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
        self.params = tgat.init(self.cfg, gen, device=self.device)

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

    # ------------------------------------------------------------------
    def load_params(self, params) -> None:
        """Install a parameter tree (nested dicts of tensors) on the
        pipeline's device."""
        def move(t):
            if isinstance(t, dict):
                return {k: move(v) for k, v in t.items()}
            return t.to(device=self.device, dtype=torch.float32)

        self.params = move(params)

    def _loader(self, data: DGData):
        """Hook-processed batches of ``data`` with every host array staged
        on the device. The recipe's ``DeviceTransferHook`` has no contract,
        so the topological order may run it before the neighbor hook; the
        reference's ``PrefetchLoader`` stages the finished batch again, and
        so does this loop."""
        for batch in DGDataLoader(DGraph(data), self.manager,
                                  batch_size=self.batch_size):
            yield stage_batch(batch, self.device)

    def _eval_step(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.no_grad():
            return tgat.link_scores(self.params, self.cfg, batch,
                                    self.batch_size, fused=self.fused)

    def reset_epoch_state(self) -> None:
        """Clear hook/sampler state for an epoch."""
        self.manager.reset_state()

    def evaluate(self, split: str = "val") -> Tuple[float, float]:
        """One-vs-many MRR on val/test (warm state from train[, val]).
        Returns ``(mrr, seconds of the scored pass)``."""
        self.reset_epoch_state()
        # Warm the sampler through earlier splits without predicting.
        with self.manager.activate(TRAIN_KEY):
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
                pos, neg = self._eval_step(batch)
                w = float(batch["batch_mask"].sum())
                rrs.append(mrr(pos, neg, batch["batch_mask"]) * w)
                masks.append(w)
        out = float(np.sum(rrs) / max(np.sum(masks), 1.0))
        return out, time.perf_counter() - t0
