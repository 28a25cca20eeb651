"""Legacy trainer names for the TG model zoo, over the shared engine in
``repro_torch.train.loop``.

``LinkPredictionTrainer`` is ``CTDGLinkPipeline`` with the reference's
legacy sampler kwargs, which map onto ``SamplerSpec`` as in
``repro.train.loop.CTDGLinkPipeline``: ``sampler=`` -> ``kind``,
``device_sampling=`` -> ``device``, ``k=`` -> ``k``, ``prefetch=`` ->
``prefetch``, ``uniform_checkpoint_adjacency=`` ->
``checkpoint_adjacency`` (an explicit ``sampler_spec`` wins); ``store=``
and ``data_shards=`` go to the pipeline as they are.
``SnapshotLinkTrainer`` is ``DTDGLinkPipeline``. New code declares
experiments through ``repro_torch.tg.Experiment``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.obs import Telemetry
from repro_torch.tg.specs import SamplerSpec
from repro_torch.train.loop import CTDGLinkPipeline, SnapshotLinkTrainer

__all__ = ["LinkPredictionTrainer", "SnapshotLinkTrainer", "legacy_sampler_spec"]


def legacy_sampler_spec(sampler: str = "recency", k: int = 20,
                        device_sampling: bool = False, prefetch: int = 2,
                        uniform_checkpoint_adjacency: bool = True) -> SamplerSpec:
    """The ``SamplerSpec`` the reference's pipeline builds from its legacy
    kwargs."""
    return SamplerSpec(kind=sampler, k=k, device=device_sampling,
                       prefetch=prefetch,
                       checkpoint_adjacency=uniform_checkpoint_adjacency)


class LinkPredictionTrainer(CTDGLinkPipeline):
    """``CTDGLinkPipeline`` with the reference's legacy sampler kwargs
    (``repro.train.tg_trainer.LinkPredictionTrainer``); ``device`` as in
    the pipeline (``"cuda"`` by default)."""

    def __init__(
        self,
        model_name: str,
        data,
        batch_size: int = 200,
        k: int = 20,
        lr: Optional[float] = None,
        eval_negatives: int = 20,
        seed: int = 0,
        model_kwargs: Optional[Dict[str, Any]] = None,
        device_sampling: bool = False,
        prefetch: int = 2,
        sampler: str = "recency",
        uniform_checkpoint_adjacency: bool = True,
        sampler_spec: Optional[SamplerSpec] = None,
        val_ratio: float = 0.15,
        test_ratio: float = 0.15,
        fused=None,
        store=None,
        telemetry: Optional[Telemetry] = None,
        device="cuda",
        data_shards: int = 1,
    ):
        spec = sampler_spec or legacy_sampler_spec(
            sampler, k, device_sampling, prefetch, uniform_checkpoint_adjacency)
        super().__init__(
            model_name, data, batch_size=batch_size, k=k, lr=lr,
            eval_negatives=eval_negatives, seed=seed, model_kwargs=model_kwargs,
            sampler_spec=spec, val_ratio=val_ratio, test_ratio=test_ratio,
            fused=fused, store=store, telemetry=telemetry, device=device,
            data_shards=data_shards)
