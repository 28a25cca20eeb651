"""``tg.Experiment`` — the declarative front door of the port.

Same specs and serialization as ``repro.tg.Experiment``. ``compile`` covers
the CTDG link quadrant (``task="link"``, no discretization) for the ported
pipeline, on ``device`` (``"cuda"`` by default); the snapshot and node
quadrants, out-of-core storage, telemetry and ``run()`` (training) raise
``NotImplementedError`` until their slices land.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Mapping

from repro_torch.device import resolve_device
from repro_torch.tg.specs import DataSpec, ModelSpec, SamplerSpec, TrainSpec

CTDG_LINK_MODELS = ("tgat", "tgn", "graphmixer", "dygformer", "tpnet")

TASKS = ("link", "node")


@dataclasses.dataclass(frozen=True)
class Experiment:
    """A fully-specified, serializable TG experiment (see the reference)."""

    data: DataSpec = dataclasses.field(default_factory=DataSpec)
    model: ModelSpec = dataclasses.field(default_factory=ModelSpec)
    train: TrainSpec = dataclasses.field(default_factory=TrainSpec)
    sampler: SamplerSpec = dataclasses.field(default_factory=SamplerSpec)
    task: str = "link"

    def __post_init__(self):
        if self.task not in TASKS:
            raise ValueError(f"unknown task {self.task!r}; have {TASKS}")

    # -- serialization ---------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """Plain-JSON dict capturing the whole experiment."""
        return {
            "task": self.task,
            "data": self.data.to_dict(),
            "model": self.model.to_dict(),
            "train": self.train.to_dict(),
            "sampler": self.sampler.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Experiment":
        """Rebuild an experiment from ``to_dict`` output."""
        return cls(
            task=d.get("task", "link"),
            data=DataSpec.from_dict(d.get("data", {})),
            model=ModelSpec.from_dict(d.get("model", {})),
            train=TrainSpec.from_dict(d.get("train", {})),
            sampler=SamplerSpec.from_dict(d.get("sampler", {})),
        )

    def to_json(self, **kwargs) -> str:
        """The experiment as a JSON blob (``json.dumps`` kwargs forwarded)."""
        return json.dumps(self.to_dict(), **kwargs)

    @classmethod
    def from_json(cls, blob: str) -> "Experiment":
        """Rebuild an experiment from ``to_json`` output."""
        return cls.from_dict(json.loads(blob))

    # -- compilation -----------------------------------------------------
    def compile(self, data=None, device="cuda"):
        """Assemble the pipeline this experiment describes on ``device``.

        ``data`` overrides ``DataSpec``'s generated stream with a pre-built
        ``DGData``. Only the CTDG link quadrant is ported.
        """
        resolve_device(device)
        d, m, t = self.data, self.model, self.train
        if self.task != "link" or d.discretization is not None:
            raise NotImplementedError(
                "the port compiles the CTDG link quadrant (task='link', no "
                "discretization); snapshot and node pipelines are later "
                "slices (ROADMAP A)")
        if d.storage is not None or t.telemetry is not None or t.data_shards > 1:
            raise NotImplementedError(
                "out-of-core storage, telemetry and data sharding are later "
                "slices of the port (ROADMAP A)")
        if m.name not in CTDG_LINK_MODELS:
            raise ValueError(
                f"model {m.name!r} is not an event-stream (CTDG) link model; "
                f"have {CTDG_LINK_MODELS}")
        if data is None:
            from repro_torch.data import generate

            data = generate(d.dataset, scale=d.scale)
        from repro_torch.train.loop import CTDGLinkPipeline

        return CTDGLinkPipeline(
            m.name, data,
            batch_size=t.batch_size, eval_negatives=t.eval_negatives,
            seed=t.seed, model_kwargs=dict(m.kwargs),
            sampler_spec=self.sampler, val_ratio=d.val_ratio,
            test_ratio=d.test_ratio, device=device,
        )
