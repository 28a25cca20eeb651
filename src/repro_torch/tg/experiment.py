"""``tg.Experiment`` — the declarative front door of the port.

Same specs and serialization as ``repro.tg.Experiment``. ``compile`` covers
every quadrant on ``device`` (``"cuda"`` by default), with
``TrainSpec.telemetry`` as a JSONL ``FileSink``:

  =========  =======================  ========================================
  task       discretization           pipeline
  =========  =======================  ========================================
  ``link``   ``None`` (event stream)  ``CTDGLinkPipeline`` (TGAT, TGN,
                                      GraphMixer, DyGFormer or TPNet over the
                                      recency or the uniform sampler, on the
                                      host or the device)
  ``link``   a ``TimeDelta``          ``DTDGLinkPipeline`` (snapshots)
  ``node``   a ``TimeDelta`` (the     ``DTDGNodePipeline`` for snapshot
             label window)            models; ``EventNodePipeline`` for
                                      ``pf``/``tgn`` (event windows)
  =========  =======================  ========================================

``run`` compiles, trains through ``TrainLoop`` and evaluates. An
``EventStore`` passed as ``data``, or the ``MmapStore`` at
``DataSpec.storage``, backs the stream with the store's columns
(``DGData.from_store``) and runs the event pipelines out-of-core.
``SamplerSpec.shards`` / ``mesh_axis`` / ``partition`` and
``TrainSpec.data_shards`` reach ``CTDGLinkPipeline``, whose meshes span the
initialized world's ranks (``repro_torch.launch.mesh.init_distributed``;
``docs/sharding.md``); the snapshot and node pipelines ignore
``data_shards``, as the reference's do.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Mapping, Tuple

from repro_torch.device import resolve_device
from repro_torch.tg.specs import DataSpec, ModelSpec, SamplerSpec, TrainSpec

CTDG_LINK_MODELS = ("tgat", "tgn", "graphmixer", "dygformer", "tpnet")
DTDG_MODELS = ("gcn", "gclstm", "tgcn")
EVENT_NODE_MODELS = ("pf", "tgn")

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
    def _telemetry(self, telemetry=None):
        """The run's ``repro_torch.obs.Telemetry``: the explicit override,
        else a ``FileSink`` writer at ``TrainSpec.telemetry``, else ``None``
        (the pipeline then keeps its own disabled instance)."""
        if telemetry is not None:
            return telemetry
        if self.train.telemetry is not None:
            from repro_torch.obs import FileSink, Telemetry

            return Telemetry(FileSink(self.train.telemetry))
        return None

    def compile(self, data=None, device="cuda", telemetry=None):
        """Assemble the pipeline this experiment describes on ``device``.

        ``data`` overrides ``DataSpec``'s generated stream with a pre-built
        ``DGData``, or with an ``EventStore``, which (like
        ``DataSpec.storage``) backs the stream with the store's columns and
        runs the event pipeline out-of-core (``store=`` of
        ``CTDGLinkPipeline``); ``telemetry`` overrides the
        ``TrainSpec.telemetry`` writer. See the module table for the
        pipeline each task and discretization axis gives.
        """
        resolve_device(device)
        d, m, t = self.data, self.model, self.train
        store = self._store(data)
        if store is not None:
            data = store.to_data()
        if self.task == "node":
            return self._compile_node(data, device, telemetry)
        names = CTDG_LINK_MODELS if d.discretization is None else DTDG_MODELS
        if m.name not in names:
            kind = ("an event-stream (CTDG) link" if d.discretization is None
                    else "a snapshot (DTDG)")
            raise ValueError(
                f"model {m.name!r} is not {kind} model; have {names} (set or "
                f"drop DataSpec.discretization for the other pipeline)")
        data = self._dataset(data)
        tel = self._telemetry(telemetry)
        if d.discretization is not None:
            from repro_torch.train.loop import DTDGLinkPipeline

            return DTDGLinkPipeline(
                m.name, data,
                snapshot_unit=d.discretization, edge_capacity=d.capacity,
                lr=t.lr, num_negatives=t.num_negatives,
                eval_negatives=t.eval_negatives, seed=t.seed,
                val_ratio=d.val_ratio, test_ratio=d.test_ratio,
                compiled=t.compiled, chunk_size=t.chunk_size,
                telemetry=tel, device=device, **dict(m.kwargs),
            )
        from repro_torch.train.loop import CTDGLinkPipeline

        return CTDGLinkPipeline(
            m.name, data,
            batch_size=t.batch_size, lr=t.lr,
            eval_negatives=t.eval_negatives, seed=t.seed,
            model_kwargs=dict(m.kwargs), sampler_spec=self.sampler,
            val_ratio=d.val_ratio, test_ratio=d.test_ratio,
            data_shards=t.data_shards, store=store, telemetry=tel,
            device=device,
        )

    def _store(self, data=None):
        """The out-of-core ``EventStore`` handle, if this experiment has
        one: an ``EventStore`` passed as ``data``, else the ``MmapStore`` at
        ``DataSpec.storage`` (``None`` otherwise)."""
        from repro_torch.storage import EventStore, MmapStore

        if isinstance(data, EventStore):
            return data
        if data is None and self.data.storage is not None:
            return MmapStore(self.data.storage)
        return None

    def _dataset(self, data=None):
        """The concrete ``DGData``: the given one (an ``EventStore`` is
        viewed through ``DGData.from_store``), else the ``MmapStore`` at
        ``DataSpec.storage``, else ``DataSpec``'s generated stream."""
        store = self._store(data)
        if store is not None:
            return store.to_data()
        if data is not None:
            return data
        from repro_torch.data import generate

        return generate(self.data.dataset, scale=self.data.scale)

    def _compile_node(self, data, device, telemetry):
        """The node task: ``DataSpec.discretization`` is the label window of
        both pipeline families."""
        d, m, t = self.data, self.model, self.train
        if d.discretization is None:
            raise ValueError(
                "task='node' needs DataSpec.discretization — it is the "
                "prediction-window axis for both pipeline families"
            )
        if m.name not in DTDG_MODELS + EVENT_NODE_MODELS:
            raise ValueError(
                f"model {m.name!r} is not a node-task model; have "
                f"{DTDG_MODELS + EVENT_NODE_MODELS}"
            )
        from repro_torch.train.nodeprop import DTDGNodePipeline, EventNodePipeline

        stream, tel = self._dataset(data), self._telemetry(telemetry)
        if m.name in DTDG_MODELS:
            return DTDGNodePipeline(
                m.name, stream, unit=d.discretization,
                lr=t.lr, seed=t.seed, capacity=d.capacity,
                val_ratio=d.val_ratio, test_ratio=d.test_ratio,
                compiled=t.compiled, device=device, telemetry=tel,
                **dict(m.kwargs),
            )
        return EventNodePipeline(
            m.name, stream, unit=d.discretization,
            lr=t.lr, seed=t.seed,
            val_ratio=d.val_ratio, test_ratio=d.test_ratio,
            device=device, telemetry=tel, **dict(m.kwargs),
        )

    # -- execution -------------------------------------------------------
    def run(self, data=None, splits: Tuple[str, ...] = ("test",), log=None,
            device="cuda") -> Dict[str, Any]:
        """Compile on ``device``, fit and evaluate in one call.

        Runs ``TrainSpec.epochs`` epochs through ``TrainLoop`` (eval
        cadence ``eval_every`` on ``eval_split``, checkpoint cadence
        ``ckpt_every`` into ``ckpt_dir``), then evaluates each of ``splits``.
        Returns ``{"pipeline", "history", "metrics"}``; ``metrics`` maps a
        split to the task metric (link: MRR, node: NDCG@10).
        """
        from repro_torch.train.loop import TrainLoop

        tel = self._telemetry()
        pipeline = self.compile(data, device=device, telemetry=tel)
        t = self.train
        history = TrainLoop(pipeline, telemetry=tel).fit(
            epochs=t.epochs, eval_every=t.eval_every, eval_split=t.eval_split,
            ckpt_dir=t.ckpt_dir, ckpt_every=t.ckpt_every, log=log,
        )
        metrics = {s: pipeline.evaluate(s)[0] for s in splits}
        return {"pipeline": pipeline, "history": history, "metrics": metrics}
