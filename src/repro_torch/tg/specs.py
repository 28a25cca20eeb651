"""Typed, serializable experiment specs of the port's ``tg`` front door.

The same frozen dataclasses, fields and JSON form as ``repro.tg.specs``, so
one experiment blob reads in both packages:

  ``DataSpec``    — *what stream*: dataset + chronological splits + the
                    optional ``TimeDelta`` discretization axis (the CTDG/DTDG
                    switch).
  ``SamplerSpec`` — *what neighborhoods*: recency/uniform × host/device ×
                    hops × checkpoint policy.
  ``ModelSpec``   — *what model*: a zoo name plus its config kwargs.
  ``TrainSpec``   — *how to train*: optimizer, epochs, cadences.

Fields the port does not carry yet (snapshots, storage, sharding) keep
their place so blobs round-trip;
``tg.Experiment.compile`` raises ``NotImplementedError`` when one is set.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

from repro_torch.core.granularity import TimeDelta


def timedelta_to_dict(td: Optional[TimeDelta]) -> Optional[Dict[str, Any]]:
    """JSON-serializable form of a ``TimeDelta`` (``None`` passes through)."""
    if td is None:
        return None
    return {"unit": td.unit, "value": td.value}


def timedelta_from_dict(d) -> Optional[TimeDelta]:
    """Inverse of ``timedelta_to_dict``; also accepts unit strings like
    ``"h"`` (the ``TimeDelta.coerce`` shorthand) and ``TimeDelta`` values."""
    if d is None or isinstance(d, TimeDelta):
        return d
    if isinstance(d, str):
        return TimeDelta.coerce(d)
    return TimeDelta(d["unit"], int(d.get("value", 1)))


class _SpecBase:
    """Shared ``to_dict``/``from_dict`` plumbing for flat spec dataclasses
    (fields with plain-JSON values; subclasses override for special
    fields)."""

    def to_dict(self) -> Dict[str, Any]:
        """Plain-JSON dict of this spec's fields."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]):
        """Rebuild a spec from ``to_dict`` output (unknown keys rejected)."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"{cls.__name__}: unknown spec keys {sorted(unknown)}")
        return cls(**dict(d))


@dataclasses.dataclass(frozen=True)
class DataSpec(_SpecBase):
    """Dataset + chronological splits + the discretization axis.

    ``dataset``/``scale`` name a ``repro_torch.data.generate`` stream
    (ignored when a pre-built ``DGData`` is passed to
    ``Experiment.compile``). ``discretization`` is the CTDG/DTDG switch
    (``None`` keeps the event stream; a ``TimeDelta`` or unit string like
    ``"h"`` asks for snapshots, with ``capacity`` their row count).
    ``val_ratio``/``test_ratio`` are the ``DGData.split`` boundaries.
    ``storage`` names an on-disk event store directory. The port compiles
    the event stream only, without ``storage``.
    """

    dataset: str = "wikipedia"
    scale: float = 1.0
    val_ratio: float = 0.15
    test_ratio: float = 0.15
    discretization: Optional[TimeDelta] = None
    capacity: Optional[int] = None
    storage: Optional[str] = None

    def __post_init__(self):
        if self.discretization is not None and not isinstance(
            self.discretization, TimeDelta
        ):
            object.__setattr__(
                self, "discretization", TimeDelta.coerce(self.discretization)
            )

    def to_dict(self) -> Dict[str, Any]:
        """Plain-JSON dict (the ``TimeDelta`` axis as ``{unit, value}``)."""
        d = dataclasses.asdict(self)
        d["discretization"] = timedelta_to_dict(self.discretization)
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "DataSpec":
        """Rebuild from ``to_dict`` output (axis dict/str/None accepted)."""
        d = dict(d)
        d["discretization"] = timedelta_from_dict(d.get("discretization"))
        return super().from_dict(d)


@dataclasses.dataclass(frozen=True)
class SamplerSpec(_SpecBase):
    """Temporal-neighbor sampling strategy for event-stream pipelines.

    ``kind``: ``"recency"`` (K most recent, circular buffers) or
    ``"uniform"`` (K uniform draws from the strict past). ``device=True``
    selects the device-resident sampler. ``num_hops=None`` derives the hop
    count from the model depth. ``expose_buffer`` forwards to
    ``DeviceRecencyNeighborHook`` (``None`` = on: the fused kernel reads
    the packed buffer). ``prefetch`` is the reference's ``PrefetchLoader``
    queue depth; the port's pipeline runs its hooks in the calling thread
    and does not read it. ``checkpoint_adjacency``, ``shards``, ``mesh_axis`` and
    ``partition`` are the reference's uniform-sampler and mesh options. The
    port runs ``kind="recency", device=True`` on one device.
    """

    kind: str = "recency"
    k: int = 20
    num_hops: Optional[int] = None
    device: bool = False
    checkpoint_adjacency: bool = True
    expose_buffer: Optional[bool] = None
    prefetch: int = 2
    shards: Optional[int] = None
    mesh_axis: str = "data"
    partition: str = "rows"

    def __post_init__(self):
        if self.kind not in ("recency", "uniform"):
            raise ValueError(
                f"unknown sampler kind {self.kind!r}; use 'recency' or 'uniform'"
            )
        if self.num_hops not in (None, 1, 2):
            raise ValueError("num_hops must be None (auto), 1 or 2")
        if self.partition not in ("rows", "degree"):
            raise ValueError(
                f"partition must be 'rows' or 'degree', got {self.partition!r}"
            )
        if self.shards is not None:
            if self.shards < 1:
                raise ValueError("shards must be a positive integer or None")
            if not self.device:
                raise ValueError(
                    "shards requires device=True (only the device-resident "
                    "samplers have mesh-sharded state)"
                )


@dataclasses.dataclass(frozen=True)
class ModelSpec(_SpecBase):
    """A model-zoo name plus its config kwargs.

    CTDG link models: ``tgat``, ``tgn``, ``graphmixer``, ``dygformer``,
    ``tpnet`` (the port runs ``tgat``). ``kwargs`` feed the model config
    (e.g. ``{"num_layers": 1}`` for TGAT) and must stay JSON-serializable.
    """

    name: str = "tgat"
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        """Plain-JSON dict (kwargs copied, not aliased)."""
        return {"name": self.name, "kwargs": dict(self.kwargs)}


@dataclasses.dataclass(frozen=True)
class TrainSpec(_SpecBase):
    """Optimizer, epochs, eval cadence, and checkpoint policy.

    The port reads every field of the CTDG link pipeline: ``lr``,
    ``epochs``, ``batch_size``, ``eval_negatives``, ``seed``, the eval and
    checkpoint cadences and ``telemetry`` (a JSONL path). ``num_negatives``,
    ``compiled`` and ``chunk_size`` belong to the snapshot pipelines, which
    are not ported; ``data_shards > 1`` (the reference's 2-D mesh) makes
    ``Experiment.compile`` raise.
    """

    lr: Optional[float] = None
    epochs: int = 1
    batch_size: int = 200
    num_negatives: int = 1
    eval_negatives: int = 20
    seed: int = 0
    eval_every: int = 0
    eval_split: str = "val"
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0
    compiled: bool = True
    chunk_size: Optional[int] = None
    data_shards: int = 1
    telemetry: Optional[str] = None

    def __post_init__(self):
        if self.data_shards < 1:
            raise ValueError("data_shards must be a positive integer")
        if self.data_shards > 1 and self.batch_size % self.data_shards:
            raise ValueError(
                f"batch_size {self.batch_size} must be divisible by "
                f"data_shards {self.data_shards} (each data shard takes a "
                f"contiguous time-ordered sub-stream of the batch)"
            )
