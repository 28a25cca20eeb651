"""``repro_torch.tg`` — the declarative experiment API of the port."""

from repro_torch.tg.experiment import Experiment
from repro_torch.tg.specs import DataSpec, ModelSpec, SamplerSpec, TrainSpec

__all__ = ["DataSpec", "Experiment", "ModelSpec", "SamplerSpec", "TrainSpec"]
