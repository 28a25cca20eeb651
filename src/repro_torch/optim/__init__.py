"""Optimizers of the port: AdamW on nested dicts of tensors, gradient
clipping by the global norm and the learning-rate schedules."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "warmup_cosine",
           "constant", "clip_by_global_norm", "global_norm"]
