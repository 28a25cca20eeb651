"""LM architecture and shape configs (``--arch`` / ``--shape``), copied from
the reference's ``configs`` package: the ten assigned architectures as
data. ``get_arch`` resolves every one; the model raises
``NotImplementedError`` for the families the port does not carry yet."""

from repro_torch.configs.archs import ARCHS, get_arch
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "ARCHS", "get_arch"]
