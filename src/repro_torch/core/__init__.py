"""Host layer and device-resident sampling of the PyTorch port.

Numpy copies of the reference's event storage, views, granularity, batches,
hooks and negatives (bit-equal to ``repro.core``), plus the torch
``DeviceRecencySampler``, the device-recency link recipe and the
``PrefetchLoader`` that stages batches on a side CUDA stream.
"""

from repro_torch.core.batch import Batch
from repro_torch.core.device_sampler import DeviceRecencySampler
from repro_torch.core.granularity import EventOrderedError, TimeDelta
from repro_torch.core.graph import DGData, DGraph
from repro_torch.core.hooks import BASE_ATTRS, Hook, HookManager, LambdaHook, RecipeError, resolve_order
from repro_torch.core.loader import DGDataLoader, PrefetchLoader
from repro_torch.core.negatives import NegativeEdgeSampler
from repro_torch.core.recipes import EVAL_KEY, RECIPE_TGB_LINK, TRAIN_KEY, RecipeRegistry
from repro_torch.core.sampler import NeighborBlock

__all__ = [
    "Batch",
    "BASE_ATTRS",
    "DeviceRecencySampler",
    "DGData",
    "DGraph",
    "DGDataLoader",
    "EventOrderedError",
    "Hook",
    "HookManager",
    "LambdaHook",
    "NegativeEdgeSampler",
    "NeighborBlock",
    "PrefetchLoader",
    "RecipeError",
    "RecipeRegistry",
    "TimeDelta",
    "resolve_order",
    "RECIPE_TGB_LINK",
    "TRAIN_KEY",
    "EVAL_KEY",
]
