"""Host layer and device-resident sampling of the PyTorch port.

Numpy copies of the reference's event types and storage, views, granularity, batches,
hooks, negatives and host discretization (bit-equal to ``repro.core``; the
dict baseline ``discretize_naive`` too, and ``discretize_device`` on the card),
plus the torch ``DeviceRecencySampler`` and ``DeviceUniformSampler``, the
host ``UniformSampler``, the link recipe's recency and uniform branches, the
node-property and density-of-states recipes, the
``PrefetchLoader`` that stages batches on a side CUDA stream, and the DTDG
``SnapshotTensor`` built on the device by ``snapshot_tensor`` with its
snapshot recipe.
"""

from repro_torch.core.batch import Batch
from repro_torch.core.device_sampler import DeviceRecencySampler
from repro_torch.core.device_uniform import DeviceUniformSampler
from repro_torch.core.discretize import (
    discretize,
    discretize_device,
    discretize_edges_padded,
    discretize_naive,
)
from repro_torch.core.events import EdgeEvent, NodeEvent
from repro_torch.core.granularity import EventOrderedError, TimeDelta
from repro_torch.core.graph import DGData, DGraph, SnapshotTensor
from repro_torch.core.hooks import BASE_ATTRS, Hook, HookManager, LambdaHook, RecipeError, resolve_order
from repro_torch.core.loader import DGDataLoader, PrefetchLoader, snapshot_tensor
from repro_torch.core.negatives import NegativeEdgeSampler, snapshot_negatives
from repro_torch.core.recipes import (
    EVAL_KEY,
    RECIPE_ANALYTICS_DOS,
    RECIPE_DTDG_SNAPSHOT,
    RECIPE_TGB_LINK,
    RECIPE_TGB_NODE,
    TRAIN_KEY,
    RecipeRegistry,
)
from repro_torch.core.sampler import NeighborBlock, UniformSampler

__all__ = [
    "Batch",
    "BASE_ATTRS",
    "DeviceRecencySampler",
    "DeviceUniformSampler",
    "DGData",
    "DGraph",
    "DGDataLoader",
    "discretize",
    "discretize_device",
    "discretize_edges_padded",
    "discretize_naive",
    "EdgeEvent",
    "EventOrderedError",
    "Hook",
    "HookManager",
    "LambdaHook",
    "NegativeEdgeSampler",
    "NeighborBlock",
    "NodeEvent",
    "PrefetchLoader",
    "RecipeError",
    "RecipeRegistry",
    "SnapshotTensor",
    "TimeDelta",
    "UniformSampler",
    "resolve_order",
    "snapshot_negatives",
    "snapshot_tensor",
    "RECIPE_ANALYTICS_DOS",
    "RECIPE_DTDG_SNAPSHOT",
    "RECIPE_TGB_LINK",
    "RECIPE_TGB_NODE",
    "TRAIN_KEY",
    "EVAL_KEY",
]
