"""Pre-defined hook recipes (paper §4).

``RECIPE_TGB_LINK`` builds the TGB link-prediction hook pipeline: random
training negatives, one-vs-many eval negatives, recency or uniform
neighbors, edge-feature lookup, padding and the device transfer. The port
carries the branches of ``repro.core.recipes``: the recency sampler on the
host (``SamplerSpec(kind="recency")``, the reference's default) or the
device (``device=True``), and the uniform sampler (``kind="uniform"``) on
either, the device samplers also node-sharded over a mesh of ranks
(``shards`` / ``mesh=``). ``RECIPE_DTDG_SNAPSHOT`` builds
the DTDG snapshot link pipeline's per-snapshot negatives.
``RECIPE_TGB_NODE`` builds the node-property pipeline of the reference
(padding, host recency neighbors of the positive events only, edge-feature
lookup, the device transfer) and ``RECIPE_ANALYTICS_DOS`` the
density-of-states analytics hook.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.core.hooks import HookManager
from repro_torch.device import resolve_device
from repro_torch.core.tg_hooks import (
    DeviceRecencyNeighborHook,
    DOSEstimateHook,
    DeviceTransferHook,
    DeviceUniformNeighborHook,
    EdgeFeatureLookupHook,
    NegativeEdgeHook,
    PadBatchHook,
    RecencyNeighborHook,
    SnapshotNegativeHook,
    TGBEvalNegativesHook,
    UniformNeighborHook,
)

RECIPE_TGB_LINK = "tgb_link"
RECIPE_TGB_NODE = "tgb_node"
RECIPE_DTDG_SNAPSHOT = "dtdg_snapshot"
RECIPE_ANALYTICS_DOS = "analytics_dos"

TRAIN_KEY = "train"
EVAL_KEY = "eval"


class RecipeRegistry:
    """Name -> HookManager-factory registry for pre-defined recipes."""

    _builders: Dict[str, Callable[..., HookManager]] = {}

    @classmethod
    def register(cls, name: str):
        """Decorator: register a recipe factory under ``name``."""
        def deco(fn):
            cls._builders[name] = fn
            return fn

        return deco

    @classmethod
    def build(cls, name: str, **kwargs) -> HookManager:
        """Instantiate the recipe ``name`` with factory kwargs."""
        if name not in cls._builders:
            raise KeyError(f"unknown recipe {name!r}; have {sorted(cls._builders)}")
        return cls._builders[name](**kwargs)

    @classmethod
    def available(cls):
        """Sorted names of all registered recipes."""
        return sorted(cls._builders)


@RecipeRegistry.register(RECIPE_TGB_LINK)
def _tgb_link(
    num_nodes: int,
    spec,
    batch_size: int = 200,
    eval_negatives: int = 100,
    edge_feats: Optional[np.ndarray] = None,
    edge_feat_dim: int = 0,
    dst_pool: Optional[np.ndarray] = None,
    seed: int = 0,
    device="cuda",
    mesh=None,
    mesh_axis: Optional[str] = None,
) -> HookManager:
    """Build the TGB link-prediction hook pipeline from a ``SamplerSpec``.

    ``kind`` "recency" or "uniform", on the host or with ``device=True`` on
    ``device`` (this rank's device in a multi-rank run). ``spec.num_hops``
    (``None`` is 1) selects the hop-2 frontier, whose edge features a
    second lookup gathers (``nbr2_feats``), as in the reference. A uniform
    hook's adjacency must be built (``hook.build(...)`` over the stream)
    before the first batch; ``CTDGLinkPipeline`` builds it over the full
    stream, as the reference's does.

    ``mesh`` (a ``DeviceMesh``), or ``spec.shards``, which resolves to
    ``make_node_mesh(spec.shards, spec.mesh_axis)`` here, shards the device
    samplers' state by node id over ``mesh_axis`` (default
    ``spec.mesh_axis``; ``spec.partition`` picks the uniform CSR's cuts).
    Under a mesh the recency hook exposes no buffer unless
    ``spec.expose_buffer`` is True: the sharded block can only be read by
    the shard-aware fused layer (``docs/sharding.md``). Every rank builds
    the same recipe and sees the same batches.
    """
    if mesh_axis is None:
        mesh_axis = spec.mesh_axis
    if mesh is None and spec.shards:
        from repro_torch.distributed.sharding import make_node_mesh

        mesh = make_node_mesh(spec.shards, mesh_axis,
                              device_type=resolve_device(device).type)
    if mesh is not None and not spec.device:
        raise ValueError(
            "mesh-sharded sampling requires SamplerSpec(device=True)")
    shard_kw = {} if mesh is None else {"mesh": mesh, "mesh_axis": mesh_axis}
    num_hops = spec.num_hops if spec.num_hops is not None else 1
    m = HookManager()
    # Padding runs FIRST so negatives/neighbor tensors come out fixed-shape;
    # stateful hooks exclude padded events via batch_mask.
    m.register(PadBatchHook(batch_size))
    m.register(
        NegativeEdgeHook(num_nodes, num_negatives=1, seed=seed, dst_pool=dst_pool),
        key=TRAIN_KEY,
    )
    m.register(
        TGBEvalNegativesHook(num_nodes, num_negatives=eval_negatives, seed=seed,
                             dst_pool=dst_pool),
        key=EVAL_KEY,
    )
    # One shared neighbor sampler serves both keys (updates exclude padding
    # and happen once per batch).
    if spec.kind == "uniform":
        hook = DeviceUniformNeighborHook if spec.device else UniformNeighborHook
        kw = ({"device": device, "partition": spec.partition, **shard_kw}
              if spec.device else {})
        m.register(hook(num_nodes, spec.k, include_negatives=True, seed=seed,
                        num_hops=num_hops,
                        checkpoint_adjacency=spec.checkpoint_adjacency, **kw))
    elif spec.device:
        expose = spec.expose_buffer
        if mesh is not None and expose is None:
            expose = False
        m.register(DeviceRecencyNeighborHook(num_nodes, spec.k,
                                             num_hops=num_hops, device=device,
                                             expose_buffer=expose,
                                             edge_feats=edge_feats, **shard_kw))
    else:
        m.register(RecencyNeighborHook(num_nodes, spec.k, num_hops=num_hops))
    m.register(EdgeFeatureLookupHook(edge_feats, edge_feat_dim))
    if num_hops == 2:
        m.register(EdgeFeatureLookupHook(edge_feats, edge_feat_dim,
                                         prefix="nbr2"))
    m.register(DeviceTransferHook(device))
    return m


@RecipeRegistry.register(RECIPE_TGB_NODE)
def _tgb_node(
    num_nodes: int,
    k: int = 20,
    batch_size: int = 200,
    edge_feats: Optional[np.ndarray] = None,
    edge_feat_dim: int = 0,
    device="cuda",
) -> HookManager:
    """Build the node-property hook pipeline: padding, the host recency
    neighbors of the batch's positive events (no negatives), the
    edge-feature lookup and the device transfer."""
    m = HookManager()
    m.register(PadBatchHook(batch_size))
    m.register(RecencyNeighborHook(num_nodes, k, include_negatives=False,
                                   dedup=True))
    m.register(EdgeFeatureLookupHook(edge_feats, edge_feat_dim))
    m.register(DeviceTransferHook(device))
    return m


@RecipeRegistry.register(RECIPE_DTDG_SNAPSHOT)
def _dtdg_snapshot(
    num_nodes: Optional[int] = None,
    capacity: Optional[int] = None,
    num_negatives: int = 1,
    eval_negatives: int = 20,
    seed: int = 0,
    device="cuda",
) -> HookManager:
    """Build the DTDG snapshot link-prediction hook pipeline.

    With ``num_nodes``/``capacity`` given, registers per-snapshot negative
    hooks (``SnapshotNegativeHook``, row-pure draws) under the train and
    eval activation keys; without them, the recipe is the plain device
    transfer.
    """
    m = HookManager()
    if num_nodes is not None and capacity is not None:
        m.register(SnapshotNegativeHook(num_nodes, capacity, num_negatives,
                                        seed=seed, device=device),
                   key=TRAIN_KEY)
        m.register(SnapshotNegativeHook(num_nodes, capacity, eval_negatives,
                                        seed=seed, device=device),
                   key=EVAL_KEY)
    m.register(DeviceTransferHook(device))
    return m


@RecipeRegistry.register(RECIPE_ANALYTICS_DOS)
def _analytics_dos(num_nodes: int, num_moments: int = 10, seed: int = 0) -> HookManager:
    """Build the analytics pipeline: the batch's density-of-states
    moments (``DOSEstimateHook``)."""
    m = HookManager()
    m.register(DOSEstimateHook(num_nodes, num_moments=num_moments, seed=seed))
    return m
