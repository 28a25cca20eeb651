"""Logical-axis rules, process meshes, and the node-partitioned layout.

Port of ``repro.distributed.sharding`` onto ``torch.distributed``. The
reference runs one process over many devices and partitions arrays with
``shard_map``; here every rank is a process of its own (SPMD: each runs the
same Python), holds its own block of node-partitioned state on its own
device, and each reference ``jax.lax.psum(x, axis)`` is an
``all_reduce(x, SUM)`` over that axis's process group. Every collective of
the port is an ``all_reduce``: it is the exact counterpart of ``psum``, and
the one reduction the gloo backend also runs on CUDA tensors (several ranks
sharing one card go over gloo, since NCCL refuses two ranks on one device).

  * ``make_node_mesh`` / ``make_2d_mesh`` — a 1-D ``(axis,)`` or the 2-D
    ``("data", "nodes")`` ``DeviceMesh`` over the initialized world (rank
    ``d * nodes + n`` sits at ``(d, n)``, the reference's row-major device
    grid). They raise unless the world holds exactly the ranks asked for.
  * ``axis_group`` / ``axis_index`` / ``axis_size`` — a mesh axis's process
    group, this rank's coordinate on it and its length (the reference's
    ``axis_name``, ``axis_index`` and ``psum(1, axis)``).
  * ``node_rows_per_shard`` — the row-wise node-id partition: shard ``s``
    owns nodes ``[s * per, (s + 1) * per)`` with ``per = ceil(N / S)``.
  * ``sync_state_masked_psum`` — the DistTGL masked mean of model state
    across a data axis, one ``all_reduce``.
  * ``all_reduce_tree`` — every leaf of a tree summed over a group, in one
    ``all_reduce`` per dtype.
  * The logical-axis table ``DEFAULT_RULES`` and ``logical_spec`` (the
    per-dimension mesh-axis names the reference's ``PartitionSpec`` holds),
    the process-global ``(mesh, rules)`` context and ``shard()``, the
    identity without a mesh. Placing LM parameters by these rules under a
    mesh (DTensor) belongs to LM training (ROADMAP A6): ``shard()`` raises
    there.

The reference's ``shard_map`` / ``SHARD_MAP_KW`` are a JAX-version shim and
have no counterpart; nor do ``row_sharding`` / ``replicated_sharding``,
whose placements are each rank's own tensors here. See
``docs/sharding.md`` for the layout.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

AxisVal = Union[None, str, Tuple[str, ...]]
Rules = Dict[str, AxisVal]

# The reference's default rules: DP over (pod, data); TP over model for
# heads/mlp/vocab/experts; FSDP shards the embed axis of params over data;
# "nodes" is the node-id row partition of device sampler state.
DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "embed_fsdp": "data",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "qkv": "model",
    "mlp": "model",
    "moe_mlp": "model",
    "experts": None,
    "expert_cap": None,
    "vocab": "model",
    "layers": None,
    "state": None,
    "conv": None,
    "frames": None,
    "patches": None,
    "cache_seq": None,
    "seq_shard": ("pod", "data"),
    "nodes": "data",
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Rules = dict(DEFAULT_RULES)


_CTX = _Ctx()
# Meshes made over the current world, so pipelines built one after another
# share one mesh's subgroups (keyed by the world's group object, which the
# key keeps alive: a later world never matches an old entry).
_MESHES: Dict[tuple, object] = {}


def set_sharding_context(mesh, rules: Optional[Rules] = None) -> None:
    """Install the process-global ``(mesh, rules)`` pair ``shard`` reads."""
    _CTX.mesh = mesh
    _CTX.rules = dict(DEFAULT_RULES if rules is None else rules)


def get_mesh():
    """The active mesh set by ``set_sharding_context`` (None = no mesh)."""
    return _CTX.mesh


def get_rules() -> Rules:
    """The active logical-axis rule table."""
    return _CTX.rules


class sharding_context:
    """``with sharding_context(mesh, rules): ...``"""

    def __init__(self, mesh, rules: Optional[Rules] = None):
        self._new = (mesh, rules)
        self._old = (None, {})

    def __enter__(self):
        self._old = (_CTX.mesh, _CTX.rules)
        set_sharding_context(*self._new)
        return self

    def __exit__(self, *exc):
        _CTX.mesh, _CTX.rules = self._old


def _mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: length}`` of a ``DeviceMesh``, or a mapping given as
    one (what the rule arithmetic reads)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def _mesh_axes_for(logical: Sequence[Optional[str]], rules: Rules, mesh,
                   shape: Optional[Sequence[int]] = None) -> list:
    """Map logical axis names to mesh axes, as the reference does: rules
    naming an axis this mesh lacks are dropped; with ``shape``, a mapping
    whose axis product does not divide its dimension loses axes from the
    front of its tuple until it does (or is dropped)."""
    sizes = _mesh_shape(mesh)
    out = []
    for i, name in enumerate(logical):
        ax = None if name is None else rules.get(name)
        if ax is None:
            out.append(None)
            continue
        if isinstance(ax, str):
            ax = (ax,)
        live = tuple(a for a in ax if a in sizes)
        if shape is not None:
            while live:
                prod = 1
                for a in live:
                    prod *= sizes[a]
                if prod and shape[i] % prod == 0:
                    break
                live = live[1:]
        out.append(live if len(live) > 1 else (live[0] if live else None))
    return out


def logical_spec(logical: Sequence[Optional[str]],
                 rules: Optional[Rules] = None, mesh=None,
                 shape: Optional[Sequence[int]] = None) -> tuple:
    """The per-dimension mesh-axis names for logical axis names under
    ``(rules, mesh)`` (the entries of the reference's ``PartitionSpec``),
    divisibility-reduced against ``shape`` when given; ``()`` without a
    mesh. ``mesh`` is a ``DeviceMesh`` or a ``{axis: length}`` mapping."""
    mesh = mesh if mesh is not None else _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None:
        return ()
    return tuple(_mesh_axes_for(logical, rules, mesh, shape))


def shard(x, *logical: Optional[str]):
    """Activation sharding constraint by logical axis names: the identity
    without an active mesh, as in the reference. Under a mesh the tensor
    would become a DTensor placed by the rules, which is LM training's
    (ROADMAP A6)."""
    if _CTX.mesh is None:
        return x
    raise NotImplementedError(
        "shard() under a mesh places LM tensors by logical axes (DTensor); "
        "that belongs to LM training (ROADMAP A6)")


# ----------------------------------------------------------------------
# Process meshes
# ----------------------------------------------------------------------
def _world_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], what: str,
                device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` over the whole initialized world, its
    ranks' devices of ``device_type`` (default "cuda" where a card is
    available, else "cpu"), cached per shape, names and type (a mesh's
    subgroups are made once)."""
    from torch.distributed.device_mesh import init_device_mesh

    need = 1
    for s in shape:
        if s < 1:
            raise ValueError("mesh axis sizes must be >= 1")
        need *= s
    if not dist.is_initialized():
        raise ValueError(
            f"requested {what} but no process group is initialized: start "
            f"{need} ranks (torchrun --nproc_per_node={need}) and call "
            f"repro_torch.launch.mesh.init_distributed first")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(
            f"requested {what} ({need} ranks) but the world holds {world} "
            f"ranks; start exactly {need}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    key = (shape, names, device_type, dist.group.WORLD)
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(device_type, shape,
                                        mesh_dim_names=names)
    return _MESHES[key]


def make_node_mesh(shards: int, axis: str = "data",
                   device_type: Optional[str] = None):
    """A 1-D ``(axis,)`` mesh over the ``shards`` ranks of the world — the
    mesh the device samplers shard their node rows over
    (``SamplerSpec.shards``). ``axis`` defaults to ``"data"``, as in the
    reference; ``device_type`` is the ranks' ("cuda" or "cpu")."""
    if shards < 1:
        raise ValueError("shards must be >= 1")
    return _world_mesh((int(shards),), (axis,), f"{shards} sampler shards",
                       device_type)


def make_2d_mesh(data_shards: int, node_shards: int,
                 axes: Tuple[str, str] = ("data", "nodes"),
                 device_type: Optional[str] = None):
    """A 2-D ``(data, nodes)`` mesh over the world's ``data * nodes``
    ranks. The data axis splits event batches into contiguous
    time-ordered sub-streams; the node axis splits sampler state row-wise
    by node id (replicated over data)."""
    return _world_mesh((int(data_shards), int(node_shards)), tuple(axes),
                       f"a {data_shards}x{node_shards} mesh", device_type)


def axis_group(mesh, axis: str):
    """The process group of ``axis``."""
    return mesh.get_group(axis)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh.get_local_rank(axis)


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def node_rows_per_shard(num_nodes: int, shards: int) -> int:
    """Node rows owned by each shard under the row-wise node-id partition:
    ``ceil(num_nodes / shards)`` (the last shard may own padding rows)."""
    return max(-(-int(num_nodes) // int(shards)), 1)


# ----------------------------------------------------------------------
# Collectives
# ----------------------------------------------------------------------
def all_reduce_flat(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Sum same-dtype tensors over ``group`` in one ``all_reduce``; returns
    the sums in the tensors' shapes (new tensors; the inputs are kept)."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def all_reduce_tree(tree, group):
    """Every leaf of a nested dict of tensors summed over ``group``, one
    ``all_reduce`` per dtype; a new tree of the same shape."""
    from repro_torch.tree import tree_leaves, tree_map

    leaves = tree_leaves(tree)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(leaves):
        by_dtype.setdefault(t.dtype, []).append(i)
    summed: List[Optional[torch.Tensor]] = [None] * len(leaves)
    for idx in by_dtype.values():
        for i, s in zip(idx, all_reduce_flat([leaves[i] for i in idx], group)):
            summed[i] = s
    it = iter(summed)
    return tree_map(lambda _: next(it), tree)


def sync_state_masked_psum(state: Dict, touched: torch.Tensor, group) -> Dict:
    """DistTGL masked-mean sync of model state over a data axis.

    ``touched`` is a bool mask over state rows (the leading dimension of
    every value in ``state``): rows touched on exactly one rank of
    ``group`` take that rank's value, rows touched on several the mean,
    untouched rows keep their (replicated) local value. The arithmetic is
    the reference's (float32 sums, divided by the count, cast back to each
    value's dtype); the counts and every contribution go in one
    ``all_reduce``."""
    keys = list(state)
    m = touched.to(torch.bool)
    parts = [m.to(torch.float32)]
    for key in keys:
        val = state[key]
        mm = m.reshape(m.shape + (1,) * (val.dim() - 1))
        parts.append(torch.where(mm, val, torch.zeros((), dtype=val.dtype,
                                                      device=val.device))
                     .to(torch.float32))
    cnt, *sums = all_reduce_flat(parts, group)
    out = {}
    for key, summed in zip(keys, sums):
        val = state[key]
        shape = cnt.shape + (1,) * (val.dim() - 1)
        mean = summed / torch.clamp(cnt, min=1.0).reshape(shape)
        keep = (cnt > 0).reshape(shape)
        out[key] = torch.where(keep, mean, val.to(torch.float32)).to(val.dtype)
    return out
