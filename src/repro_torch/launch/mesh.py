"""Process setup and production meshes.

``init_distributed`` starts this process's rank from the environment a
launcher gives (torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) with the backend the caller names and
returns the rank's device. ``make_production_mesh`` and
``make_debug_mesh`` are the reference's ``(data, model)`` and
``(pod, data, model)`` meshes as ``DeviceMesh``es over the initialized
world. Importing this module initializes nothing.

A sharded run of the CTDG pipeline::

    torchrun --nproc_per_node=4 my_run.py

where ``my_run.py`` calls ``dev = init_distributed("nccl")`` and then
``tg.Experiment(sampler=SamplerSpec(device=True, shards=2),
train=TrainSpec(data_shards=2), ...).compile(device=dev)``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import _world_mesh


def init_distributed(backend: str, device=None) -> torch.device:
    """Initialize the default process group from the launcher's
    environment with ``backend`` ("nccl" or "gloo"), and return this
    rank's device: ``device`` if given, else ``cuda:{LOCAL_RANK}``. A CUDA
    device becomes the current card before the group is made. Nothing is
    chosen behind the caller's back: the backend is the one named, and a
    CUDA default without a card raises."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device(f"cuda:{local}" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"rank {rank} was given {dev} but no CUDA device is "
                f"available; pass device='cpu' to run on the CPU")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    return dev


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh over the world: ``(16, 16)``
    ``("data", "model")``, or ``(2, 16, 16)`` ``("pod", "data", "model")``
    with ``multi_pod``. Raises unless the world holds 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _world_mesh(shape, axes, f"the production mesh {shape}")


def make_debug_mesh(n_devices: Optional[int] = None):
    """A small ``("data", "model")`` mesh over ``n_devices`` ranks (default
    the world), the model axis 4, 2 or 1 wide, whichever divides first."""
    n = n_devices or dist.get_world_size()
    model = next(m for m in (4, 2, 1) if n % m == 0)
    return _world_mesh((n // model, model), ("data", "model"),
                       f"a debug mesh of {n} ranks")
