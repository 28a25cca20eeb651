"""Temporal neighborhoods: the ``NeighborBlock`` container.

The port's samplers live on the device (``core.device_sampler``), so the
block holds torch tensors. The host numpy samplers of ``repro.core.sampler``
(``RecencySampler``, ``UniformSampler``) are not part of the port yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class NeighborBlock:
    """Fixed-shape neighborhood of a set of seed nodes at query times.

    ``nbr_ids[i, k]``   : k-th sampled neighbor of seed i (-1 = padding)
    ``nbr_times[i, k]`` : interaction timestamp (0 where padded)
    ``nbr_eids[i, k]``  : edge-event index into storage (-1 where padded)
    ``mask[i, k]``      : True where a real neighbor is present

    ids, times and eids are int32 tensors, ``mask`` a bool tensor, all on
    the sampler's device.
    """

    nbr_ids: torch.Tensor
    nbr_times: torch.Tensor
    nbr_eids: torch.Tensor
    mask: torch.Tensor
