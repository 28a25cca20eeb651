"""Device resolution shared by the port's entry points.

Every entry point (``tg.Experiment.compile``, ``train.loop.CTDGLinkPipeline``,
``core.device_sampler.DeviceRecencySampler``, the recipe) takes ``device=``
and defaults to ``"cuda"``. Without a GPU that default raises: the plain
PyTorch path runs only when the caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device`` with an explicit card index; raises
    for CUDA without a GPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        if dev.index is None:  # pin "cuda" to the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def host_tensor(a) -> torch.Tensor:
    """A host numpy array as a CPU tensor that owns writable memory.

    A read-only array (a read-only ``np.memmap`` column of a
    ``storage.MmapStore``, or a slice of one) is copied first: an aliasing
    tensor would keep reading a file mapping whose pages ``release()``
    drops, and ``torch.from_numpy`` warns on it. Writable arrays are shared,
    as ``torch.from_numpy`` shares them."""
    import numpy as np

    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())
