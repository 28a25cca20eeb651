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
