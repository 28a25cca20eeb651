"""Hand-written Hopper kernels of the port (CUDA C++ for sm_90a).

Each family keeps the reference's three-file layout: ``kernel.py`` (the
ctypes binding and wrappers of ``csrc/*.cu``), ``ref.py`` (the plain PyTorch
version, which the CPU tests use) and ``ops.py`` (``mode=`` dispatch through
``use_kernel``). ``_build`` compiles the sources with nvcc at first use.
"""

import torch


def use_kernel(mode: str, x: torch.Tensor) -> bool:
    """Resolve an op's dispatch ``mode`` against its operand's device:
    ``"auto"`` takes the CUDA kernel for a CUDA tensor and the plain version
    for a CPU one, ``"ref"`` the plain version anywhere, ``"kernel"`` the
    kernel (raising for a tensor that is not on CUDA)."""
    if mode not in ("auto", "ref", "kernel"):
        raise ValueError(f"unknown kernel dispatch mode {mode!r}")
    if mode == "kernel" and x.device.type != "cuda":
        raise ValueError(
            f"mode='kernel' needs CUDA tensors; got a tensor on {x.device}")
    return mode == "kernel" or (mode == "auto" and x.device.type == "cuda")
