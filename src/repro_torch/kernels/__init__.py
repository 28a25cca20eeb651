"""Hand-written Hopper kernels of the port (CUDA C++ for sm_90a).

Each family keeps the reference's three-file layout: ``kernel.py`` (the
ctypes binding and wrappers of ``csrc/*.cu``), ``ref.py`` (the plain PyTorch
version, which the CPU tests use) and ``ops.py`` (``mode=`` dispatch).
``_build`` compiles the sources with nvcc at first use.
"""
