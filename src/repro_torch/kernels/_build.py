"""Build and load the port's hand-written CUDA kernels.

Each ``*.cu`` source under ``kernels/*/csrc/`` exposes a plain C interface
and is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared
library, which the kernel's wrapper loads with ``ctypes``. Builds happen at
first use, from the sources in the checkout, into ``kernels/_build/``
(listed in ``.gitignore``); the library name carries a hash of the source,
the ``*.cuh`` headers beside it, the shared headers of ``kernels/csrc_common/``
(on every source's include path) and the flags, so an edited source or
header rebuilds and an unchanged one loads the library built before.
``build_all`` starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
# Headers every source may include (``-I``): the Hopper building blocks.
COMMON_DIR = KERNELS_DIR / "csrc_common"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LOADED: Dict[Path, ctypes.CDLL] = {}


def sources() -> List[Path]:
    """Every CUDA source of the port, in a stable order."""
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built with nvcc for "
        "sm_90a at first use (put the CUDA toolkit's bin/ on PATH)"
    )


def headers(src: Path) -> List[Path]:
    """The headers ``src`` may include: those beside it, then the shared
    ones of ``COMMON_DIR``."""
    return sorted(src.parent.glob("*.cuh")) + sorted(COMMON_DIR.glob("*.cuh"))


def library_path(src: Path) -> Path:
    """Where the library built from ``src`` lives (keyed by the content of
    the source, of its ``headers`` and of the flags)."""
    h = hashlib.sha256(src.read_bytes())
    for header in headers(src):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _start(src: Path):
    """Start ``nvcc`` for ``src`` into a temporary file beside its target;
    returns ``(process, tmp, target)`` or ``None`` when already built."""
    target = library_path(src)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-I", str(COMMON_DIR), "-o", tmp, str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, target


def _finish(src: Path, job) -> str:
    """Wait for ``nvcc``, install the library; returns nvcc's output (the
    ``-Xptxas -v`` report of registers, shared memory and spills)."""
    proc, tmp, target = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src.name}:\n{out}")
    os.replace(tmp, target)  # atomic: concurrent builders never see half
    return out


def build_all() -> Dict[str, str]:
    """Build every source that has no library yet, all ``nvcc`` processes
    running at once. Returns ``{library file name: nvcc output}`` (empty
    output for a library built before)."""
    with _LOCK:
        jobs = [(src, _start(src)) for src in sources()]
        return {library_path(src).name: "" if job is None else _finish(src, job)
                for src, job in jobs}


def load(src: Path) -> ctypes.CDLL:
    """The loaded library of ``src``, building it first if needed."""
    with _LOCK:
        target = library_path(src)
        lib = _LOADED.get(target)
        if lib is None:
            job = _start(src)
            if job is not None:
                _finish(src, job)
            lib = _LOADED[target] = ctypes.CDLL(str(target))
        return lib
