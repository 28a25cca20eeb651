"""ctypes binding and wrapper of the SSD chunk-scan CUDA kernel (K6).

``csrc/ssd_chunk.cu`` replaces the TPU kernel
``repro.kernels.ssd_chunk.kernel.ssd_chunk_kernel`` (``kernel.py:70`` of the
reference): the Mamba2 SSD chunk scan with the (P, N) state carried across
chunks, forward only. Its contract is wider than the TPU kernel's, because
the model's mixer needs it: a batch axis, G groups of B and C broadcast to
the H heads, and the final state as a second output (no initial state).
One block per (batch, head) walks the chunks in order with the state in
shared memory; the source's head comment says what bounds it.

``ssd_chunk_kernel`` checks device, dtypes, shapes and strides, allocates
its outputs with ``torch.empty``, launches on the current stream, raises on
a CUDA error and adds one to ``LAUNCHES["ssd_chunk"]`` per launch.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_chunk.cu"

LAUNCHES = {"ssd_chunk": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_P, MAX_N = 64, 128
_lib = None


def reset_launches() -> None:
    """Zero every launch count."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import _build

        lib = _build.load(SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_chunk_fwd.argtypes = [p] * 7 + [i] * 6 + [ll] * 12 + [i, p]
        lib.ssd_chunk_fwd.restype = i
        lib.ssd_chunk_error_string.argtypes = [i]
        lib.ssd_chunk_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def ssd_chunk_kernel(x, dt, a, Bm, Cm):
    """SSD chunk scan on the GPU (K6), from a zero state.

    x: (Bsz, S, H, P); Bm, Cm: (Bsz, S, G, N), all float32 or all bfloat16,
    unit stride along P and N (views of a wider tensor are read in place);
    dt: (Bsz, S, H) float32; a: (H,) float32; H % G == 0, P <= 64, N <= 128,
    all on one CUDA device. Returns (y (Bsz, S, H, P) contiguous in x's
    dtype, final_state (Bsz, H, P, N) float32), float32 arithmetic.
    """
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(
            "the SSD chunk kernel runs on CUDA tensors (use mode='ref' or "
            "'auto' for the plain version)")
    if x.dtype not in _DTYPES or x.dim() != 4:
        raise TypeError(f"x must be a float32 or bfloat16 (B, S, H, P) tensor, "
                        f"got {x.dtype} {tuple(x.shape)}")
    Bsz, S, H, P = x.shape
    dev = x.device
    if Bm.dim() != 4:
        raise ValueError(f"Bm must be (B, S, G, N), got {tuple(Bm.shape)}")
    G, N = Bm.shape[2], Bm.shape[3]
    for name, t, dtype, shape in (("Bm", Bm, x.dtype, (Bsz, S, G, N)),
                                  ("Cm", Cm, x.dtype, (Bsz, S, G, N)),
                                  ("dt", dt, torch.float32, (Bsz, S, H)),
                                  ("a", a, torch.float32, (H,))):
        if not isinstance(t, torch.Tensor) or t.dtype != dtype:
            raise TypeError(f"{name} must be a {dtype} tensor")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if G < 1 or H % G or not 1 <= P <= MAX_P or not 1 <= N <= MAX_N:
        raise ValueError(f"unsupported sizes H={H}, G={G}, P={P}, N={N}")
    if x.stride(3) != 1 or Bm.stride(3) != 1 or Cm.stride(3) != 1:
        raise ValueError("x, Bm and Cm need unit stride along P and N")
    a = a.contiguous()
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    if Bsz == 0 or S == 0 or H == 0:
        return y, state.zero_()
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_chunk_fwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), state.data_ptr(), Bsz, S, H, G, P, N,
            x.stride(0), x.stride(1), x.stride(2),
            Bm.stride(0), Bm.stride(1), Bm.stride(2),
            Cm.stride(0), Cm.stride(1), Cm.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2), _DTYPES[x.dtype], stream)
    if err:
        msg = lib.ssd_chunk_error_string(err).decode()
        raise RuntimeError(f"ssd_chunk launch failed: {msg} ({err})")
    LAUNCHES["ssd_chunk"] += 1
    return y, state
