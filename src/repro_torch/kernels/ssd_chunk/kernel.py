"""ctypes binding and wrapper of the SSD chunk-scan CUDA kernel (K6).

``csrc/ssd_chunk.cu`` replaces the TPU kernel
``repro.kernels.ssd_chunk.kernel.ssd_chunk_kernel`` (``kernel.py:70`` of the
reference): the Mamba2 SSD chunk scan with the (P, N) state carried across
chunks, forward only. Its contract is wider than the TPU kernel's, because
the model's mixer needs it: a batch axis, G groups of B and C broadcast to
the H heads, and the final state as a second output (no initial state).

bfloat16 inputs (the LM path) run SSD's chunk-parallel decomposition on the
tensor cores, chunk ``CHUNK`` = 128, in three launches: each chunk's own
end state (one block per chunk, head and batch), the state passed from
chunk to chunk (sequential over chunks only, in place in a float32 scratch
the wrapper allocates), and the output (one block per chunk, tile of heads
and batch, C B^T once per block). ``chunk_plan`` gives the grid and the
scratch's shape. float32 inputs keep the CUDA-core kernel, one block per
(batch, head) walking chunks of 32 in order. The source's head comment says what
bounds it and what the design does about it.

``ssd_chunk_kernel`` checks device, dtypes, shapes and strides, allocates
its outputs and scratch with ``torch.empty``, launches on the current
stream, raises on a CUDA error and adds one to ``LAUNCHES["ssd_chunk"]``
per call (the bfloat16 path's three launches are one call).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_chunk.cu"

LAUNCHES = {"ssd_chunk": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_P, MAX_N = 64, 128
CHUNK = 128         # the bfloat16 kernel's chunk (the TPU kernel's default)
HEADS_PER_BLOCK = 8  # the output pass's head tile (``kHT`` in the source)
_lib = None


def reset_launches() -> None:
    """Zero every launch count."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def chunk_plan(Bsz: int, S: int, H: int, G: int, P: int, N: int) -> dict:
    """Grid and scratch of the bfloat16 kernel for these sizes.

    ``chunks`` = ceil(S / CHUNK); the output pass runs one block per
    (chunk, tile of ``heads_per_block`` = HEADS_PER_BLOCK heads of one
    group, batch), C B^T once per block; ``head_tiles`` per group, the last
    one possibly short. ``scratch`` is the float32 (Bsz, chunks, H, P16,
    N16) array of chunk states (P and N rounded up to 16), ``decay`` the
    (Bsz, chunks, H) chunk decays.
    """
    nc = -(-S // CHUNK)
    per = HEADS_PER_BLOCK
    P16, N16 = -(-P // 16) * 16, -(-N // 16) * 16
    return {"chunks": nc, "heads_per_block": per, "head_tiles": -(-(H // G) // per),
            "scratch": (Bsz, nc, H, P16, N16), "decay": (Bsz, nc, H)}


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import _build

        lib = _build.load(SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_chunk_fwd.argtypes = [p] * 9 + [i] * 6 + [ll] * 12 + [i, p]
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
    dtype, final_state (Bsz, H, P, N) float32); float32 arithmetic, with
    bfloat16 products on the tensor cores (float32 operands as two bfloat16
    terms).
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
    scratch = decay = None
    if x.dtype == torch.bfloat16:
        plan = chunk_plan(Bsz, S, H, G, P, N)
        scratch = torch.empty(plan["scratch"], dtype=torch.float32, device=dev)
        decay = torch.empty(plan["decay"], dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_chunk_fwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            None if decay is None else decay.data_ptr(), Bsz, S, H, G, P, N,
            x.stride(0), x.stride(1), x.stride(2),
            Bm.stride(0), Bm.stride(1), Bm.stride(2),
            Cm.stride(0), Cm.stride(1), Cm.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2), _DTYPES[x.dtype],
            stream)
    if err:
        msg = lib.ssd_chunk_error_string(err).decode()
        raise RuntimeError(f"ssd_chunk launch failed: {msg} ({err})")
    LAUNCHES["ssd_chunk"] += 1
    return y, state

