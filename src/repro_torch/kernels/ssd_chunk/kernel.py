"""ctypes bindings and wrappers of the SSD chunk-scan CUDA kernels: the
scan (K6) and its backward (K6b).

``csrc/ssd_chunk.cu`` replaces the TPU kernel
``repro.kernels.ssd_chunk.kernel.ssd_chunk_kernel`` (``kernel.py:70`` of the
reference): the Mamba2 SSD chunk scan with the (P, N) state carried across
chunks (the TPU kernel is forward only). Its contract is wider than the
TPU kernel's, because the model's mixer needs it: a batch axis, G groups of
B and C broadcast to the H heads, and the final state as a second output
(no initial state).

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

``csrc/ssd_chunk_bwd.cu`` (K6b) replaces no TPU kernel: it is the gradient
that the reference leaves to JAX's autodiff of its plain ``ssd_mix``
(``repro/models/lm/layers.py:580``). ``ssd_chunk_bwd_kernel`` gives dx, ddt,
da, dBm and dCm from K6's inputs, the output's cotangent and, optionally,
the final state's; for bfloat16 in eight launches (K6's passes 1-2 again for
the entering states, the state cotangents and their reverse pass, the dx
pass, the dB / dC pass, the fixed-order sums), for float32 in one CUDA-core
kernel and the sums. ``bwd_plan`` gives its grids and scratch, which the
wrapper allocates; one call adds one to ``LAUNCHES["ssd_chunk_bwd"]``. A
training step runs K6 and K6b through ``ops._SSDChunkFn``.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_chunk.cu"
SOURCE_BWD = Path(__file__).resolve().parent / "csrc" / "ssd_chunk_bwd.cu"

LAUNCHES = {"ssd_chunk": 0, "ssd_chunk_bwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_P, MAX_N = 64, 128
CHUNK = 128         # the bfloat16 kernel's chunk (the TPU kernel's default)
HEADS_PER_BLOCK = 8  # the output pass's head tile (``kHT`` in the source)
CHUNK_F32 = 32      # the float32 kernels' chunk
_PASS_THREADS, _PASS_E = 128, 2  # the state passes' blocks (``kPassThreads``, ``kPassE``)
_lib = None
_lib_bwd = None


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


def bwd_plan(Bsz: int, S: int, H: int, G: int, P: int, N: int,
             dtype: torch.dtype = torch.bfloat16) -> dict:
    """Grids and scratch of K6b for these sizes, as ``ssd_chunk_bwd.cu``
    launches them (the wrapper allocates the scratch from it and passes
    ``chunks`` and ``head_tiles``, which the source checks).

    bfloat16: chunks of ``CHUNK``; ``states`` and ``cotan`` (Bsz, chunks, H,
    P16, N16) float32 (the entering states, split as K6's pass 2 writes
    them; the state cotangents), ``decay`` (Bsz, chunks, H), ``final`` (Bsz,
    H, P, N) (pass 2's final state, not used); ``part_b`` and ``part_c``
    (head_tiles, Bsz, S, G, N), the per-tile sums of dB and dC; ``part_a``
    (Bsz, chunks, H), the per-(batch, chunk) shares of da. float32: chunks
    of ``CHUNK_F32``, ``states`` (Bsz, chunks, H, P, N), no ``cotan``,
    ``decay`` or ``final``, ``part_a`` (Bsz, 1, H). ``grids`` names each
    launch's grid and ``scratch_bytes`` adds up the float32 scratch.
    """
    tiles = -(-(H // G) // HEADS_PER_BLOCK)
    P16, N16 = -(-P // 16) * 16, -(-N // 16) * 16
    count = Bsz * S * G * N
    if dtype == torch.bfloat16:
        nc = -(-S // CHUNK)
        groups = -(-(P16 * N16 // _PASS_E) // _PASS_THREADS)
        shapes = {"states": (Bsz, nc, H, P16, N16), "cotan": (Bsz, nc, H, P16, N16),
                  "decay": (Bsz, nc, H), "final": (Bsz, H, P, N),
                  "part_b": (tiles, Bsz, S, G, N), "part_c": (tiles, Bsz, S, G, N),
                  "part_a": (Bsz, nc, H)}
        grids = {"states": (nc, H, Bsz), "state_pass": (groups, H, Bsz),
                 "cotan": (nc, H, Bsz), "reverse_pass": (groups, H, Bsz),
                 "dx": (nc, tiles, Bsz * G), "dbc": (nc, tiles, Bsz * G),
                 "sum": (-(-count // 256),), "da": (-(-H // 128),)}
    else:
        nc = -(-S // CHUNK_F32)
        shapes = {"states": (Bsz, nc, H, P, N), "cotan": None, "decay": None,
                  "final": None, "part_b": (tiles, Bsz, S, G, N),
                  "part_c": (tiles, Bsz, S, G, N), "part_a": (Bsz, 1, H)}
        grids = {"f32": (tiles, Bsz * G), "sum": (-(-count // 256),),
                 "da": (-(-H // 128),)}
    nbytes = sum(4 * math.prod(v) for v in shapes.values() if v is not None)
    return {"chunk": CHUNK if dtype == torch.bfloat16 else CHUNK_F32, "chunks": nc,
            "head_tiles": tiles, "heads_per_block": HEADS_PER_BLOCK, **shapes,
            "grids": grids, "scratch_bytes": nbytes}


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


def _check(x, dt, a, Bm, Cm, dy=None, dstate=None):
    """The kernels' input contract (K6's, and K6b's ``dy`` and ``dstate``
    when given): device, dtypes, shapes, sizes and unit strides along P and
    N. Returns (Bsz, S, H, G, P, N)."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(
            "the SSD chunk kernels run on CUDA tensors (use mode='ref' or "
            "'auto' for the plain version)")
    if x.dtype not in _DTYPES or x.dim() != 4:
        raise TypeError(f"x must be a float32 or bfloat16 (B, S, H, P) tensor, "
                        f"got {x.dtype} {tuple(x.shape)}")
    Bsz, S, H, P = x.shape
    if Bm.dim() != 4:
        raise ValueError(f"Bm must be (B, S, G, N), got {tuple(Bm.shape)}")
    G, N = Bm.shape[2], Bm.shape[3]
    want = [("Bm", Bm, x.dtype, (Bsz, S, G, N)), ("Cm", Cm, x.dtype, (Bsz, S, G, N)),
            ("dt", dt, torch.float32, (Bsz, S, H)), ("a", a, torch.float32, (H,))]
    if dy is not None:
        want.append(("dy", dy, x.dtype, (Bsz, S, H, P)))
    if dstate is not None:
        want.append(("dstate", dstate, torch.float32, (Bsz, H, P, N)))
    for name, t, dtype, shape in want:
        if not isinstance(t, torch.Tensor) or t.dtype != dtype:
            raise TypeError(f"{name} must be a {dtype} tensor")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if G < 1 or H % G or not 1 <= P <= MAX_P or not 1 <= N <= MAX_N:
        raise ValueError(f"unsupported sizes H={H}, G={G}, P={P}, N={N}")
    if any(t.stride(3) != 1 for t in (x, Bm, Cm, x if dy is None else dy)):
        raise ValueError("x, Bm, Cm (and dy) need unit stride along P and N")
    return Bsz, S, H, G, P, N


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
    Bsz, S, H, G, P, N = _check(x, dt, a, Bm, Cm)
    dev = x.device
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


def _library_bwd():
    global _lib_bwd
    if _lib_bwd is None:
        from repro_torch.kernels import _build

        lib = _build.load(SOURCE_BWD)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_chunk_bwd.argtypes = [p] * 19 + [i] * 8 + [ll] * 15 + [i, p]
        lib.ssd_chunk_bwd.restype = i
        lib.ssd_chunk_bwd_error_string.argtypes = [i]
        lib.ssd_chunk_bwd_error_string.restype = ctypes.c_char_p
        _lib_bwd = lib
    return _lib_bwd


def ssd_chunk_bwd_kernel(x, dt, a, Bm, Cm, dy, dstate=None):
    """The gradients of ``ssd_chunk_kernel`` on the GPU (K6b).

    x, dt, a, Bm, Cm as ``ssd_chunk_kernel`` takes them; dy (Bsz, S, H, P)
    in x's dtype, unit stride along P; dstate (Bsz, H, P, N) float32, the
    final state's cotangent, or None (zero). Returns (dx, ddt, da, dBm,
    dCm), contiguous: dx, dBm and dCm in x's dtype, ddt (Bsz, S, H) and da
    (H,) float32. No atomics: a second call gives the same bits.
    """
    Bsz, S, H, G, P, N = _check(x, dt, a, Bm, Cm, dy, dstate)
    dev = x.device
    a = a.contiguous()
    dstate = None if dstate is None else dstate.contiguous()
    dx = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((Bsz, S, H), dtype=torch.float32, device=dev)
    dB = torch.empty((Bsz, S, G, N), dtype=x.dtype, device=dev)
    dC = torch.empty((Bsz, S, G, N), dtype=x.dtype, device=dev)
    if Bsz == 0 or S == 0 or H == 0:
        return (dx, ddt, torch.zeros((H,), dtype=torch.float32, device=dev), dB, dC)
    da = torch.empty((H,), dtype=torch.float32, device=dev)
    plan = bwd_plan(Bsz, S, H, G, P, N, x.dtype)
    scratch = {k: None if plan[k] is None else
               torch.empty(plan[k], dtype=torch.float32, device=dev)
               for k in ("states", "cotan", "decay", "final", "part_b", "part_c", "part_a")}

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _library_bwd()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_chunk_bwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            dy.data_ptr(), ptr(dstate), dx.data_ptr(), ddt.data_ptr(), da.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), *(ptr(scratch[k]) for k in (
                "states", "cotan", "decay", "final", "part_b", "part_c", "part_a")),
            Bsz, S, H, G, P, N, plan["chunks"], plan["head_tiles"],
            x.stride(0), x.stride(1), x.stride(2),
            Bm.stride(0), Bm.stride(1), Bm.stride(2),
            Cm.stride(0), Cm.stride(1), Cm.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            dy.stride(0), dy.stride(1), dy.stride(2), _DTYPES[x.dtype], stream)
    if err:
        msg = lib.ssd_chunk_bwd_error_string(err).decode()
        raise RuntimeError(f"ssd_chunk_bwd launch failed: {msg} ({err})")
    LAUNCHES["ssd_chunk_bwd"] += 1
    return dx, ddt, da, dB, dC
