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
the final state's. For bfloat16 it reads K6's own chunk states, which the
caller kept (``ssd_chunk_kernel(..., keep=True)``, as the autograd
Function does); then the state cotangents (K6's pass 1 on dy and C, which
also writes each chunk's decay sums into a chunk table), the reverse state
pass (bf16 images of s_in and g for TMA, and <g, s_in>), the chunk pass on
``wgmma`` fed by a TMA ring (one kernel at N16 = 16, a dx and a dB / dC
kernel at N16 = 128) and one launch of fixed-order sums: four or five
launches. float32 runs one CUDA-core kernel and the sums. ``bwd_plan``
gives the grids, the heads per block and the scratch, ``bwd_maps`` the
tensor maps' arguments; the wrapper allocates, and one call adds one to
``LAUNCHES["ssd_chunk_bwd"]``. A training step runs K6
and K6b through ``ops._SSDChunkFn``.
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
SMS = 132           # an H100 SXM's SMs: K6b's chunk pass fills them once
BWD_STAGES = 2      # K6b's ring over a block's heads (``kStages``)
DOT_PARTS = 32      # the reverse pass's blocks per state at most (``kDotParts``)
TAB = 2 * CHUNK + DOT_PARTS  # the chunk table's floats per (batch, chunk, head) (``kTab``)
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


def bwd_heads_per_block(blocks: int, Hg: int) -> int:
    """Heads a block of K6b's chunk pass walks, for ``blocks`` (chunk, batch,
    group) triples of ``Hg`` heads each: the fewest tiles of heads among
    those that take the fewest steps on the busiest SM, counting waves of
    ``SMS`` blocks times (heads per block + 2), the 2 for a block's fixed
    costs (C and B, the ring's first head, its partial sums)."""
    best = None
    for hpb in range(1, Hg + 1):
        tiles = -(-Hg // hpb)
        key = (-(-blocks * tiles // SMS) * (hpb + 2), tiles)
        if best is None or key < best[0]:
            best = (key, hpb)
    return best[1]


def bwd_smem_bytes(N16: int, dx: bool, dbc: bool) -> int:
    """Dynamic shared memory of one K6b chunk-pass instance (``ChunkSmem``
    in the source): C and B of the chunk, ``BWD_STAGES`` stages of a head's
    x, dy and s and g images, R^T (dB / dC), the stages' chunk tables, the
    per-head sums (dx), the barriers and 1,024 bytes of alignment slack."""
    na = 2 if N16 > 64 else 1
    cb, x, st = na * CHUNK * 128, CHUNK * 128, na * 64 * 128
    total = 2 * cb + BWD_STAGES * (2 * x + 2 * st) + (3 * 64 * 128 if dbc else 0)
    total += BWD_STAGES * TAB * 4 + (4 * 13 * CHUNK if dx else 0)
    return total + 8 * (2 * BWD_STAGES + 1) + 1024


def bwd_plan(Bsz: int, S: int, H: int, G: int, P: int, N: int,
             dtype: torch.dtype = torch.bfloat16) -> dict:
    """Grids and scratch of K6b for these sizes, as ``ssd_chunk_bwd.cu``
    launches them (the wrapper allocates the scratch from it and passes
    ``chunks``, ``head_tiles`` and ``heads_per_block``, which the source
    checks).

    bfloat16: chunks of ``CHUNK``; no ``states`` or ``decay``: K6b reads
    K6's own (its scratch (Bsz, chunks, H, P16, N16), split as pass 2
    writes it, and decays (Bsz, chunks, H)); ``cotan`` (Bsz, chunks, H,
    P16, N16) float32 (the state cotangents D_c); ``table`` (Bsz,
    chunks, H, TAB) (each chunk's cum and dt, and the reverse pass's
    partial sums of <g, s_in>); ``images`` (2, Bsz, chunks, H, P16, N16)
    bf16 (s_in's bf16 terms and g, which the chunk pass reads by TMA);
    ``part_b`` and ``part_c`` (head_tiles, Bsz, S, G, N), the per-tile
    sums of dB and dC; ``part_a`` (Bsz, chunks, H), the per-(batch, chunk)
    shares of da. The chunk pass runs one block per (chunk, tile of
    ``heads_per_block`` heads of one group, batch): one kernel ``chunk``
    at N16 = 16, two (``chunk_dx``, ``chunk_dbc``) at N16 = 128, with
    ``smem`` bytes each. float32: chunks of ``CHUNK_F32``, tiles of
    ``HEADS_PER_BLOCK`` heads, ``states`` (Bsz, chunks, H, P, N),
    ``part_a`` (Bsz, 1, H), nothing else but the partial sums. ``grids``
    names each launch's grid in order, ``dtypes`` each scratch's dtype and
    ``scratch_bytes`` adds them up.
    """
    P16, N16 = -(-P // 16) * 16, -(-N // 16) * 16
    count = Bsz * S * G * N
    Hg = H // G
    f32 = torch.float32
    if dtype == torch.bfloat16:
        nc = -(-S // CHUNK)
        hpb = bwd_heads_per_block(nc * Bsz * G, Hg)
        tiles = -(-Hg // hpb)
        groups = -(-(P16 * N16 // _PASS_E) // _PASS_THREADS)
        st = (Bsz, nc, H, P16, N16)
        shapes = {"states": None, "decay": None, "cotan": st,
                  "table": (Bsz, nc, H, TAB), "images": (2,) + st,
                  "part_b": (tiles, Bsz, S, G, N), "part_c": (tiles, Bsz, S, G, N),
                  "part_a": (Bsz, nc, H)}
        dtypes = {k: (torch.bfloat16 if k == "images" else f32) for k in shapes}
        grids = {"cotan": (nc, H, Bsz), "reverse_pass": (groups, H, Bsz)}
        chunk = (nc, tiles, Bsz * G)
        if N16 <= 16:
            grids["chunk"] = chunk
            smem = {"chunk": bwd_smem_bytes(N16, True, True)}
        else:
            grids["chunk_dx"] = grids["chunk_dbc"] = chunk
            smem = {"chunk_dx": bwd_smem_bytes(N16, True, False),
                    "chunk_dbc": bwd_smem_bytes(N16, False, True)}
        grids["sum"] = (-(-(count + H) // 256),)
        extra = {"heads_per_block": hpb, "reverse_blocks": groups, "smem": smem,
                 "stages": BWD_STAGES}
    else:
        nc = -(-S // CHUNK_F32)
        tiles = -(-Hg // HEADS_PER_BLOCK)
        shapes = {"states": (Bsz, nc, H, P, N), "decay": None, "cotan": None, "table": None,
                  "images": None, "part_b": (tiles, Bsz, S, G, N), "part_c": (tiles, Bsz, S, G, N),
                  "part_a": (Bsz, 1, H)}
        dtypes = {k: f32 for k in shapes}
        grids = {"f32": (tiles, Bsz * G), "sum": (-(-(count + H) // 256),)}
        extra = {"heads_per_block": HEADS_PER_BLOCK}
    nbytes = sum(dtypes[k].itemsize * math.prod(v) for k, v in shapes.items() if v is not None)
    return {"chunk": CHUNK if dtype == torch.bfloat16 else CHUNK_F32, "chunks": nc,
            "head_tiles": tiles, **extra, **shapes, "dtypes": dtypes, "grids": grids,
            "scratch_bytes": nbytes}


def tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA can read the bf16 tensor ``t`` (unit last stride) in
    place: a 16-byte aligned base and every byte stride of a dimension
    longer than 1 a positive multiple of 16."""
    return (t.data_ptr() % 16 == 0
            and all(n == 1 or (s > 0 and 2 * s % 16 == 0)
                    for n, s in zip(t.shape[:-1], t.stride()[:-1])))


def tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` when ``tma_ready``, else a copy whose rows start 16 bytes apart
    (its last dimension padded to a multiple of 8), viewed at ``t``'s shape:
    what K6b's tensor maps read. Only the chunk pass reads the copy."""
    if tma_ready(t):
        return t
    w = -(-t.shape[-1] // 8) * 8
    buf = t.new_zeros(tuple(t.shape[:-1]) + (w,))
    buf[..., :t.shape[-1]] = t
    return buf[..., :t.shape[-1]]


def bwd_tensor_map(dims, strides, rows: int):
    """One TMA map's arguments: ``dims`` (innermost first) and the element
    strides of dims 1-3 as byte strides (a dimension of extent 1 gets 16,
    which it never uses), the box 64 columns by ``rows`` rows."""
    st = [2 * s if n > 1 else 16 for n, s in zip(dims[1:], strides)]
    return [int(d) for d in dims] + st + [64, rows, 1, 1]


def bwd_maps(x, dy, Bm, Cm, plan: dict):
    """The six tensor maps' arguments of K6b's bfloat16 chunk pass, in the
    source's order: x and dy as (P, S, H, Bsz), Bm and Cm as (N, S, G,
    Bsz), boxes of 64 columns by ``CHUNK`` rows; the s and g images as
    (N16, P16, H, Bsz chunks), boxes of 64 x 64. The operands are what
    ``tma_operand`` gives (their strides, in elements)."""
    out = []
    for t in (x, dy, Bm, Cm):
        Bsz, S, H, P = t.shape
        sb, ss, sh, _ = t.stride()
        out.append(bwd_tensor_map((P, S, H, Bsz), (ss, sh, sb), CHUNK))
    _, Bsz, nc, H, P16, N16 = plan["images"]
    img = bwd_tensor_map((N16, P16, H, Bsz * nc), (N16, P16 * N16, H * P16 * N16), 64)
    return out + [img, list(img)]


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


def ssd_chunk_kernel(x, dt, a, Bm, Cm, keep: bool = False):
    """SSD chunk scan on the GPU (K6), from a zero state.

    x: (Bsz, S, H, P); Bm, Cm: (Bsz, S, G, N), all float32 or all bfloat16,
    unit stride along P and N (views of a wider tensor are read in place);
    dt: (Bsz, S, H) float32; a: (H,) float32; H % G == 0, P <= 64, N <= 128,
    all on one CUDA device. Returns (y (Bsz, S, H, P) contiguous in x's
    dtype, final_state (Bsz, H, P, N) float32); float32 arithmetic, with
    bfloat16 products on the tensor cores (float32 operands as two bfloat16
    terms). ``keep``: also return the bfloat16 path's chunk states and
    decays, ``(scratch, decay)`` as ``chunk_plan`` shapes them (the states
    entering each chunk, split as pass 3 reads them), which K6b reads (None
    for float32); the outputs are the same.
    """
    Bsz, S, H, G, P, N = _check(x, dt, a, Bm, Cm)
    dev = x.device
    a = a.contiguous()
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    scratch = decay = None
    if x.dtype == torch.bfloat16:
        plan = chunk_plan(Bsz, S, H, G, P, N)
        scratch = torch.empty(plan["scratch"], dtype=torch.float32, device=dev)
        decay = torch.empty(plan["decay"], dtype=torch.float32, device=dev)
    if Bsz == 0 or S == 0 or H == 0:
        state.zero_()
        return (y, state, None if scratch is None else (scratch, decay)) if keep else (y, state)
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
    if keep:
        return y, state, None if scratch is None else (scratch, decay)
    return y, state


def _library_bwd():
    global _lib_bwd
    if _lib_bwd is None:
        from repro_torch.kernels import _build

        lib = _build.load(SOURCE_BWD)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_chunk_bwd.argtypes = [p] * 25 + [i] * 9 + [ll] * 15 + [i, p]
        lib.ssd_chunk_bwd.restype = i
        lib.ssd_chunk_bwd_error_string.argtypes = [i]
        lib.ssd_chunk_bwd_error_string.restype = ctypes.c_char_p
        _lib_bwd = lib
    return _lib_bwd


def _check_kept(kept, plan: dict, dev):
    """K6's kept (scratch, decay) against the shapes this call needs."""
    st, dec = kept
    want = ((plan["cotan"], st), (plan["part_a"], dec))
    for shape, t in want:
        if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32 or t.device != dev
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise ValueError("kept must be K6's (scratch, decay) of these inputs "
                             "(ssd_chunk_kernel(..., keep=True))")


def ssd_chunk_bwd_kernel(x, dt, a, Bm, Cm, dy, dstate=None, kept=None):
    """The gradients of ``ssd_chunk_kernel`` on the GPU (K6b).

    x, dt, a, Bm, Cm as ``ssd_chunk_kernel`` takes them; dy (Bsz, S, H, P)
    in x's dtype, unit stride along P; dstate (Bsz, H, P, N) float32, the
    final state's cotangent, or None (zero); kept: for bfloat16 (required),
    what ``ssd_chunk_kernel(x, dt, a, Bm, Cm, keep=True)`` returned third
    (K6's chunk states and decays of these inputs); None for float32.
    Returns (dx, ddt, da, dBm, dCm), contiguous: dx, dBm and dCm in x's
    dtype, ddt (Bsz, S, H) and da (H,) float32. No atomics: a second call
    gives the same bits.
    """
    bf = x.dtype == torch.bfloat16
    if bf != (kept is not None):
        raise ValueError("kept: K6's (scratch, decay) of these inputs for bfloat16 "
                         "(ssd_chunk_kernel(..., keep=True)), None for float32")
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
    if bf:
        _check_kept(kept, plan, dev)
    names = ("states", "decay", "cotan", "table", "images", "part_b", "part_c", "part_a")
    scratch = {k: None if plan[k] is None else
               torch.empty(plan[k], dtype=plan["dtypes"][k], device=dev) for k in names}
    if bf:
        scratch["states"], scratch["decay"] = kept
    maps = tma = None
    if bf:
        tma = [tma_operand(t) for t in (x, dy, Bm, Cm)]
        maps = (ctypes.c_longlong * 66)(*(v for m in bwd_maps(*tma, plan) for v in m))

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _library_bwd()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_chunk_bwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            dy.data_ptr(), ptr(dstate), dx.data_ptr(), ddt.data_ptr(), da.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), *(ptr(scratch[k]) for k in names),
            *(ptr(t) for t in (tma or (None,) * 4)),
            None if maps is None else ctypes.addressof(maps),
            Bsz, S, H, G, P, N, plan["chunks"], plan["head_tiles"], plan["heads_per_block"],
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
