"""ctypes bindings and wrappers of the flash attention CUDA kernels: K5, the
forward, and K5b, its gradient.

``csrc/flash_attention.cu`` replaces the TPU kernel
``repro.kernels.flash_attention.kernel.flash_attention_kernel``
(``kernel.py:77`` of the reference): online-softmax GQA attention, causal
with the offset ``Skv - Sq``, with an optional sliding window (the TPU
kernel's forward; its gradient is K5b, below). It is bounded by operations (the two products per visible pair). bfloat16
inputs run on the tensor cores (``mma.sync`` bf16 -> float32, one block
per (batch, head, 128-row q tile)); float32 inputs on the CUDA
cores in float32 (one block per (batch, head, 64-row q tile)), a dispatch
on dtype. Either walks only the kv tiles of 64 keys that the causal bound
and the window leave visible (``kv_tile_range``) and evaluates the mask
only in the tiles that need it (``tile_needs_mask``); the source's head
comment says what the design does about its bound. Asked for it
(``return_lse=True``), K5 also returns each row's float32 log-sum-exp.

``csrc/flash_attention_bwd.cu`` (K5b) replaces no TPU kernel: the
reference's LM differentiates its jnp blocked attention by autodiff. From
q, k, v, K5's output and log-sum-exp and the output's cotangent it returns
dq, dk and dv (dk and dv summed over each kv head's query heads) in three
device launches (the row statistics rowsum(dO * O), a dq pass over q tiles
and a dk/dv pass over kv tiles, each kv tile walking the q tiles that can
see it: ``q_tile_range``) and no float atomics, so a second call gives the
same bits. Tiles: ``BWD_TILES``. Its bfloat16 passes are ``wgmma``
kernels fed by a TMA ring; ``bwd_plan`` computes the arguments of their
tensor maps and the padded rows of their statistics, which the wrapper
passes to the CUDA source (it only encodes the maps and launches).

``flash_attention_kernel`` checks device, dtype, shapes, strides and
alignment, allocates its output with ``torch.empty``, launches on the
current stream, raises on a CUDA error and adds one to
``LAUNCHES["flash_attention"]`` per launch; ``flash_attention_bwd_kernel``
likewise, one ``LAUNCHES["flash_attention_bwd"]`` per call. It reads q, k and v through
their strides in either layout: ``"bhsd"`` (the reference's kernel
signature) or ``"bshd"`` (the model's tensors, no transposed copy).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (q rows, keys) of a block's tiles: the tensor-core kernel (bfloat16) and
# the CUDA-core kernel (float32).
TILES = {torch.bfloat16: (128, 64), torch.float32: (64, 64)}
# K5b's tiles per pass: (a block's own rows, the walked tile's rows). The dq
# pass owns q rows and walks kv tiles; the dk/dv pass owns keys and walks q
# tiles. bfloat16: two warpgroups own BWD_WG_ROWS rows each, and
# each skips the walked tiles its own rows cannot see (the block's walk at
# BWD_WG_ROWS rows).
BWD_TILES = {torch.bfloat16: {"dq": (128, 64), "dkdv": (128, 64)},
             torch.float32: {"dq": (64, 64), "dkdv": (64, 64)}}
BWD_WG_ROWS = 64
# The bf16 passes' TMA box (64 bf16 columns, one 128-byte swizzle row, by 64
# rows) and the padding of the row statistics (lse log2(e), Delta), whose
# rows Sq .. are (+inf, 0).
_BOX = (64, 64, 1, 1)
_STATS_ROWS = 128
_LOG2E = 1.4426950408889634
_lib = None
_lib_bwd = None


def kv_tile_range(q0: int, Sq: int, Skv: int, causal: bool, window: int,
                  block_q: int, block_k: int):
    """The kv tiles ``[t_beg, t_end)`` of ``block_k`` keys that the q tile
    of rows ``q0 .. q0 + block_q - 1`` walks: a mirror of the CUDA source's
    ``kv_tile_range``. A tile outside it is masked for every row; one
    inside it is visible to some row."""
    off = Skv - Sq
    first = q0 + off
    last = min(q0 + block_q, Sq) - 1 + off
    kend = min(Skv, last + 1) if causal else Skv
    kbeg = max(0, first - window + 1) if window > 0 else 0
    return kbeg // block_k, -(-kend // block_k)


def q_tile_range(k0: int, Sq: int, Skv: int, causal: bool, window: int,
                 block_k: int, block_q: int):
    """The q tiles ``[t_beg, t_end)`` of ``block_q`` rows that can see some
    key of ``k0 .. k0 + block_k - 1``: a mirror of the CUDA source's
    ``q_tile_range``, the walk of K5b's dk/dv pass (the transpose of
    ``kv_tile_range``). Key t is visible from row i when i >= t - off
    (causal) and i < t - off + window (window), off = Skv - Sq."""
    off = Skv - Sq
    k_last = min(k0 + block_k, Skv) - 1
    ibeg = max(0, k0 - off) if causal else 0
    iend = min(Sq, k_last - off + window) if window > 0 else Sq
    t_beg = ibeg // block_q
    return t_beg, (-(-iend // block_q) if iend > ibeg else t_beg)


def tile_needs_mask(q0: int, k0: int, Sq: int, Skv: int, causal: bool,
                    window: int, block_q: int, block_k: int) -> bool:
    """Whether the kernel evaluates the mask in the tile of q rows ``q0 ..``
    and keys ``k0 ..``: a mirror of the CUDA source's ``tile_needs_mask``.
    When False, every pair of the tile is visible."""
    off = Skv - Sq
    return (k0 + block_k > Skv or (causal and k0 + block_k - 1 > q0 + off)
            or (window > 0 and k0 <= q0 + block_q - 1 + off - window))


def bwd_scratch_shape(dtype, B: int, H: int, Sq: int):
    """The float32 scratch K5b's first launch writes: Delta (B, H, Sq) for
    float32; for bfloat16 (B H, sq_pad, 2), each row's (lse log2(e), Delta)
    with Sq rounded up to a multiple of 128 rows, the pad rows (+inf, 0)."""
    if dtype == torch.float32:
        return (B, H, Sq)
    return (B * H, -(-Sq // _STATS_ROWS) * _STATS_ROWS, 2)


def bwd_stats_ref(o, lse, do, layout: str = "bhsd"):
    """The bfloat16 passes' row statistics (``bwd_scratch_shape``), in
    float32: what the CUDA source's first launch computes."""
    T = (lambda x: x.transpose(1, 2)) if layout == "bshd" else (lambda x: x)
    B, H, Sq, _ = T(o).shape
    shape = bwd_scratch_shape(torch.bfloat16, B, H, Sq)
    out = torch.zeros(shape, dtype=torch.float32, device=o.device)
    out[:, Sq:, 0] = math.inf
    out[:, :Sq, 0] = (lse.float() * _LOG2E).reshape(B * H, Sq)
    out[:, :Sq, 1] = (T(do).float() * T(o).float()).sum(-1).reshape(B * H, Sq)
    return out


def bwd_tensor_map(D: int, rows: int, heads: int, B: int, strides):
    """The TMA map arguments of one bfloat16 operand of ``rows`` rows and
    ``heads`` heads whose element strides are ``strides`` (batch, head,
    sequence): dims (D, rows, heads, B), byte strides (sequence, head,
    batch), a stride of 0 taken as 16 (``_check_tma_strides`` allows 0 only
    on a dimension of extent 1), and the box (64 columns, 64 rows, 1, 1)."""
    sb, sh, ss = strides
    return ([D, rows, heads, B], [2 * x if x > 0 else 16 for x in (ss, sh, sb)],
            list(_BOX))


def bwd_plan(B: int, H: int, Hk: int, Sq: int, Skv: int, D: int, strides):
    """What the wrapper passes to K5b's bfloat16 passes besides the
    tensors, for the 24 element strides of q, k, v, o, dO, dq, dk, dv
    ((batch, head, sequence) each): a dict of ``maps``, the map arguments
    of q, k, v and dO in turn (dims, byte strides, box), and ``sq_pad``,
    the rows of the padded statistics (the dq pass's grid runs over them
    in blocks of ``BWD_TILES``' own rows)."""
    st = list(strides)
    maps = [bwd_tensor_map(D, Sq, H, B, st[0:3]), bwd_tensor_map(D, Skv, Hk, B, st[3:6]),
            bwd_tensor_map(D, Skv, Hk, B, st[6:9]), bwd_tensor_map(D, Sq, H, B, st[12:15])]
    return dict(maps=maps, sq_pad=bwd_scratch_shape(torch.bfloat16, B, H, Sq)[1])


def _check_tma_strides(tensors, layout: str):
    """TMA's rules for the bfloat16 passes' operands: every byte stride of a
    dimension longer than 1 is positive and below 2^40 (the 16-byte rule is
    ``_strides``')."""
    for t in tensors:
        sizes = t.shape[:3] if layout == "bhsd" else (t.shape[0], t.shape[2], t.shape[1])
        for n, s in zip(sizes, _bhs_strides(t, layout)):
            if n > 1 and not 0 < 2 * s < 2 ** 40:
                raise ValueError("the bfloat16 backward's TMA needs positive byte "
                                 "strides below 2^40 on every dimension longer than 1")


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
        lib.flash_attention_fwd.argtypes = (
            [p] * 5 + [i] * 6 + [ll] * 12 + [i, i, ctypes.c_float, i, p])
        lib.flash_attention_fwd.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _library_bwd():
    global _lib_bwd
    if _lib_bwd is None:
        from repro_torch.kernels import _build

        lib = _build.load(BWD_SOURCE)
        p, i, pll = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
        lib.flash_attention_bwd.argtypes = (
            [p] * 10 + [i] * 6 + [pll, pll] + [i, i, i, ctypes.c_float, i, p])
        lib.flash_attention_bwd.restype = i
        lib.flash_attention_bwd_error_string.argtypes = [i]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
        _lib_bwd = lib
    return _lib_bwd


def _bhs_strides(t: torch.Tensor, layout: str):
    """Element strides (batch, head, sequence) of a 4-d tensor in
    ``layout``; its last dimension must have unit stride."""
    sb, s1, s2, sd = t.stride()
    if sd != 1:
        raise ValueError("the last dimension (D) must have unit stride")
    return (sb, s1, s2) if layout == "bhsd" else (sb, s2, s1)


def _dims(q, k, v, causal: bool, window: int, layout: str):
    """Check q, k and v against K5's contract; returns (B, H, Hk, Sq, Skv, D)
    and their (batch, head, sequence) strides."""
    if not isinstance(q, torch.Tensor) or q.device.type != "cuda":
        raise ValueError(
            "the flash attention kernels run on CUDA tensors (use mode='ref' "
            "or 'auto' for the plain version)")
    if layout not in ("bhsd", "bshd"):
        raise ValueError(f"unknown layout {layout!r}")
    if q.dtype not in _DTYPES or q.dim() != 4:
        raise TypeError(f"q must be a float32 or bfloat16 4-d tensor, got "
                        f"{q.dtype} {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dtype != q.dtype or t.dim() != 4:
            raise TypeError(f"{name} must be a 4-d {q.dtype} tensor")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if layout == "bhsd":
        B, H, Sq, D = q.shape
        Hk, Skv = k.shape[1], k.shape[2]
    else:
        B, Sq, H, D = q.shape
        Skv, Hk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if Hk < 1 or H % Hk:
        raise ValueError(f"H={H} is not a multiple of Hk={Hk}")
    if D % 8 or not 8 <= D <= 128:
        raise ValueError(f"D={D} is not a multiple of 8 in [8, 128]")
    if Skv < 1 or ((causal or window) and Skv < Sq):
        raise ValueError(f"Skv={Skv} must be >= 1, and >= Sq={Sq} when causal "
                         f"or windowed")
    if window < 0:
        raise ValueError(f"window={window} must be >= 0")
    return (B, H, Hk, Sq, Skv, D), _strides((q, k, v), layout)


def _strides(tensors, layout: str):
    """The (batch, head, sequence) strides of each tensor, flat, after
    checking K5's alignment rules."""
    out = []
    for t in tensors:
        st = _bhs_strides(t, layout)
        if any(s % 8 for s in st) or t.data_ptr() % 16:
            raise ValueError("the flash attention kernels need strides that are "
                             "multiples of 8 and 16-byte aligned storage")
        out += list(st)
    return out


def _raise_on(err: int, lib, fn: str, what: str) -> None:
    if err:
        msg = getattr(lib, fn)(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def flash_attention_kernel(q, k, v, *, causal: bool = True, window: int = 0,
                           scale: float | None = None, layout: str = "bhsd",
                           return_lse: bool = False):
    """Flash attention on the GPU (K5).

    ``layout="bhsd"``: q (B, H, Sq, D), k and v (B, Hk, Skv, D);
    ``layout="bshd"``: q (B, Sq, H, D), k and v (B, Skv, Hk, D). All three
    float32 or all bfloat16 on one CUDA device, H % Hk == 0, D a multiple of
    8 up to 128, unit stride along D, the other strides multiples of 8 and
    16-byte aligned storage (any view of a contiguous tensor of such a shape
    qualifies); Skv >= Sq when causal or windowed (every row then sees a
    key). Returns a new tensor of q's shape, layout and dtype: the softmax
    over the visible keys (scores scaled by 1/sqrt(D) unless ``scale`` is
    given, float32 arithmetic); with ``return_lse`` also the float32
    log-sum-exp of each row's visible scaled scores, (B, H, Sq).
    """
    (B, H, Hk, Sq, Skv, D), strides = _dims(q, k, v, causal, window, layout)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if B == 0 or Sq == 0 or H == 0:
        return (out, lse) if return_lse else out
    strides += list(_bhs_strides(out, layout))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None,
            B, H, Hk, Sq, Skv, D, *strides, int(bool(causal)), int(window),
            float(scale if scale is not None else 1.0 / math.sqrt(D)),
            _DTYPES[q.dtype], stream)
    _raise_on(err, lib, "flash_attention_error_string", "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd_kernel(q, k, v, o, lse, do, *, causal: bool = True,
                               window: int = 0, scale: float | None = None,
                               layout: str = "bhsd"):
    """The gradient of flash attention on the GPU (K5b).

    q, k, v as ``flash_attention_kernel`` takes them; ``o`` and ``lse`` what
    it returned for them with ``return_lse=True``; ``do`` the cotangent of
    ``o`` (q's shape, layout and dtype; the same stride rules). Returns new
    tensors (dq, dk, dv) of the shapes, layout and dtype of q, k and v: dk
    and dv summed over each kv head's query heads, masked pairs contributing
    exactly 0.
    """
    (B, H, Hk, Sq, Skv, D), strides = _dims(q, k, v, causal, window, layout)
    for name, t in (("o", o), ("do", do)):
        if (not isinstance(t, torch.Tensor) or t.dtype != q.dtype
                or tuple(t.shape) != tuple(q.shape) or t.device != q.device):
            raise ValueError(f"{name} must be a {q.dtype} tensor of q's shape "
                             f"{tuple(q.shape)} on {q.device}")
    if (not isinstance(lse, torch.Tensor) or lse.dtype != torch.float32
            or tuple(lse.shape) != (B, H, Sq) or not lse.is_contiguous()
            or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous float32 ({B}, {H}, {Sq}) "
                         f"tensor on {q.device}")
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    if B == 0 or Sq == 0 or H == 0:
        return dq, dk, dv
    delta = torch.empty(bwd_scratch_shape(q.dtype, B, H, Sq), dtype=torch.float32,
                        device=q.device)
    strides += _strides((o, do), layout) + _strides((dq, dk, dv), layout)
    maps, sq_pad = None, 0
    if q.dtype == torch.bfloat16:
        _check_tma_strides((q, k, v, do), layout)
        plan = bwd_plan(B, H, Hk, Sq, Skv, D, strides)
        args = [x for m in plan["maps"] for part in m for x in part]
        maps, sq_pad = (ctypes.c_longlong * len(args))(*args), plan["sq_pad"]
    lib = _library_bwd()
    arr = (ctypes.c_longlong * len(strides))(*strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), B, H, Hk, Sq, Skv, D, arr, maps,
            sq_pad, int(bool(causal)), int(window),
            float(scale if scale is not None else 1.0 / math.sqrt(D)),
            _DTYPES[q.dtype], stream)
    _raise_on(err, lib, "flash_attention_bwd_error_string", "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
