"""ctypes binding and wrapper of the flash attention CUDA kernel (K5).

``csrc/flash_attention.cu`` replaces the TPU kernel
``repro.kernels.flash_attention.kernel.flash_attention_kernel``
(``kernel.py:77`` of the reference): online-softmax GQA attention, causal
with the offset ``Skv - Sq``, with an optional sliding window, forward only.
It is bounded by operations (the two products per visible pair). bfloat16
inputs run on the tensor cores (``mma.sync`` bf16 -> float32, one block
per (batch, head, 128-row q tile)); float32 inputs on the CUDA
cores in float32 (one block per (batch, head, 64-row q tile)), a dispatch
on dtype. Either walks only the kv tiles of 64 keys that the causal bound
and the window leave visible (``kv_tile_range``) and evaluates the mask
only in the tiles that need it (``tile_needs_mask``); the source's head
comment says what the design does about its bound.

``flash_attention_kernel`` checks device, dtype, shapes, strides and
alignment, allocates its output with ``torch.empty``, launches on the
current stream, raises on a CUDA error and adds one to
``LAUNCHES["flash_attention"]`` per launch. It reads q, k and v through
their strides in either layout: ``"bhsd"`` (the reference's kernel
signature) or ``"bshd"`` (the model's tensors, no transposed copy).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

LAUNCHES = {"flash_attention": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (q rows, keys) of a block's tiles: the tensor-core kernel (bfloat16) and
# the CUDA-core kernel (float32).
TILES = {torch.bfloat16: (128, 64), torch.float32: (64, 64)}
_lib = None


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


def tile_needs_mask(q0: int, k0: int, Sq: int, Skv: int, causal: bool,
                    window: int, block_q: int, block_k: int) -> bool:
    """Whether the kernel evaluates the mask in the tile of q rows ``q0 ..``
    and keys ``k0 ..``: a mirror of the CUDA source's ``tile_needs_mask``.
    When False, every pair of the tile is visible."""
    off = Skv - Sq
    return (k0 + block_k > Skv or (causal and k0 + block_k - 1 > q0 + off)
            or (window > 0 and k0 <= q0 + block_q - 1 + off - window))


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
            [p, p, p, p] + [i] * 6 + [ll] * 12 + [i, i, ctypes.c_float, i, p])
        lib.flash_attention_fwd.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _bhs_strides(t: torch.Tensor, layout: str):
    """Element strides (batch, head, sequence) of a 4-d tensor in
    ``layout``; its last dimension must have unit stride."""
    sb, s1, s2, sd = t.stride()
    if sd != 1:
        raise ValueError("the last dimension (D) must have unit stride")
    return (sb, s1, s2) if layout == "bhsd" else (sb, s2, s1)


def flash_attention_kernel(q, k, v, *, causal: bool = True, window: int = 0,
                           scale: float | None = None, layout: str = "bhsd"):
    """Flash attention on the GPU (K5).

    ``layout="bhsd"``: q (B, H, Sq, D), k and v (B, Hk, Skv, D);
    ``layout="bshd"``: q (B, Sq, H, D), k and v (B, Skv, Hk, D). All three
    float32 or all bfloat16 on one CUDA device, H % Hk == 0, D a multiple of
    8 up to 128, unit stride along D, the other strides multiples of 8 and
    16-byte aligned storage (any view of a contiguous tensor of such a shape
    qualifies); Skv >= Sq when causal or windowed (every row then sees a
    key). Returns a new tensor of q's shape, layout and dtype: the softmax
    over the visible keys (scores scaled by 1/sqrt(D) unless ``scale`` is
    given, float32 arithmetic).
    """
    if not isinstance(q, torch.Tensor) or q.device.type != "cuda":
        raise ValueError(
            "the flash attention kernel runs on CUDA tensors (use mode='ref' "
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
    strides = []
    for t in (q, k, v):
        st = _bhs_strides(t, layout)
        if any(s % 8 for s in st) or t.data_ptr() % 16:
            raise ValueError("q, k and v need strides that are multiples of 8 "
                             "and 16-byte aligned storage")
        strides += list(st)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0 or H == 0:
        return out
    strides += list(_bhs_strides(out, layout))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, Hk, Sq, Skv, D, *strides, int(bool(causal)), int(window),
            float(scale if scale is not None else 1.0 / math.sqrt(D)),
            _DTYPES[q.dtype], stream)
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({err})")
    LAUNCHES["flash_attention"] += 1
    return out
