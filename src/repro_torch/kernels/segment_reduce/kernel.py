"""ctypes binding and wrapper of the segment-sum CUDA kernel.

``csrc/segment_sum.cu`` replaces the TPU kernel
``repro.kernels.segment_reduce.kernel.segment_sum_kernel``: a block owns a
tile of segments x columns in shared memory (``segment_tiles`` sizes it),
compacts the ids that fall in its tile in edge order and walks only those,
each thread summing its own output elements, so the result is the same on
every run (no atomics). It is bounded by the bytes of the output it writes;
the source's head comment says what the design does about that.

``segment_sum_kernel`` checks device, dtype, shape and contiguity, allocates
its output with ``torch.empty``, launches on the current stream, raises on a
CUDA error and adds one to ``LAUNCHES["segment_sum"]`` per launch. It takes
no part in autograd: ``ops._SegmentSumFn`` pairs it with the gather that is
its gradient.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "segment_sum.cu"

LAUNCHES = {"segment_sum": 0}

# The card's SMs (H100 SXM) and the blocks the tiles are sized for on each:
# a snapshot's ids crowd the low segments (the users), so small tiles spread
# them over more blocks.
SMS = 132
BLOCKS_PER_SM = 4
COLS = 32       # columns of a block's tile (a warp's lanes)
ACC = 4096      # float accumulators of a block's tile (16 KB)

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
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.segment_sum.argtypes = [p, p, p, i, i, i, i, p]
        lib.segment_sum.restype = i
        lib.segment_sum_error_string.argtypes = [i]
        lib.segment_sum_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def segment_tiles(D: int, G: int):
    """The kernel's tiling of a (G, D) output: ``(TG, grid_x, grid_y)``, TG
    segments (a multiple of 4, at most ACC / COLS) by COLS columns per
    block (a warp's lanes; those past D idle), about BLOCKS_PER_SM blocks
    per SM over the whole grid."""
    grid_y = -(-D // COLS)
    per_block = -(-G * grid_y // (SMS * BLOCKS_PER_SM))
    TG = min(ACC // COLS, max(4, -(-per_block // 4) * 4))
    return TG, -(-G // TG), grid_y


def segment_sum_kernel(data, seg_ids, num_segments: int):
    """Segment sum on the GPU: data (E, D) float32 and seg_ids (E,) int32,
    both contiguous on one CUDA device, ids in any order; ids outside
    ``[0, num_segments)`` are dropped. Returns a new (num_segments, D)
    float32 tensor (zeros where no id lands)."""
    if not isinstance(data, torch.Tensor) or data.device.type != "cuda":
        raise ValueError(
            "the segment-sum kernel runs on CUDA tensors (use mode='ref' or "
            "'auto' for the plain version)")
    if data.dtype != torch.float32 or data.dim() != 2:
        raise TypeError(f"data must be a float32 (E, D) tensor, got "
                        f"{data.dtype} {tuple(data.shape)}")
    E, D = data.shape
    if (not isinstance(seg_ids, torch.Tensor) or seg_ids.dtype != torch.int32
            or tuple(seg_ids.shape) != (E,)):
        raise TypeError(f"seg_ids must be an int32 ({E},) tensor")
    if seg_ids.device != data.device:
        raise ValueError(f"seg_ids is on {seg_ids.device}, data on {data.device}")
    if not (data.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("data and seg_ids must be contiguous")
    G = int(num_segments)
    if G < 0 or max(E * D, G * D) >= 2**31:
        raise ValueError(f"unsupported sizes E={E}, D={D}, G={G}")
    out = torch.empty((G, D), dtype=torch.float32, device=data.device)
    if G == 0 or D == 0:
        return out
    lib = _library()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        TG, _, _ = segment_tiles(D, G)
        err = lib.segment_sum(data.data_ptr(), seg_ids.data_ptr(),
                              out.data_ptr(), E, D, G, TG, stream)
    if err:
        msg = lib.segment_sum_error_string(err).decode()
        raise RuntimeError(f"segment_sum launch failed: {msg} ({err})")
    LAUNCHES["segment_sum"] += 1
    return out
