"""ctypes bindings and wrappers of the fused temporal layer CUDA kernels.

``csrc/fused_temporal_layer.cu`` replaces the TPU kernel
``repro.kernels.temporal_attention.kernel.fused_temporal_layer_kernel``
(K1): the fused neighbor gather, Bochner time and edge-feature bias folds
and masked softmax attention over the packed recency buffer.
``csrc/fused_temporal_layer_bwd.cu`` replaces its backward
``fused_temporal_layer_bwd_kernel`` (K2), every gradient of the layer.

Both run the factored form: with a slot's features x_j = [phi_j ; e_j]
(X = d_time + d_edge wide), the bias groups factor per seed, since
q . (x_j W_k) = (W_k q) . x_j and sum_j p_j x_j W_v = (sum_j p_j x_j) W_v.
So each weight matrix is crossed once per seed, by blocks that hold one
head's weight block in shared memory and run tiles of 8 seeds through it;
a slot pass runs one block per seed over O(H (D + X)) work a slot, its
slots' rows staged in shared memory 16 slots at a time; and the backward
reduces the weight gradients over S rows of per-seed sums instead of
S * K slot rows. K1 is three device launches (project, slots,
back-project; the slot pass alone with both bias groups off), K2 five
(project and zeroing, slots in two passes, back-project, weight-gradient
partials over seed ranges, their fixed-order sums). The bound of both is
bytes: ~0.0091 ms for K1 at S = 4,400 and ~0.0045 ms for K2 at S = 600 on
an H100 (``chip_smoke.py::layer_bound`` and ``layer_bwd_bound``); their
measured times are in PERF.md. The sources' head comments give the design
and its numerics; ``tile_plan`` and ``workspace_bytes`` mirror their seed
tiling and workspace arithmetic in Python.

``fused_temporal_layer_kernel`` is K1's wrapper;
``fused_recency_attention_kernel`` (the ids-only TPU surface,
``kernel.py:746`` of the reference) runs the same CUDA code with both bias
groups off. ``fused_temporal_layer_bwd_kernel`` is K2's. Each wrapper
checks device, dtype, shape and contiguity, allocates its output and
workspace with ``torch.empty``, launches on the current stream, raises on
a CUDA error, and adds one to its entry in ``LAUNCHES`` per call, however
many device launches the call makes. The wrappers take no part in autograd
themselves: ``ops._FusedLayerFn`` pairs the two into one differentiable
call.

``csrc/temporal_attention.cu`` replaces the TPU kernel
``temporal_attention_kernel`` (``kernel.py:100`` of the reference): masked
seed -> K-neighbor attention over pre-gathered (S, K, H, D) keys and values,
the attention core of the classic path (K3). ``csrc/temporal_attention_bwd.cu``
is its gradient (K3b), which the reference leaves to XLA's autodiff of the
oracle; ``ops._TemporalAttentionFn`` pairs the two. Both run one warp per
seed over all heads, the valid slots' rows staged in chunks
(``csrc/temporal_attention.cuh``); ``ta_plan`` mirrors their launch plan.
``temporal_attention_kernel`` and ``temporal_attention_bwd_kernel`` are
their wrappers.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_temporal_layer.cu"
BWD_SOURCE = SOURCE.with_name("fused_temporal_layer_bwd.cu")
TA_SOURCE = SOURCE.with_name("temporal_attention.cu")
TA_BWD_SOURCE = SOURCE.with_name("temporal_attention_bwd.cu")

LAUNCHES = {"fused_temporal_layer": 0, "fused_recency_attention": 0,
            "fused_temporal_layer_bwd": 0, "temporal_attention": 0,
            "temporal_attention_bwd": 0}

_lib = None
_bwd_lib = None
_ta_lib = None
_ta_bwd_lib = None


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
        lib.fused_temporal_layer_fwd_workspace.argtypes = [i] * 6
        lib.fused_temporal_layer_fwd_workspace.restype = ctypes.c_size_t
        lib.fused_temporal_layer_fwd.argtypes = [p] * 15 + [i] * 6 + [
            ctypes.c_float, p]
        lib.fused_temporal_layer_fwd.restype = i
        lib.fused_temporal_layer_error_string.argtypes = [i]
        lib.fused_temporal_layer_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _bwd_library():
    global _bwd_lib
    if _bwd_lib is None:
        from repro_torch.kernels import _build

        lib = _build.load(BWD_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_temporal_layer_bwd_workspace.argtypes = [i] * 6
        lib.fused_temporal_layer_bwd_workspace.restype = ctypes.c_size_t
        lib.fused_temporal_layer_bwd.argtypes = [p] * 21 + [i] * 7 + [
            ctypes.c_float, p]
        lib.fused_temporal_layer_bwd.restype = i
        lib.fused_temporal_layer_bwd_error_string.argtypes = [i]
        lib.fused_temporal_layer_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def _ta_library():
    global _ta_lib
    if _ta_lib is None:
        from repro_torch.kernels import _build

        lib = _build.load(TA_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.temporal_attention_fwd.argtypes = [p] * 5 + [i] * 6 + [
            ctypes.c_float, p]
        lib.temporal_attention_fwd.restype = i
        lib.temporal_attention_plan.argtypes = [i] * 6 + [p]
        lib.temporal_attention_plan.restype = None
        lib.temporal_attention_error_string.argtypes = [i]
        lib.temporal_attention_error_string.restype = ctypes.c_char_p
        _ta_lib = lib
    return _ta_lib


def _ta_bwd_library():
    global _ta_bwd_lib
    if _ta_bwd_lib is None:
        from repro_torch.kernels import _build

        lib = _build.load(TA_BWD_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.temporal_attention_bwd.argtypes = [p] * 8 + [i] * 6 + [
            ctypes.c_float, p]
        lib.temporal_attention_bwd.restype = i
        lib.temporal_attention_bwd_error_string.argtypes = [i]
        lib.temporal_attention_bwd_error_string.restype = ctypes.c_char_p
        _ta_bwd_lib = lib
    return _ta_bwd_lib


# The sources' tile arithmetic (fused_temporal_layer.cuh and
# fused_temporal_layer_bwd.cu): the projections take the seeds in tiles of
# 8; the backward's weight gradients split the S seeds into at most 32
# ranges of at least 64 seeds.
TILE_SEEDS = 8
MAX_SPLITS = 32
MIN_SPLIT_ROWS = 64


def tile_plan(S: int) -> dict:
    """The seed tiling of the kernels for S seeds, as the CUDA sources
    compute it: ``seed_tiles`` tiles of ``TILE_SEEDS`` seeds in the
    projections (the last one ragged; a block takes every grid-th tile);
    ``splits`` ranges of ``split_rows`` seeds (the last one ragged) in the
    backward's weight gradients, whose partials add up in range order. A
    function of S alone, so the order of every sum is fixed by S."""
    if S <= 0:
        return {"seed_tiles": 0, "splits": 0, "split_rows": MIN_SPLIT_ROWS}
    rows = max(-(-S // MAX_SPLITS), MIN_SPLIT_ROWS)
    return {"seed_tiles": -(-S // TILE_SEEDS), "splits": -(-S // rows),
            "split_rows": rows}


def workspace_bytes(S: int, H: int, D: int, d_time: int, d_edge: int, *,
                    backward: bool) -> int:
    """Bytes of the workspace a call allocates, as the sources'
    ``fused_temporal_layer{,_bwd}_workspace`` compute them. Forward: U and
    Z, (S, H, X) float32 each. Backward: U_k, U_v, A_k, A_v (S, H, X) each,
    the per-seed dtime partials (S, 2 d_time), the weight-gradient partials
    (splits, 2, X, H D) and the dtime partials (splits, 2 d_time)."""
    S = max(S, 0)
    X = d_time + d_edge
    if not backward:
        return 4 * 2 * S * H * X
    n = tile_plan(S)["splits"]
    return 4 * (4 * S * H * X + 2 * S * d_time + 2 * n * X * H * D
                + 2 * n * d_time)


def _check(t, name, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_operands(q, k_table, v_table, seeds, seed_times, buf, time_w,
                    time_b, wt_k, wt_v, edge_feats, we_k, we_v):
    """Validate the layer's operands (shared by the forward and the
    backward); returns ``(S, H, D, N, K, d_time, d_edge)``."""
    if q.device.type != "cuda":
        raise ValueError(
            f"the fused temporal layer kernels run on CUDA tensors; q is on "
            f"{q.device} (use mode='ref' or 'auto' for the plain version)")
    dev = q.device
    f32, i32 = torch.float32, torch.int32
    S, H, D = q.shape
    N = k_table.shape[0]
    Nb, K = buf.shape[0], buf.shape[1]
    _check(q, "q", f32, (S, H, D), dev)
    _check(k_table, "k_table", f32, (N, H, D), dev)
    _check(v_table, "v_table", f32, (N, H, D), dev)
    _check(seeds, "seeds", i32, (S,), dev)
    _check(buf, "buf", i32, (Nb, K, 3), dev)
    d_time = d_edge = 0
    if wt_k is not None:
        d_time = wt_k.shape[0]
        _check(seed_times, "seed_times", i32, (S,), dev)
        _check(time_w, "time_w", f32, (d_time,), dev)
        _check(time_b, "time_b", f32, (d_time,), dev)
        _check(wt_k, "wt_k", f32, (d_time, H * D), dev)
        _check(wt_v, "wt_v", f32, (d_time, H * D), dev)
    if we_k is not None:
        d_edge = we_k.shape[0]
        _check(edge_feats, "edge_feats", f32, (edge_feats.shape[0], d_edge), dev)
        _check(we_k, "we_k", f32, (d_edge, H * D), dev)
        _check(we_v, "we_v", f32, (d_edge, H * D), dev)
    return S, H, D, N, K, d_time, d_edge


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(q, k_table, v_table, seeds, seed_times, buf, time_w, time_b,
            wt_k, wt_v, edge_feats, we_k, we_v, scale):
    """Validate every operand and launch the CUDA kernel; returns (S, H, D)."""
    S, H, D, N, K, d_time, d_edge = _check_operands(
        q, k_table, v_table, seeds, seed_times, buf, time_w, time_b, wt_k,
        wt_v, edge_feats, we_k, we_v)
    dev = q.device
    out = torch.empty((S, H, D), dtype=torch.float32, device=dev)
    lib = _library()
    nbytes = lib.fused_temporal_layer_fwd_workspace(S, H, D, K, d_time, d_edge)
    work = torch.empty((nbytes // 4,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_temporal_layer_fwd(
            _ptr(q), _ptr(k_table), _ptr(v_table), _ptr(seeds),
            _ptr(seed_times) if d_time else None, _ptr(buf),
            _ptr(time_w), _ptr(time_b), _ptr(wt_k), _ptr(wt_v),
            _ptr(edge_feats) if d_edge else None, _ptr(we_k), _ptr(we_v),
            _ptr(out), _ptr(work) if nbytes else None, S, H, D, K, d_time,
            d_edge, float(scale if scale is not None else 1.0 / math.sqrt(D)),
            stream)
    if err:
        msg = lib.fused_temporal_layer_error_string(err).decode()
        raise RuntimeError(f"fused_temporal_layer launch failed: {msg} ({err})")
    return out


def fused_temporal_layer_kernel(
    q, k_table, v_table, seeds, seed_times, buf, *,
    time_w=None, time_b=None, wt_k=None, wt_v=None,
    edge_feats=None, we_k=None, we_v=None, scale: float | None = None,
):
    """Fused neighbor gather + bias fold + attention on the GPU.

    Arguments as in ``ref.fused_temporal_layer_ref``, all on one CUDA
    device: q/k_table/v_table float32 (S, H, D)/(N, H, D); seeds and
    seed_times int32 (S,); buf int32 (Nb, K, 3); the time group
    (d_time,)/(d_time, H*D) and the edge group (E, d_edge)/(d_edge, H*D)
    float32, each optional. Returns a new (S, H, D) float32 tensor.
    """
    out = _launch(q, k_table, v_table, seeds, seed_times, buf, time_w, time_b,
                  wt_k, wt_v, edge_feats, we_k, we_v, scale)
    LAUNCHES["fused_temporal_layer"] += 1
    return out


def fused_recency_attention_kernel(q, k_table, v_table, seeds, buf_ids, *,
                                   scale: float | None = None):
    """Ids-only fused gather + attention: the same CUDA kernel with the time
    and edge groups off. buf_ids: (Nb, K) int32 neighbor ids (-1 = empty)."""
    if buf_ids.dtype != torch.int32 or buf_ids.dim() != 2:
        raise TypeError("buf_ids must be an int32 (Nb, K) tensor")
    buf = torch.stack([buf_ids, torch.zeros_like(buf_ids),
                       torch.full_like(buf_ids, -1)], dim=-1)
    out = _launch(q, k_table, v_table, seeds, None, buf, None, None, None,
                  None, None, None, None, scale)
    LAUNCHES["fused_recency_attention"] += 1
    return out


def fused_temporal_layer_bwd_kernel(
    g, q, k_table, v_table, seeds, seed_times, buf, *,
    time_w=None, time_b=None, wt_k=None, wt_v=None,
    edge_feats=None, we_k=None, we_v=None, scale: float | None = None,
):
    """Backward of ``fused_temporal_layer_kernel`` on the GPU.

    g: (S, H, D) float32 cotangent of the forward's output; the other
    arguments as in the forward, on the same CUDA device. Returns the
    reference's dict of float32 gradients: ``q`` (S, H, D),
    ``k_table``/``v_table`` (N, H, D) and, when the groups are present,
    ``time_w``/``time_b`` (1, d_time), ``wt_k``/``wt_v`` (d_time, H*D),
    ``we_k``/``we_v`` (d_edge, H*D). ``seeds``, ``seed_times``, ``buf`` and
    ``edge_feats`` are not differentiable. The table gradients are summed
    with float atomics, so their last bits vary from run to run; the other
    gradients are deterministic (fixed-order sums). The kernel's transient
    workspace (``workspace_bytes``) is a ``torch.empty`` freed on return.
    """
    S, H, D, N, K, d_time, d_edge = _check_operands(
        q, k_table, v_table, seeds, seed_times, buf, time_w, time_b, wt_k,
        wt_v, edge_feats, we_k, we_v)
    dev = q.device
    f32 = torch.float32
    _check(g, "g", f32, (S, H, D), dev)
    HD = H * D
    lib = _bwd_library()
    dq = torch.empty((S, H, D), dtype=f32, device=dev)
    dk = torch.empty((N, H, D), dtype=f32, device=dev)
    dv = torch.empty((N, H, D), dtype=f32, device=dev)
    dtime = torch.empty((2, d_time), dtype=f32, device=dev)
    dwt = torch.empty((2, d_time, HD), dtype=f32, device=dev)
    dwe = torch.empty((2, d_edge, HD), dtype=f32, device=dev)
    nbytes = lib.fused_temporal_layer_bwd_workspace(S, H, D, K, d_time, d_edge)
    work = torch.empty((max(nbytes // 4, 1),), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_temporal_layer_bwd(
            _ptr(g), _ptr(q), _ptr(k_table), _ptr(v_table), _ptr(seeds),
            _ptr(seed_times) if d_time else None, _ptr(buf),
            _ptr(time_w), _ptr(time_b), _ptr(wt_k), _ptr(wt_v),
            _ptr(edge_feats) if d_edge else None, _ptr(we_k), _ptr(we_v),
            _ptr(dq), _ptr(dk), _ptr(dv), _ptr(dtime), _ptr(dwt), _ptr(dwe),
            _ptr(work), S, N, H, D, K, d_time, d_edge,
            float(scale if scale is not None else 1.0 / math.sqrt(D)), stream)
    if err:
        msg = lib.fused_temporal_layer_bwd_error_string(err).decode()
        raise RuntimeError(
            f"fused_temporal_layer_bwd launch failed: {msg} ({err})")
    LAUNCHES["fused_temporal_layer_bwd"] += 1
    grads = {"q": dq, "k_table": dk, "v_table": dv}
    if d_time:
        grads.update(time_w=dtime[0:1], time_b=dtime[1:2], wt_k=dwt[0],
                     wt_v=dwt[1])
    if d_edge:
        grads.update(we_k=dwe[0], we_v=dwe[1])
    return grads


# Storage types K3 and K3b take, by the code their C interfaces expect, and
# their element sizes.
_TA_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TA_ESIZE = {torch.float32: 4, torch.bfloat16: 2}

# K3's and K3b's launch plan (csrc/temporal_attention.cuh): slots staged in
# chunks of at most TA_MAX_CHUNK; K3 one seed (warp) a block, K3b up to
# TA_MAX_WARPS within the default shared memory of a block, one warp with
# the opt-in above it.
TA_MAX_WARPS = 8
TA_MAX_CHUNK = 16
TA_DEFAULT_SHARED = 48 * 1024
TA_MAX_SHARED = 232_448


def _a16(n: int) -> int:
    return -(-n // 16) * 16


def _ta_warp_bytes(chunk: int, H: int, D: int, esize: int, backward: bool) -> int:
    """One warp's shared bytes (``FwdLayout`` / ``BwdLayout``): the staged k
    and v rows of a chunk, q (and g), the chunk's per-pair floats (scores;
    and dp), four floats of softmax state per head, HD float32 sums."""
    HD = H * D
    rows, row = _a16(chunk * HD * esize), _a16(HD * esize)
    pairs, tail = _a16(chunk * H * 4), _a16(16 * H) + _a16(4 * HD)
    if backward:
        return 2 * rows + 2 * row + 2 * pairs + tail
    return 2 * rows + row + pairs + tail


def ta_plan(S: int, K: int, H: int, D: int, dtype: torch.dtype,
            aligned: bool, *, backward: bool = False) -> dict:
    """K3's (or, with ``backward``, K3b's) launch plan for these sizes, as
    ``csrc/temporal_attention.cuh::plan`` computes it: ``chunk`` slots a
    stage (min(K, 16), halved while one warp's shared memory would pass the
    opt-in limit), ``warps`` seeds a block (K3: 1; K3b: the most, up to 8,
    within 48 KB, else 1), ``warp_bytes`` / ``block_bytes`` of shared
    memory, ``blocks``, ``chunks`` per seed, and ``vector_bytes``: 16
    (cp.async) when a slot row of H * D elements is a multiple of 16 bytes
    and the operands are 16-byte ``aligned``, else the element size (the
    scalar path). Raises when no chunk fits one warp."""
    esize = _TA_ESIZE[dtype]
    chunk = min(K, TA_MAX_CHUNK)
    while chunk > 1 and _ta_warp_bytes(chunk, H, D, esize, backward) > TA_MAX_SHARED:
        chunk //= 2
    per = _ta_warp_bytes(chunk, H, D, esize, backward)
    if per > TA_MAX_SHARED:
        raise ValueError(f"H * D = {H * D} is too wide for one warp's shared memory")
    warps = TA_MAX_WARPS if backward else 1
    while warps > 1 and warps * per > TA_DEFAULT_SHARED:
        warps -= 1
    vec = aligned and (H * D * esize) % 16 == 0
    return {"warps": warps, "chunk": chunk, "chunks": -(-K // chunk),
            "vector_bytes": 16 if vec else esize, "warp_bytes": per,
            "block_bytes": warps * per, "blocks": -(-max(S, 0) // warps)}


def _ta_check(q, k, v, mask):
    """Validate K3's operands; returns (S, K, H, D)."""
    if not isinstance(q, torch.Tensor) or q.device.type != "cuda":
        raise ValueError(
            "the temporal attention kernels run on CUDA tensors (use "
            "mode='ref' or 'auto' for the plain version)")
    if q.dtype not in _TA_DTYPES or q.dim() != 3:
        raise TypeError(f"q must be a float32 or bfloat16 (S, H, D) tensor, "
                        f"got {q.dtype} {tuple(q.shape)}")
    S, H, D = q.shape
    if k.dim() != 4:
        raise ValueError(f"k must be (S, K, H, D), got {tuple(k.shape)}")
    K = k.shape[1]
    dev = q.device
    _check(q, "q", q.dtype, (S, H, D), dev)
    _check(k, "k", q.dtype, (S, K, H, D), dev)
    _check(v, "v", q.dtype, (S, K, H, D), dev)
    _check(mask, "mask", torch.bool, (S, K), dev)
    if K < 1 or H < 1 or D < 1:
        raise ValueError(f"unsupported sizes K={K}, H={H}, D={D}")
    return S, K, H, D


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _ta_vec(H: int, D: int, *ts) -> int:
    """1 for the kernels' 16-byte path (``ta_plan``'s rule), else 0."""
    return int((H * D * _TA_ESIZE[ts[0].dtype]) % 16 == 0 and _aligned(*ts))


def temporal_attention_kernel(q, k, v, mask, *, scale: float | None = None):
    """Masked seed -> K-neighbor attention on the GPU (K3).

    q: (S, H, D); k, v: (S, K, H, D), all float32 or all bfloat16; mask:
    (S, K) bool; every tensor contiguous on one CUDA device. Returns a new
    (S, H, D) tensor of q's dtype: ``softmax((q . k) * scale)`` over the
    valid slots applied to v (scale 1/sqrt(D) unless given), exact zeros for
    a seed with no valid slot. Any S (0 launches nothing), K >= 1, H and D;
    the 16-byte path where ``ta_plan``'s rule allows it, else the scalar
    path. The CUDA source plans the launch itself (``ta_plan`` mirrors it)
    and refuses a row too wide for one warp's shared memory.
    """
    S, K, H, D = _ta_check(q, k, v, mask)
    out = torch.empty((S, H, D), dtype=q.dtype, device=q.device)
    if S == 0:
        return out
    lib = _ta_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.temporal_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), S, H, D, K, _TA_DTYPES[q.dtype], _ta_vec(H, D, q, k, v),
            float(scale if scale is not None else 1.0 / math.sqrt(D)), stream)
    if err:
        msg = lib.temporal_attention_error_string(err).decode()
        raise RuntimeError(f"temporal_attention launch failed: {msg} ({err})")
    LAUNCHES["temporal_attention"] += 1
    return out


def temporal_attention_bwd_kernel(g, q, k, v, mask, *,
                                  scale: float | None = None):
    """Gradient of ``temporal_attention_kernel`` on the GPU (K3b).

    g: (S, H, D) cotangent of K3's output, of q's dtype; q, k, v and mask as
    in the forward, contiguous on one CUDA device. Returns new ``(dq, dk,
    dv)`` of q's dtype and shapes: exact zeros in dk and dv for masked slots
    and in all three for a seed with no valid slot. One launch, no atomics:
    a second call gives the same bits.
    """
    S, K, H, D = _ta_check(q, k, v, mask)
    _check(g, "g", q.dtype, (S, H, D), q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if S == 0:
        return dq, dk, dv
    lib = _ta_bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.temporal_attention_bwd(
            g.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            S, H, D, K, _TA_DTYPES[q.dtype], _ta_vec(H, D, g, q, k, v),
            float(scale if scale is not None else 1.0 / math.sqrt(D)), stream)
    if err:
        msg = lib.temporal_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"temporal_attention_bwd launch failed: {msg} ({err})")
    LAUNCHES["temporal_attention_bwd"] += 1
    return dq, dk, dv
