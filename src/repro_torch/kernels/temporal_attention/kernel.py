"""ctypes bindings and wrappers of the fused temporal layer CUDA kernels.

``csrc/fused_temporal_layer.cu`` replaces the TPU kernel
``repro.kernels.temporal_attention.kernel.fused_temporal_layer_kernel``:
one block per seed gathers the seed's packed buffer row, folds the Bochner
time bias and the edge-feature bias into the K neighbor keys/values in
shared memory, and runs the masked softmax attention. It is bounded by the
float32 bias products on the CUDA cores; the source's head comment says
what the design does about that.

``fused_temporal_layer_kernel`` is its wrapper; ``fused_recency_attention_kernel``
(the ids-only TPU surface, ``kernel.py:746`` of the reference) runs the same
CUDA kernel with both bias groups off. Each wrapper checks device, dtype,
shape and contiguity, allocates its output with ``torch.empty``, launches
on the current stream, raises on a CUDA error, and adds one to its entry in
``LAUNCHES`` per launch.

``csrc/fused_temporal_layer_bwd.cu`` replaces the TPU backward kernel
``fused_temporal_layer_bwd_kernel``: it recomputes the attention per seed
and returns every gradient of the layer (``fused_temporal_layer_bwd_kernel``
here). The wrappers take no part in autograd themselves:
``ops._FusedLayerFn`` pairs the two into one differentiable call.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_temporal_layer.cu"
BWD_SOURCE = SOURCE.with_name("fused_temporal_layer_bwd.cu")

LAUNCHES = {"fused_temporal_layer": 0, "fused_recency_attention": 0,
            "fused_temporal_layer_bwd": 0}

_lib = None
_bwd_lib = None


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
        lib.fused_temporal_layer_fwd.argtypes = [p] * 14 + [i] * 6 + [
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_temporal_layer_fwd(
            _ptr(q), _ptr(k_table), _ptr(v_table), _ptr(seeds),
            _ptr(seed_times) if d_time else None, _ptr(buf),
            _ptr(time_w), _ptr(time_b), _ptr(wt_k), _ptr(wt_v),
            _ptr(edge_feats) if d_edge else None, _ptr(we_k), _ptr(we_v),
            _ptr(out), S, H, D, K, d_time, d_edge,
            float(scale if scale is not None else 1.0 / math.sqrt(D)), stream)
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
    gradients are deterministic. The kernel's transient workspace is a
    ``torch.empty`` freed on return.
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
