"""ctypes binding and wrappers of the fused temporal layer CUDA kernel.

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
``LAUNCHES`` per launch. There is no autograd yet: a wrapper raises when a
gradient is asked of it.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_temporal_layer.cu"

LAUNCHES = {"fused_temporal_layer": 0, "fused_recency_attention": 0}

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
        lib.fused_temporal_layer_fwd.argtypes = [p] * 14 + [i] * 6 + [
            ctypes.c_float, p]
        lib.fused_temporal_layer_fwd.restype = i
        lib.fused_temporal_layer_error_string.argtypes = [i]
        lib.fused_temporal_layer_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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


def _launch(q, k_table, v_table, seeds, seed_times, buf, time_w, time_b,
            wt_k, wt_v, edge_feats, we_k, we_v, scale):
    """Validate every operand and launch the CUDA kernel; returns (S, H, D)."""
    if q.device.type != "cuda":
        raise ValueError(
            f"the fused temporal layer kernel runs on CUDA tensors; q is on "
            f"{q.device} (use mode='ref' or 'auto' for the plain version)")
    operands = [q, k_table, v_table, time_w, time_b, wt_k, wt_v, edge_feats,
                we_k, we_v]
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in operands):
        raise RuntimeError(
            "the fused temporal layer kernel has no backward yet; call it "
            "under torch.no_grad() (the backward kernel comes with training)")
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
    out = torch.empty((S, H, D), dtype=f32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_temporal_layer_fwd(
            ptr(q), ptr(k_table), ptr(v_table), ptr(seeds),
            ptr(seed_times) if d_time else None, ptr(buf),
            ptr(time_w), ptr(time_b), ptr(wt_k), ptr(wt_v),
            ptr(edge_feats) if d_edge else None, ptr(we_k), ptr(we_v),
            ptr(out), S, H, D, K, d_time, d_edge,
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
