#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--profile]

Needs one CUDA GPU (Hopper: the kernels are built for sm_90a) and the CUDA
toolkit's ``nvcc``; exits non-zero, printing no result, without them or
outside a checkout of the repository. Phases, each printed as a JSON line:

1. ``env``     — torch and CUDA versions, the card.
2. ``build``   — nvcc builds every kernel source of the port (seconds, and
   ptxas' register/shared-memory report).
3. ``kernels`` — every kernel against its plain PyTorch version on the card,
   at the main path's shapes (eval S=4,400 and train S=600 seeds over
   N=9,000 nodes, K=10, H=2, D=50, d_time=100, d_edge=172, E=157,474) and
   on degenerate inputs, with times (CUDA events, median of repeats).
4. ``slice``   — the main path: ``tg.Experiment`` on full-scale synthetic
   ``wikipedia`` with 1-layer TGAT over the device recency sampler,
   ``compile(device="cuda").evaluate("val")`` through the kernel (launch
   count = val batches), then the same pipeline with ``fused="ref"``: MRR
   within 1e-4 and a bit-equal sampler state.

``--profile`` adds a ``profile`` phase (host-clock time per batch of the
warm pass, and per scored val batch of the hooks, the model step and the
metric, each closed by a device synchronise) and a ``trace`` phase
(``torch.profiler`` over scored val batches: device busy time, idle share,
device time by kernel name). Then the ``{"kernels": [...]}`` summary, the
card's name and power limit as nvidia-smi reports them, and the last line
``{"ok": true, "device": {"platform": "gpu", ...}}``. Any failed check exits
non-zero before the last line.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Kernel vs plain version on the card: float32, summation order differs
# (per-thread FMA chains vs cuBLAS/ATen reductions), |err| <= ATOL + RTOL|ref|.
ATOL = RTOL = 1e-4
MRR_TOL = 1e-4

# Published peaks of one H100 SXM (NVIDIA data sheet): float32 on the CUDA
# cores and HBM3 bandwidth; they assume the 700 W power limit.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

N_NODES, K, H, D = 9000, 10, 2, 50
D_TIME, D_EDGE, N_EDGES = 100, 172, 157_474
EVAL_S, TRAIN_S = 200 * (2 + 20), 200 * (2 + 1)

KERNEL_SOURCE = "src/repro_torch/kernels/temporal_attention/csrc/fused_temporal_layer.cu"
TPU_K1 = "src/repro/kernels/temporal_attention/kernel.py:383"
TPU_K1W = "src/repro/kernels/temporal_attention/kernel.py:746"
DEVICE = "cuda"


class SmokeError(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Kernel inputs
# ---------------------------------------------------------------------------
def layer_inputs(torch, gen, S, *, n=N_NODES, k=K, h=H, d=D, d_time=D_TIME,
                 d_edge=D_EDGE, e=N_EDGES, neg_seeds=0, empty_rows=0,
                 dup_row=False, all_masked=False):
    """Random fused-layer operands on the card, shaped like the main path:
    buffer rows hold past neighbors (times before the seed's), some slots
    empty (-1) or featureless (eid -1), times on the wikipedia scale."""
    dev = DEVICE

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    w = math.sqrt(2.0 / (d_time + d_edge + 2 * h * d))
    seeds = torch.randint(0, n, (S,), generator=gen, dtype=torch.int32)
    if neg_seeds:
        seeds[torch.randperm(S, generator=gen)[:neg_seeds]] = -1
    seed_t = torch.randint(2_000_000, 2_592_000, (S,), generator=gen,
                           dtype=torch.int32)
    ids = torch.randint(0, n, (n + 1, k), generator=gen, dtype=torch.int32)
    # Most rows full after the warm pass, the rest partly filled.
    cnt = torch.where(torch.rand((n + 1, 1), generator=gen) < 0.8, k,
                      torch.randint(0, k + 1, (n + 1, 1), generator=gen))
    ids = torch.where(torch.arange(k)[None] < cnt, ids, -1)
    times = torch.randint(0, 2_000_000, (n + 1, k), generator=gen,
                          dtype=torch.int32)
    eids = torch.randint(-1, e, (n + 1, k), generator=gen, dtype=torch.int32)
    buf = torch.stack([ids, torch.where(ids >= 0, times, 0),
                       torch.where(ids >= 0, eids, -1)], dim=-1)
    buf[n] = torch.tensor([-1, 0, -1], dtype=torch.int32)  # sink row
    if empty_rows:
        buf[seeds[:empty_rows].clamp(min=0).long()] = torch.tensor(
            [-1, 0, -1], dtype=torch.int32)
    if dup_row:
        r = int(seeds[0].clamp(min=0))
        buf[r, :, 0] = int(ids[r, 0].clamp(min=0))
    if all_masked:
        buf[..., 0] = -1
    ops = dict(
        q=randn(S, h, d, scale=0.25), k_table=randn(n, h, d, scale=0.25),
        v_table=randn(n, h, d, scale=0.25), seeds=seeds.to(dev),
        seed_times=seed_t.to(dev), buf=buf.to(dev))
    kw = {}
    if d_time:
        kw.update(time_w=randn(d_time, scale=0.1),
                  time_b=randn(d_time, scale=0.1),
                  wt_k=randn(d_time, h * d, scale=w),
                  wt_v=randn(d_time, h * d, scale=w))
    if d_edge:
        kw.update(edge_feats=randn(e, d_edge), we_k=randn(d_edge, h * d, scale=w),
                  we_v=randn(d_edge, h * d, scale=w))
    return ops, kw


def layer_bound(torch, ops, kw):
    """Least time (ms) for one fused-layer call on these inputs: each input
    byte this run needs read once (only the buffer rows, table rows and edge
    rows its seeds reach), the output written once; the operations its
    valid slots need (time and edge bias products for k and v, scores and
    weighted sum). Returns (bound_ms, bound_by, bytes, flops)."""
    q, seeds, buf = ops["q"], ops["seeds"], ops["buf"]
    S, h, d = q.shape
    hd = h * d
    live = seeds >= 0
    rows = buf[seeds[live].long()]                       # (S', K, 3)
    valid = rows[..., 0] >= 0
    n_valid = int(valid.sum())
    d_time = kw["wt_k"].shape[0] if "wt_k" in kw else 0
    d_edge = kw["we_k"].shape[0] if "we_k" in kw else 0
    edge_slots = valid & (rows[..., 2] >= 0)
    n_edge = int(edge_slots.sum()) if d_edge else 0
    flops = (n_valid * 4 * d_time * hd + n_edge * 4 * d_edge * hd
             + n_valid * 4 * hd)
    n_rows = int(torch.unique(seeds[live]).numel())
    n_ids = int(torch.unique(rows[..., 0][valid]).numel())
    n_eids = int(torch.unique(rows[..., 2][edge_slots]).numel()) if d_edge else 0
    nbytes = (4 * S * hd * 2                   # q in, out
              + 4 * S * (2 if d_time else 1)   # seeds, seed times
              + 4 * n_rows * buf.shape[1] * 3  # buffer rows
              + 4 * n_ids * hd * 2             # k/v table rows
              + 4 * n_eids * d_edge            # edge-feature rows
              + 4 * (2 * d_time + 2 * (d_time + d_edge) * hd))  # weights
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def time_ms(torch, fn, reps: int, trials: int = 5) -> float:
    """Median over ``trials`` of the mean time of ``reps`` calls, from CUDA
    events (after a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop) / reps)
    return statistics.median(out)


def compare(torch, got, want, what: str) -> float:
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite kernel output")
    err = (got - want).abs()
    ok = bool((err <= ATOL + RTOL * want.abs()).all())
    check(ok, f"{what}: kernel disagrees with the plain version "
              f"(max abs err {float(err.max()):.3e})")
    return float(err.max())


def kernels_phase(torch):
    """Hold K1 and K1w against their plain versions; time them."""
    from repro_torch.kernels.temporal_attention import (
        fused_recency_attention_kernel,
        fused_recency_attention_ref,
        fused_temporal_layer_kernel,
        fused_temporal_layer_ref,
    )

    gen = torch.Generator().manual_seed(0)
    results, cases = {}, []
    with torch.no_grad():
        for name, S in (("eval", EVAL_S), ("train", TRAIN_S)):
            ops, kw = layer_inputs(torch, gen, S)
            got = fused_temporal_layer_kernel(**ops, **kw)
            err = compare(torch, got, fused_temporal_layer_ref(**ops, **kw),
                          f"K1 {name} S={S}")
            bound, by, nbytes, flops = layer_bound(torch, ops, kw)
            ms = time_ms(torch, lambda: fused_temporal_layer_kernel(**ops, **kw), 20)
            plain = time_ms(torch, lambda: fused_temporal_layer_ref(**ops, **kw), 5)
            results[f"K1_{name}"] = dict(S=S, max_abs_err=err, ms=ms,
                                         plain_ms=plain, bound_ms=bound,
                                         bound_by=by, bytes=nbytes,
                                         flops=flops)
            ids = ops["buf"][..., 0].contiguous()
            kops = {k: ops[k] for k in ("q", "k_table", "v_table", "seeds")}
            got = fused_recency_attention_kernel(**kops, buf_ids=ids)
            err = compare(torch, got,
                          fused_recency_attention_ref(**kops, buf_ids=ids),
                          f"K1w {name} S={S}")
            bound, by, nbytes, flops = layer_bound(
                torch, dict(ops, buf=torch.stack(
                    [ids, torch.zeros_like(ids), torch.full_like(ids, -1)], -1)), {})
            ms = time_ms(torch, lambda: fused_recency_attention_kernel(**kops, buf_ids=ids), 20)
            plain = time_ms(torch, lambda: fused_recency_attention_ref(**kops, buf_ids=ids), 5)
            results[f"K1w_{name}"] = dict(S=S, max_abs_err=err, ms=ms,
                                          plain_ms=plain, bound_ms=bound,
                                          bound_by=by, bytes=nbytes,
                                          flops=flops)

        # Degenerate inputs at the real widths (small N and E keep it quick).
        small = dict(n=300, e=500)
        for case, S, extra in (
                ("neg_seeds", 77, dict(neg_seeds=20)),
                ("empty_rows", 64, dict(empty_rows=10)),
                ("all_masked", 33, dict(all_masked=True)),
                ("dup_ids", 50, dict(dup_row=True)),
                ("k1", 129, dict(k=1)),
                ("s_not_128", 131, {}),
                ("time_only", 64, dict(d_edge=0)),
                ("edge_only", 64, dict(d_time=0)),
                ("no_groups", 64, dict(d_time=0, d_edge=0)),
        ):
            ops, kw = layer_inputs(torch, gen, S, **small, **extra)
            got = fused_temporal_layer_kernel(**ops, **kw)
            err = compare(torch, got, fused_temporal_layer_ref(**ops, **kw),
                          f"K1 {case}")
            if case in ("neg_seeds", "all_masked"):
                zero = ops["seeds"] < 0 if case == "neg_seeds" else slice(None)
                check(bool((got[zero] == 0).all()), f"K1 {case}: rows not exactly zero")
            cases.append({"case": case, "S": S, "max_abs_err": err})
    return results, cases


def slice_phase(torch):
    """The main path through the user's entry point, then its plain twin."""
    from repro_torch.kernels.temporal_attention import LAUNCHES, reset_launches
    from repro_torch.tg import DataSpec, Experiment, ModelSpec, SamplerSpec, TrainSpec

    exp = Experiment(
        data=DataSpec("wikipedia", scale=1.0),
        model=ModelSpec("tgat", {"num_layers": 1}),
        sampler=SamplerSpec(kind="recency", k=10, device=True),
        train=TrainSpec(batch_size=200, eval_negatives=20),
    )
    t0 = time.perf_counter()
    pipe = exp.compile(device=DEVICE)
    setup_s = time.perf_counter() - t0
    n_val = math.ceil(pipe.val_data.num_edge_events / pipe.batch_size)

    reset_launches()
    t0 = time.perf_counter()
    mrr, eval_s = pipe.evaluate("val")
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    check(math.isfinite(mrr) and 0.0 < mrr <= 1.0, f"val MRR {mrr} out of range")
    check(launches["fused_temporal_layer"] == n_val,
          f"kernel launched {launches['fused_temporal_layer']} times for "
          f"{n_val} val batches")
    hook = next(h for h in pipe.manager.hooks() if hasattr(h, "sampler"))
    state = hook.state_dict()

    pipe.fused = "ref"
    reset_launches()
    mrr_ref, eval_ref_s = pipe.evaluate("val")
    check(LAUNCHES["fused_temporal_layer"] == 0, "fused='ref' launched the kernel")
    state_ref = hook.state_dict()
    check(abs(mrr - mrr_ref) <= MRR_TOL,
          f"val MRR {mrr} (kernel) vs {mrr_ref} (plain) differ by more than {MRR_TOL}")
    for k_ in state:
        check(bool((state[k_] == state_ref[k_]).all()),
              f"sampler state {k_!r} differs between the two runs")
    return dict(mrr=mrr, mrr_ref=mrr_ref, eval_seconds=eval_s,
                eval_ref_seconds=eval_ref_s, evaluate_total_seconds=total_s,
                setup_seconds=setup_s, val_batches=n_val,
                val_events=pipe.val_data.num_edge_events,
                train_events=pipe.train_data.num_edge_events,
                launches=launches)


def profile_phase(torch):
    """``--profile``: where the main path's time goes, by host clock with a
    device synchronise after each part (so each part's device work is
    inside its own interval): the warm pass per batch, and per scored val
    batch the hooks (sampling, negatives, staging), the model step and the
    metric."""
    from repro_torch.core import EVAL_KEY, TRAIN_KEY
    from repro_torch.tg import DataSpec, Experiment, ModelSpec, SamplerSpec, TrainSpec
    from repro_torch.train.metrics import mrr

    pipe = Experiment(
        data=DataSpec("wikipedia", scale=1.0),
        model=ModelSpec("tgat", {"num_layers": 1}),
        sampler=SamplerSpec(kind="recency", k=10, device=True),
        train=TrainSpec(batch_size=200, eval_negatives=20),
    ).compile(device=DEVICE)
    sync = torch.cuda.synchronize
    pipe.reset_epoch_state()
    sync()
    t0 = time.perf_counter()
    n_warm = 0
    with pipe.manager.activate(TRAIN_KEY):
        for _ in pipe._loader(pipe.train_data):
            n_warm += 1
    sync()
    warm_s = time.perf_counter() - t0
    parts = {"hooks": [], "model": [], "metric": []}
    with pipe.manager.activate(EVAL_KEY):
        it = pipe._loader(pipe.val_data)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            sync()
            t1 = time.perf_counter()
            if batch is None:
                break
            pos, neg = pipe._eval_step(batch)
            sync()
            t2 = time.perf_counter()
            mrr(pos, neg, batch["batch_mask"])
            t3 = time.perf_counter()
            parts["hooks"].append(t1 - t0)
            parts["model"].append(t2 - t1)
            parts["metric"].append(t3 - t2)
    n = len(parts["model"])
    return pipe, {"warm_batches": n_warm, "warm_seconds": warm_s,
                  "warm_ms_per_batch": 1e3 * warm_s / max(n_warm, 1),
                  "scored_batches": n,
                  "scored_ms_per_batch": {k: 1e3 * sum(v) / max(n, 1)
                                          for k, v in parts.items()},
                  "scored_ms_per_batch_median": {
                      k: 1e3 * statistics.median(v) for k, v in parts.items()}}


def trace_phase(torch, pipe, n_batches: int = 30):
    """``--profile``: ``torch.profiler`` over the first ``n_batches`` scored
    val batches (after a fresh warm pass), run as ``evaluate`` runs them with
    no synchronise inside the window. Device busy time is the union of the
    device events' intervals; the idle share is one minus busy over the
    window's host-clock time (closed by a synchronise). Also the device time
    by kernel name, largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import EVAL_KEY, TRAIN_KEY
    from repro_torch.train.metrics import mrr

    pipe.reset_epoch_state()
    with pipe.manager.activate(TRAIN_KEY):
        for _ in pipe._loader(pipe.train_data):
            pass
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof, pipe.manager.activate(EVAL_KEY):
        t0 = time.perf_counter()
        for _, batch in zip(range(n_batches), pipe._loader(pipe.val_data)):
            pos, neg = pipe._eval_step(batch)
            mrr(pos, neg, batch["batch_mask"])
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"batches": n_batches, "device_events": len(dev),
            "window_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "device_ms_by_name": {k: v / 1e3 for k, v in top}}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        smi = nvidia_smi_line()
        emit({"phase": "env", "python": sys.version.split()[0],
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0),
              "device_count": torch.cuda.device_count(), "nvidia_smi": smi})

        from repro_torch.kernels import _build

        t0 = time.perf_counter()
        logs = _build.build_all()
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "ptxas": {name: [ln.strip() for ln in log.splitlines()
                               if "registers" in ln or "spill" in ln]
                        for name, log in logs.items()}})

        results, cases = kernels_phase(torch)
        emit({"phase": "kernels", "tolerance": {"atol": ATOL, "rtol": RTOL},
              "peaks": {"f32_flops": PEAK_F32_FLOPS, "bytes_per_s": PEAK_BYTES},
              "shapes": results, "degenerate": cases})

        sl = slice_phase(torch)
        emit({"phase": "slice", **sl})

        if "--profile" in sys.argv[1:]:
            pipe, prof = profile_phase(torch)
            emit({"phase": "profile", **prof})
            emit({"phase": "trace", **trace_phase(torch, pipe)})
    except Exception as exc:  # any failed phase: no result line
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        return 1

    k1, k1w = results["K1_eval"], results["K1w_eval"]
    emit({"kernels": [{
        "name": "fused_temporal_layer", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_K1,
        "launches": sl["launches"]["fused_temporal_layer"],
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None,
    }], "wrappers_off_main_path": [{
        "name": "fused_recency_attention", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_K1W,
        "launches": sl["launches"]["fused_recency_attention"],
        "max_abs_err": k1w["max_abs_err"], "ms": k1w["ms"],
        "plain_ms": k1w["plain_ms"], "bound_ms": k1w["bound_ms"],
        "bound_by": k1w["bound_by"], "library_ms": None,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
