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
   on degenerate inputs, with times (CUDA events, median of repeats): K1 and
   K1w forward; K2, the backward, gradient by gradient, and a second K2 run
   against the first (its table gradients add with float atomics).
4. ``slice``   — inference: ``tg.Experiment`` on full-scale synthetic
   ``wikipedia`` with 1-layer TGAT over the device recency sampler,
   ``compile(device="cuda").evaluate("val")`` through the kernel (launch
   count = val batches), then the same pipeline with ``fused="ref"``: MRR
   within 1e-4 and a bit-equal sampler state.
5. ``train``   — training: the first train steps from the same parameters,
   kernels against the plain version (the loss, and K1 and K2 on each
   step's own layer inputs and cotangent; whole-model gradients reported);
   then
   ``train_epoch()`` through K1 and K2 (each launched once per train batch,
   552 at full scale) and val MRR after it; a checkpoint save and restore
   on the card (bit-equal parameters, optimizer and sampler state); the same
   epoch with ``fused="ref"`` from the same initial state (mean loss and val
   MRR within the stated tolerances, bit-equal sampler state), and a plain
   control run from parameters scaled by 1 + 1e-7 that shows the spread of
   free-running epochs. Epoch seconds and ms per step of each. Last, the
   ported ``PrefetchLoader`` (off the main path) against the calling
   thread's batches, bit for bit, with a train step on each batch.

``--profile`` adds ``profile`` (host-clock time per batch of the warm pass,
and per scored val batch of the hooks, the model step and the metric, each
closed by a device synchronise), ``trace`` (``torch.profiler`` over scored
val batches: device busy time, idle share, device time by kernel name),
``loader`` (ms per batch with the hooks in the calling thread and in
``PrefetchLoader``'s thread), ``spread`` (loss and val MRR of several
free-running kernel and perturbed plain epochs), ``train_profile`` (per
train step: the next batch, forward, backward with K2, AdamW, each closed
by a synchronise) and ``train_trace`` (the profiler over train steps as
``train_epoch`` runs them). Then the ``{"kernels":
[...]}`` summary, the card's name and power limit as nvidia-smi reports
them, and the last line ``{"ok": true, "device": {"platform": "gpu",
...}}``. Any failed check exits non-zero before the last line.
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
# K2's time_w gradient against the plain backward: max |err| / max |ref|
# (its entries sum dtheta * dt with dt up to ~2.6e6 s over every slot).
TIME_W_RTOL = 1e-4
MRR_TOL = 1e-4
# Train phase. A step from the same parameters, kernels against the plain
# version: loss within STEP_LOSS_TOL, the layer's K1 and K2 on that step's
# inputs within the kernel tolerances above (``step_parity``); whole-model
# gradients are reported against GRAD_RTOL of each leaf's largest entry plus
# GRAD_FLOOR (float32 noise of the gradients that are zero in exact
# arithmetic, such as the key bias). A whole epoch runs freely and training
# here is chaotic (theta = dt * w + b with dt up to ~2.6e6 s turns an ulp of
# w into ~0.1 rad; AdamW turns a gradient entry near zero into a full step
# of either sign), so the kernel and plain epochs are held to the spread
# that free-running epochs show on the card: EPOCH_LOSS_TOL in the mean
# loss, TRAIN_MRR_TOL in val MRR after the epoch. Measured on an H100 over
# kernel epochs (the table gradients' float atomics make each a separate
# trajectory) and plain epochs from parameters scaled by 1 + c * 1e-7
# (``--profile``'s ``spread`` phase, and the train phase of earlier runs),
# the largest distance from the plain epoch was 1.12e-3 in loss and 2.03e-3
# in MRR (NVIDIA H100 80GB HBM3, 700 W); the limits are ~2.5x that. The
# control run re-measures one such distance every run.
STEP_LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-7
PARITY_STEPS = 20
EPOCH_LOSS_TOL = 3e-3
TRAIN_MRR_TOL = 5e-3

# Published peaks of one H100 SXM (NVIDIA data sheet): float32 on the CUDA
# cores and HBM3 bandwidth; they assume the 700 W power limit.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

N_NODES, K, H, D = 9000, 10, 2, 50
D_TIME, D_EDGE, N_EDGES = 100, 172, 157_474
EVAL_S, TRAIN_S = 200 * (2 + 20), 200 * (2 + 1)

KERNEL_SOURCE = "src/repro_torch/kernels/temporal_attention/csrc/fused_temporal_layer.cu"
BWD_SOURCE = "src/repro_torch/kernels/temporal_attention/csrc/fused_temporal_layer_bwd.cu"
TPU_K1 = "src/repro/kernels/temporal_attention/kernel.py:383"
TPU_K1W = "src/repro/kernels/temporal_attention/kernel.py:746"
TPU_K2 = "src/repro/kernels/temporal_attention/kernel.py:626"
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
# Degenerate inputs for both kernels: (case, S, layer_inputs options).
DEGENERATE = (
    ("neg_seeds", 77, dict(neg_seeds=20)),
    ("empty_rows", 64, dict(empty_rows=10)),
    ("all_masked", 33, dict(all_masked=True)),
    ("dup_ids", 50, dict(dup_row=True)),
    ("k1", 129, dict(k=1)),
    ("s_not_128", 131, {}),
    ("time_only", 64, dict(d_edge=0)),
    ("edge_only", 64, dict(d_time=0)),
    ("no_groups", 64, dict(d_time=0, d_edge=0)),
)


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


def _reach(torch, ops, kw):
    """What one fused-layer call on these inputs reaches: the seeds with a
    valid slot (and with a featured one), the valid and featured slots, and
    the distinct buffer, table and edge rows."""
    q, seeds, buf = ops["q"], ops["seeds"], ops["buf"]
    S, h, d = q.shape
    live = seeds >= 0
    rows = buf[seeds[live].long()]                       # (S', K, 3)
    valid = rows[..., 0] >= 0
    d_time = kw["wt_k"].shape[0] if "wt_k" in kw else 0
    d_edge = kw["we_k"].shape[0] if "we_k" in kw else 0
    edge = valid & (rows[..., 2] >= 0) if d_edge else torch.zeros_like(valid)
    return dict(
        S=S, h=h, d=d, hd=h * d, d_time=d_time, d_edge=d_edge,
        k=buf.shape[1], n=ops["k_table"].shape[0],
        seeds_valid=int(valid.any(-1).sum()), seeds_edge=int(edge.any(-1).sum()),
        slots=int(valid.sum()), edge_slots=int(edge.sum()),
        rows=int(torch.unique(seeds[live]).numel()),
        ids=int(torch.unique(rows[..., 0][valid]).numel()),
        eids=int(torch.unique(rows[..., 2][edge]).numel()))


def _bound(nbytes, flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def layer_bound(torch, ops, kw):
    """Least time (ms) for one fused-layer call on these inputs: each input
    byte this run needs read once (only the buffer rows, table rows and edge
    rows its seeds reach), the output written once; the operations the
    function needs in its cheapest exact form. The bias groups factor per
    seed: q's score against phi @ wt_k is (wt_k q) . phi, and the output's
    sum_j p_j phi_j @ wt_v is wt_v^T (sum_j p_j phi_j), so each weight
    matrix is crossed once per seed (4 (d_time + d_edge) HD) and a slot
    costs O(H (D + d_time + d_edge)): its table-row score and weighted sum
    (4 HD), its phi (3 d_time) and phi's score and weighted sum (4 H
    d_time), a featured slot's edge row likewise (4 H d_edge), the softmax
    (5 H). Returns (bound_ms, bound_by, bytes, flops)."""
    r = _reach(torch, ops, kw)
    hd, h, dt, de = r["hd"], r["h"], r["d_time"], r["d_edge"]
    flops = (4 * hd * (r["seeds_valid"] * dt + r["seeds_edge"] * de)
             + r["slots"] * (4 * hd + 4 * h * dt + 3 * dt + 5 * h)
             + r["edge_slots"] * 4 * h * de)
    nbytes = (4 * r["S"] * hd * 2                # q in, out
              + 4 * r["S"] * (2 if dt else 1)    # seeds, seed times
              + 4 * r["rows"] * r["k"] * 3       # buffer rows
              + 4 * r["ids"] * hd * 2            # k/v table rows
              + 4 * r["eids"] * de               # edge-feature rows
              + 4 * (2 * dt + 2 * (dt + de) * hd))  # weights
    return _bound(nbytes, flops)


def layer_bwd_bound(torch, ops, kw):
    """Least time (ms) for one backward call on these inputs, by the rule of
    ``layer_bound``: the cotangent g, q, the buffer, table and edge rows its
    seeds reach and the weights read once; dq, both whole table gradients
    and the weight gradients written once. Operations in the factored form:
    per seed, q and g each projected through the k and v weights, dq's bias
    part projected back, and the four weight gradients as rank-1 updates
    (sum_j ds_j phi_j) x q and (sum_j p_j phi_j) x g, with their edge
    counterparts: 10 (d_time + d_edge) HD. Per slot: scores, dp, dq's and
    the two weighted sums, the dk/dv rows into the tables (10 HD); phi,
    dtheta and the time-weight sums (8 d_time); phi's dot products, weighted
    sums and dphi (12 H d_time); a featured slot's edge row (8 H d_edge);
    softmax and ds (10 H). Returns (bound_ms, bound_by, bytes, flops)."""
    r = _reach(torch, ops, kw)
    hd, h, dt, de = r["hd"], r["h"], r["d_time"], r["d_edge"]
    flops = (10 * hd * (r["seeds_valid"] * dt + r["seeds_edge"] * de)
             + r["slots"] * (10 * hd + 12 * h * dt + 8 * dt + 10 * h)
             + r["edge_slots"] * 8 * h * de)
    weights = 4 * (2 * dt + 2 * (dt + de) * hd)
    nbytes = (4 * r["S"] * hd * 3                # g, q in; dq out
              + 4 * r["S"] * (2 if dt else 1)    # seeds, seed times
              + 4 * r["rows"] * r["k"] * 3       # buffer rows
              + 4 * r["ids"] * hd * 2            # k/v table rows
              + 4 * r["eids"] * de               # edge-feature rows
              + 4 * r["n"] * hd * 2              # dk/dv tables out
              + 2 * weights)                     # weights in, their gradients out
    return _bound(nbytes, flops)


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


def compare_grads(torch, got, want, what: str):
    """Hold every gradient of K2 against the plain backward. ``time_w`` sums
    dtheta * dt over every slot with dt up to ~2.6e6 s, so its absolute
    error scales with its largest entry: it is held to TIME_W_RTOL of that
    (max |err| / max |ref|); the others elementwise to ATOL + RTOL |ref|.
    Returns {name: [max abs err, max abs err / max |ref|]}."""
    torch.cuda.synchronize()
    check(sorted(got) == sorted(want), f"{what}: gradient names {sorted(got)} "
                                       f"!= {sorted(want)}")
    out = {}
    for name in want:
        a, b = got[name], want[name]
        check(tuple(a.shape) == tuple(b.shape),
              f"{what}: {name} shape {tuple(a.shape)} != {tuple(b.shape)}")
        check(bool(torch.isfinite(a).all()), f"{what}: non-finite {name}")
        err = (a - b).abs()
        emax, ref_max = float(err.max()), float(b.abs().max())
        rel = emax / ref_max if ref_max > 0 else emax
        if name == "time_w":
            ok = rel <= TIME_W_RTOL
        else:
            ok = bool((err <= ATOL + RTOL * b.abs()).all())
        check(ok, f"{what}: gradient {name} disagrees with the plain version "
                  f"(max abs err {emax:.3e}, relative {rel:.3e})")
        out[name] = [emax, rel]
    return out


def k2_phase(torch, gen):
    """Hold K2 against the plain backward at the train and eval shapes and
    on degenerate inputs, check a second run against the first, and time
    it beside the plain backward. Returns (results, cases)."""
    from repro_torch.kernels.temporal_attention import (
        fused_temporal_layer_bwd_kernel,
        fused_temporal_layer_bwd_ref,
    )

    def cotangent(S):
        return torch.randn((S, H, D), generator=gen).to(DEVICE)

    results, cases = {}, []
    for name, S in (("train", TRAIN_S), ("eval", EVAL_S)):
        ops, kw = layer_inputs(torch, gen, S)
        g = cotangent(S)
        got = fused_temporal_layer_bwd_kernel(g, **ops, **kw)
        want = fused_temporal_layer_bwd_ref(g, **ops, **kw)
        errs = compare_grads(torch, got, want, f"K2 {name} S={S}")
        again = fused_temporal_layer_bwd_kernel(g, **ops, **kw)
        rerun = compare_grads(torch, again, got, f"K2 {name} S={S} rerun")
        bitwise = {k: bool(torch.equal(again[k], got[k])) for k in got}
        bound, by, nbytes, flops = layer_bwd_bound(torch, ops, kw)
        ms = time_ms(torch, lambda: fused_temporal_layer_bwd_kernel(g, **ops, **kw), 20)
        plain = time_ms(torch, lambda: fused_temporal_layer_bwd_ref(g, **ops, **kw), 5)
        results[f"K2_{name}"] = dict(
            S=S, max_abs_err=max(e[0] for e in errs.values()), errors=errs,
            rerun_max_abs_diff={k: v[0] for k, v in rerun.items()},
            rerun_bitwise_equal=bitwise, ms=ms, plain_ms=plain,
            bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
    small = dict(n=300, e=500)
    for case, S, extra in DEGENERATE:
        ops, kw = layer_inputs(torch, gen, S, **small, **extra)
        g = cotangent(S)
        got = fused_temporal_layer_bwd_kernel(g, **ops, **kw)
        errs = compare_grads(torch, got, fused_temporal_layer_bwd_ref(g, **ops, **kw),
                             f"K2 {case}")
        if case == "neg_seeds":
            check(bool((got["q"][ops["seeds"] < 0] == 0).all()),
                  "K2 neg_seeds: dq rows of seeds < 0 not exactly zero")
        if case == "all_masked":
            check(all(bool((v == 0).all()) for v in got.values()),
                  "K2 all_masked: gradients not exactly zero")
        cases.append({"case": case, "S": S,
                      "max_abs_err": max(e[0] for e in errs.values())})
    return results, cases


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
        for case, S, extra in DEGENERATE:
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

    t0 = time.perf_counter()
    pipe = quickstart().compile(device=DEVICE)
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


def quickstart(train_spec_kw=None):
    """The quickstart experiment at full scale: 1-layer TGAT over the device
    recency sampler (k=10) on synthetic ``wikipedia``, batch 200."""
    from repro_torch.tg import DataSpec, Experiment, ModelSpec, SamplerSpec, TrainSpec

    return Experiment(
        data=DataSpec("wikipedia", scale=1.0),
        model=ModelSpec("tgat", {"num_layers": 1}),
        sampler=SamplerSpec(kind="recency", k=10, device=True),
        train=TrainSpec(batch_size=200, eval_negatives=20,
                        **(train_spec_kw or {})),
    )


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def step_parity(torch, pipe, n_steps: int):
    """The first ``n_steps`` train steps through the kernels, each from the
    same parameters as a plain-version step. Held: the loss, and the fused
    layer as the model calls it in that step, K1 against the plain forward
    on the step's own inputs and K2 against the plain backward on the
    step's own cotangent (taken from the autograd graph). The whole-model
    gradients are compared too, but only reported: the merge and decoder
    MLPs' ReLUs and the cancelling time_w sum turn a rounding-level change
    of the layer's output into a whole unit's gradient in a few percent of
    steps (on the CPU, scaling the layer's output by 1 + 1e-6 noise moved
    4 of 150 steps beyond 1e-4), so no tolerance holds them every step.
    The kernels' update moves the run on. Returns the worst errors seen."""
    import repro_torch.kernels.temporal_attention as ta
    from repro_torch.core import TRAIN_KEY

    layer, seen = ta.fused_temporal_layer, {}

    def spy(q, k_table, v_table, seeds, seed_times, buf, *, mode, **kw):
        out = layer(q, k_table, v_table, seeds, seed_times, buf, mode=mode, **kw)
        if mode == "auto":
            seen["args"] = dict(
                q=q.detach().contiguous(), k_table=k_table.detach().contiguous(),
                v_table=v_table.detach().contiguous(),
                seeds=seeds.to(torch.int32).contiguous(),
                seed_times=seed_times.to(torch.int32).contiguous(),
                buf=buf.to(torch.int32).contiguous(),
                **{k: None if v is None else v.detach().contiguous()
                   for k, v in kw.items()})
            out.register_hook(lambda g: seen.__setitem__("g", g.detach().contiguous()))
        return out

    worst = {"loss": 0.0, "k1_max_abs_err": 0.0, "k2_max_rel_err": 0.0,
             "model_grad_rel": 0.0, "model_grad_name": None,
             "steps_with_model_grads_beyond_1e-4": 0}
    ta.fused_temporal_layer = spy
    try:
        pipe.reset_epoch_state()
        with pipe.manager.activate(TRAIN_KEY):
            for i, batch in zip(range(n_steps), pipe._loader(pipe.train_data)):
                pipe.fused = "ref"
                loss_ref = pipe._loss(batch)
                grads_ref = _flat(pipe._grads(loss_ref))
                pipe.fused = None
                loss = pipe._loss(batch)
                grads = pipe._grads(loss)
                dl = abs(loss.item() - loss_ref.item())
                check(dl <= STEP_LOSS_TOL, f"train step {i}: loss {loss.item()} "
                                           f"(kernels) vs {loss_ref.item()} (plain)")
                worst["loss"] = max(worst["loss"], dl)
                a, g = seen.pop("args"), seen.pop("g")
                err = compare(torch, ta.fused_temporal_layer_kernel(**a),
                              ta.fused_temporal_layer_ref(**a), f"K1 train step {i}")
                errs = compare_grads(torch, ta.fused_temporal_layer_bwd_kernel(g, **a),
                                     ta.fused_temporal_layer_bwd_ref(g, **a),
                                     f"K2 train step {i}")
                worst["k1_max_abs_err"] = max(worst["k1_max_abs_err"], err)
                worst["k2_max_rel_err"] = max(worst["k2_max_rel_err"],
                                              *(e[1] for e in errs.values()))
                beyond = False
                for name, gr in _flat(grads).items():
                    want = grads_ref[name]
                    e = float((gr - want).abs().max())
                    scale = float(want.abs().max())
                    beyond |= e > GRAD_RTOL * scale + GRAD_FLOOR
                    rel = e / scale if scale else 0.0
                    if rel > worst["model_grad_rel"] and e > GRAD_FLOOR:
                        worst.update(model_grad_rel=rel, model_grad_name=name)
                worst["steps_with_model_grads_beyond_1e-4"] += int(beyond)
                pipe._update(grads)
    finally:
        ta.fused_temporal_layer = layer
    torch.cuda.synchronize()
    return worst


def run_epoch(torch, pipe, fused):
    """One ``train_epoch()`` with ``pipe.fused = fused``, launch counts zeroed
    just before it and read just after, then val MRR."""
    from repro_torch.kernels.temporal_attention import LAUNCHES, reset_launches

    n_train = math.ceil(pipe.train_data.num_edge_events / pipe.batch_size)
    pipe.fused = fused
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    loss, secs = pipe.train_epoch()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(LAUNCHES)
    mrr, _ = pipe.evaluate("val")
    return dict(loss=loss, epoch_seconds=wall, train_epoch_seconds=secs,
                ms_per_step=1e3 * wall / n_train, val_mrr=mrr,
                launches=launches)


def train_phase(torch):
    """Training through the user's entry point: ``compile`` then one
    ``train_epoch`` on full-scale wikipedia through the kernels (K1 and K2
    launched once per train batch), val MRR after it, a checkpoint round
    trip; then the same epoch from the same initial state with
    ``fused="ref"`` and a control run of the plain version from parameters
    scaled by 1 + 1e-7. Before the epochs, the first train steps are held
    step by step (``step_parity``)."""
    import shutil

    from repro_torch.tree import tree_leaves, tree_map

    def snapshot(tree):
        return tree_map(lambda t: t.detach().clone(), tree)

    def equal(a, b):
        return _flat(a).keys() == _flat(b).keys() and all(
            torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))

    t0 = time.perf_counter()
    pipe = quickstart({"epochs": 1}).compile(device=DEVICE)
    setup_s = time.perf_counter() - t0
    n_train = math.ceil(pipe.train_data.num_edge_events / pipe.batch_size)
    hook = next(h for h in pipe.manager.hooks() if hasattr(h, "sampler"))
    init = snapshot(pipe.params), snapshot(pipe.opt_state)

    parity = step_parity(torch, pipe, PARITY_STEPS)
    pipe.load_params(init[0])
    pipe.load_opt_state(init[1])

    def epoch(fused):
        return run_epoch(torch, pipe, fused)

    run = epoch(None)
    launches = run["launches"]
    check(launches["fused_temporal_layer"] == n_train
          and launches["fused_temporal_layer_bwd"] == n_train,
          f"train epoch launched K1 {launches['fused_temporal_layer']} and K2 "
          f"{launches['fused_temporal_layer_bwd']} times for {n_train} batches")
    check(math.isfinite(run["loss"]) and 0.0 < run["val_mrr"] <= 1.0,
          f"train epoch: loss {run['loss']}, val MRR {run['val_mrr']}")
    state = hook.state_dict()

    # Checkpoint round trip on the card: bit-equal state back.
    ck_dir = ROOT / "checkpoints" / "chip_smoke"
    shutil.rmtree(ck_dir, ignore_errors=True)
    try:
        saved = snapshot(pipe.params), snapshot(pipe.opt_state)
        pipe.save_checkpoint(str(ck_dir), 1)
        pipe.load_params(init[0])
        pipe.load_opt_state(init[1])
        check(pipe.restore_checkpoint(str(ck_dir)) == 1, "checkpoint step")
        check(equal(pipe.params, saved[0]) and equal(pipe.opt_state, saved[1]),
              "checkpoint round trip changed the parameters or optimizer state")
        check(pipe.params["nodes"]["emb"].device == pipe.device,
              "restored parameters are not on the pipeline's device")
        restored = hook.state_dict()
        check(all((restored[k] == state[k]).all() for k in state),
              "checkpoint round trip changed the sampler state")
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)

    pipe.load_params(init[0])
    pipe.load_opt_state(init[1])
    plain = epoch("ref")
    check(plain["launches"]["fused_temporal_layer"] == 0
          and plain["launches"]["fused_temporal_layer_bwd"] == 0,
          "fused='ref' launched a kernel")
    state_ref = hook.state_dict()
    for k_ in state:
        check(bool((state[k_] == state_ref[k_]).all()),
              f"sampler state {k_!r} differs between the two train epochs")
    pipe.load_params(tree_map(lambda t: t * (1 + 1e-7), init[0]))
    pipe.load_opt_state(init[1])
    control = epoch("ref")
    prefetch = prefetch_check(torch, pipe)
    dl, dm = abs(run["loss"] - plain["loss"]), abs(run["val_mrr"] - plain["val_mrr"])
    check(dl <= EPOCH_LOSS_TOL, f"epoch loss {run['loss']} (kernels) vs "
                                f"{plain['loss']} (plain): beyond {EPOCH_LOSS_TOL}")
    check(dm <= TRAIN_MRR_TOL, f"val MRR after the epoch {run['val_mrr']} "
                               f"(kernels) vs {plain['val_mrr']} (plain): "
                               f"beyond {TRAIN_MRR_TOL}")
    return dict(train_batches=n_train,
                train_events=pipe.train_data.num_edge_events,
                setup_seconds=setup_s, step_parity=dict(steps=PARITY_STEPS, **parity),
                kernels=run, plain=plain, control_scaled_1e7=control,
                prefetch_loader=prefetch,
                loss_diff=dl, mrr_diff=dm,
                control_loss_diff=abs(control["loss"] - plain["loss"]),
                control_mrr_diff=abs(control["val_mrr"] - plain["val_mrr"]))


def prefetch_loader(pipe, data):
    """The ported ``PrefetchLoader`` over ``data`` with the pipeline's hooks
    (producer thread, side stream, pinned slots), as the reference's
    pipeline builds it; the port's pipeline itself runs the hooks in the
    calling thread (``pipe._loader``)."""
    from repro_torch.core import DGDataLoader, DGraph, PrefetchLoader

    return PrefetchLoader(
        DGDataLoader(DGraph(data), pipe.manager, batch_size=pipe.batch_size),
        device=pipe.device, prefetch=pipe.sampler_spec.prefetch)


def prefetch_check(torch, pipe, n_steps: int = 60):
    """``PrefetchLoader`` on the card, off the main path: with a train step
    on each batch while the producer samples and stages the next ones on
    its side stream, its first ``n_steps`` batches are bit-equal to the
    calling thread's (each copied after its step ran, so a buffer reused
    or rewritten too early would show). Changes the parameters."""
    import numpy as np

    from repro_torch.core import TRAIN_KEY

    def batches(loader):
        pipe.reset_epoch_state()
        out = []
        with pipe.manager.activate(TRAIN_KEY):
            it = iter(loader(pipe.train_data))
            try:
                for _, b in zip(range(n_steps), it):
                    pipe._train_step(b)
                    out.append({k: b[k].clone() if isinstance(b[k], torch.Tensor)
                                else np.array(b[k], copy=True) for k in b.keys()})
            finally:
                it.close()
        torch.cuda.synchronize()
        return out

    pipe.fused = None
    inline = batches(pipe._loader)
    staged = batches(lambda data: prefetch_loader(pipe, data))
    check(len(staged) == len(inline) == n_steps, "prefetch check: batch count")
    sink_diffs = 0
    for i, (a, b) in enumerate(zip(staged, inline)):
        check(a.keys() == b.keys(), f"prefetch batch {i}: keys differ")
        for k in a:
            x, y = a[k], b[k]
            if k == "nbr_buf":
                # The sampler's sink row (last) takes the padding's duplicate
                # scatter writes, which CUDA lands in any order; nothing
                # reads it (the sampler's state_dict drops it too).
                sink_diffs += int((x[-1] != y[-1]).sum())
                x, y = x[:-1], y[:-1]
            if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
                same = x.device == y.device and torch.equal(x, y)
            else:
                same = type(x) is type(y) and np.array_equal(x, y)
            check(same, f"prefetch batch {i}: {k!r} differs from the "
                        f"calling thread's")
    return {"steps": n_steps, "bit_equal": True,
            "sink_row_entries_differing": sink_diffs}


def spread_phase(torch, rounds: int = 3):
    """``--profile``: the spread of free-running train epochs on the card,
    from which EPOCH_LOSS_TOL and TRAIN_MRR_TOL are set: ``rounds`` kernel
    epochs from the same initial state (the table gradients' float atomics
    make each its own trajectory) and ``rounds`` plain epochs from the
    initial parameters scaled by 1 + c * 1e-7, each against the plain epoch
    from the initial state."""
    from repro_torch.tree import tree_map

    pipe = quickstart({"epochs": 1}).compile(device=DEVICE)
    init = (tree_map(lambda t: t.detach().clone(), pipe.params),
            tree_map(lambda t: t.detach().clone(), pipe.opt_state))

    def epoch(fused, scale=1.0):
        pipe.load_params(tree_map(lambda t: t * scale, init[0]))
        pipe.load_opt_state(init[1])
        r = run_epoch(torch, pipe, fused)
        return r["loss"], r["val_mrr"]

    base = epoch("ref")
    runs = [("kernels", epoch(None)) for _ in range(rounds)]
    runs += [(f"plain x(1{c:+d}e-7)", epoch("ref", 1 + c * 1e-7))
             for c in (1, -1, 2, -2, 3)[:rounds]]
    return {"plain": {"loss": base[0], "val_mrr": base[1]},
            "runs": [{"run": name, "loss": l, "val_mrr": m,
                      "loss_diff": abs(l - base[0]), "mrr_diff": abs(m - base[1])}
                     for name, (l, m) in runs],
            "max_loss_diff": max(abs(l - base[0]) for _, (l, _) in runs),
            "max_mrr_diff": max(abs(m - base[1]) for _, (_, m) in runs)}


def profile_phase(torch):
    """``--profile``: where the main path's time goes, by host clock with a
    device synchronise after each part (so each part's device work is
    inside its own interval): the warm pass per batch, and per scored val
    batch the hooks (sampling, negatives, staging), the model step and the
    metric."""
    from repro_torch.core import EVAL_KEY, TRAIN_KEY
    from repro_torch.train.metrics import mrr

    pipe = quickstart().compile(device=DEVICE)
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
        it = iter(pipe._loader(pipe.val_data))
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


def loader_phase(torch, rounds: int = 2, train_steps: int = 200):
    """``--profile``: what the prefetch thread would cost. The scored val
    pass (after an untimed warm pass) and the first ``train_steps`` train
    steps, run as ``evaluate`` / ``train_epoch`` run them (no synchronise
    inside, one at the end), with the batches from (a) the pipeline's loader
    (hooks in the calling thread), (b) ``PrefetchLoader`` (hooks in its
    producer thread). Host clock, ms per batch, the two in turns for
    ``rounds`` rounds."""
    from repro_torch.core import EVAL_KEY, TRAIN_KEY
    from repro_torch.train.metrics import mrr

    pipe = quickstart().compile(device=DEVICE)
    sync = torch.cuda.synchronize

    def scored(loader):
        pipe.reset_epoch_state()
        with pipe.manager.activate(TRAIN_KEY):
            for _ in loader(pipe.train_data):
                pass
        sync()
        n, t0 = 0, time.perf_counter()
        with pipe.manager.activate(EVAL_KEY):
            for b in loader(pipe.val_data):
                pos, neg = pipe._eval_step(b)
                mrr(pos, neg, b["batch_mask"])
                n += 1
        sync()
        return 1e3 * (time.perf_counter() - t0) / n

    def train(loader):
        pipe.reset_epoch_state()
        sync()
        n, t0 = 0, time.perf_counter()
        with pipe.manager.activate(TRAIN_KEY):
            it = iter(loader(pipe.train_data))
            for _, b in zip(range(train_steps), it):
                pipe._train_step(b)
                n += 1
            it.close()
        sync()
        return 1e3 * (time.perf_counter() - t0) / n

    out = {"eval_scored_ms_per_batch": {}, "train_ms_per_step": {}}
    for _ in range(rounds):
        for key, fn in (("eval_scored_ms_per_batch", scored),
                        ("train_ms_per_step", train)):
            for name, loader in (
                    ("inline", pipe._loader),
                    ("prefetch", lambda data: prefetch_loader(pipe, data))):
                out[key].setdefault(name, []).append(fn(loader))
    return out


def train_profile_phase(torch, n_steps: int = 150):
    """``--profile``: where a train step's time goes, by host clock with a
    device synchronise after each part: the next batch from the loader
    (hooks and staging, in the calling thread), the forward (K1 inside),
    the backward (K2 inside) and the AdamW update."""
    from repro_torch.core import TRAIN_KEY

    pipe = quickstart().compile(device=DEVICE)
    sync = torch.cuda.synchronize
    parts = {"hooks": [], "forward": [], "backward": [], "optimizer": []}
    pipe.reset_epoch_state()
    sync()
    with pipe.manager.activate(TRAIN_KEY):
        it = iter(pipe._loader(pipe.train_data))
        try:
            for _ in range(n_steps):
                t0 = time.perf_counter()
                batch = next(it, None)
                sync()
                t1 = time.perf_counter()
                if batch is None:
                    break
                loss = pipe._loss(batch)
                sync()
                t2 = time.perf_counter()
                grads = pipe._grads(loss)
                sync()
                t3 = time.perf_counter()
                pipe._update(grads)
                sync()
                t4 = time.perf_counter()
                for name, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                    parts[name].append(dt)
        finally:
            it.close()
    n = len(parts["forward"])
    # The first steps see an empty sampler and warm caches: skip 10.
    steady = {k: v[10:] for k, v in parts.items()}
    return pipe, {"steps": n, "steady_steps": max(n - 10, 0),
                  "ms_per_step_mean": {k: 1e3 * sum(v) / max(len(v), 1)
                                       for k, v in steady.items()},
                  "ms_per_step_median": {k: 1e3 * statistics.median(v)
                                         for k, v in steady.items() if v}}


def trace_phase(torch, pipe, n_batches: int = 30, train: bool = False):
    """``--profile``: ``torch.profiler`` over the first ``n_batches`` scored
    val batches (after a fresh warm pass), run as ``evaluate`` runs them, or
    with ``train`` over train steps 50 onwards as ``train_epoch`` runs them;
    no synchronise inside the window. Device busy time is the union of the
    device events' intervals; the idle share is one minus busy over the
    window's host-clock time (closed by a synchronise). Also the device time
    by kernel name, largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import EVAL_KEY, TRAIN_KEY
    from repro_torch.train.metrics import mrr

    pipe.reset_epoch_state()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if train:
        with pipe.manager.activate(TRAIN_KEY):
            it = iter(pipe._loader(pipe.train_data))
            try:
                for _, batch in zip(range(50), it):
                    pipe._train_step(batch)
                torch.cuda.synchronize()
                with profile(activities=acts) as prof:
                    t0 = time.perf_counter()
                    for _, batch in zip(range(n_batches), it):
                        pipe._train_step(batch)
                    torch.cuda.synchronize()
                    wall_us = 1e6 * (time.perf_counter() - t0)
            finally:
                it.close()
    else:
        with pipe.manager.activate(TRAIN_KEY):
            for _ in pipe._loader(pipe.train_data):
                pass
        torch.cuda.synchronize()
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
        k2, k2_cases = k2_phase(torch, torch.Generator().manual_seed(1))
        results.update(k2)
        emit({"phase": "kernels", "tolerance": {"atol": ATOL, "rtol": RTOL,
                                                "time_w_rtol": TIME_W_RTOL},
              "peaks": {"f32_flops": PEAK_F32_FLOPS, "bytes_per_s": PEAK_BYTES},
              "shapes": results, "degenerate": cases,
              "degenerate_bwd": k2_cases})

        sl = slice_phase(torch)
        emit({"phase": "slice", **sl})

        tr = train_phase(torch)
        emit({"phase": "train", "tolerance": {
            "step_loss": STEP_LOSS_TOL, "model_grad_rtol": GRAD_RTOL,
            "model_grad_floor": GRAD_FLOOR, "epoch_loss": EPOCH_LOSS_TOL,
            "val_mrr": TRAIN_MRR_TOL}, **tr})

        if "--profile" in sys.argv[1:]:
            pipe, prof = profile_phase(torch)
            emit({"phase": "profile", **prof})
            emit({"phase": "trace", **trace_phase(torch, pipe)})
            emit({"phase": "loader", **loader_phase(torch)})
            emit({"phase": "spread", **spread_phase(torch)})
            pipe, prof = train_profile_phase(torch)
            emit({"phase": "train_profile", **prof})
            emit({"phase": "train_trace", **trace_phase(torch, pipe, train=True)})
    except Exception as exc:  # any failed phase: no result line
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        return 1

    k1, k1w, k2 = results["K1_eval"], results["K1w_eval"], results["K2_train"]
    by_path = {
        "fused_temporal_layer": {
            "eval": sl["launches"]["fused_temporal_layer"],
            "train": tr["kernels"]["launches"]["fused_temporal_layer"]},
        "fused_temporal_layer_bwd": {
            "eval": sl["launches"]["fused_temporal_layer_bwd"],
            "train": tr["kernels"]["launches"]["fused_temporal_layer_bwd"]},
    }
    emit({"kernels": [{
        "name": "fused_temporal_layer", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_K1,
        "launches": sum(by_path["fused_temporal_layer"].values()),
        "launches_by_path": by_path["fused_temporal_layer"],
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None,
    }, {
        "name": "fused_temporal_layer_bwd", "route": "cuda",
        "source": BWD_SOURCE, "replaces": TPU_K2,
        "launches": sum(by_path["fused_temporal_layer_bwd"].values()),
        "launches_by_path": by_path["fused_temporal_layer_bwd"],
        "max_abs_err": k2["max_abs_err"],
        "max_rel_err": max(e[1] for e in k2["errors"].values()),
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": None,
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
