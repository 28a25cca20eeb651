#!/usr/bin/env python3
"""Time the port's fused temporal layer kernels (K1, K2) of one source tree.

    python3 scripts/fused_layer_ab.py SRC_DIR

SRC_DIR holds a ``repro_torch`` package (``src`` of this checkout, or of
another commit unpacked with ``git archive <commit> src | tar -x -C DIR``).
The measuring code is this checkout's ``chip_smoke.py``, whatever the tree,
so two trees are timed alike; run them in turns in one process each (A, B,
B, A) on one card to compare. Needs a CUDA GPU and ``nvcc``. Prints one
JSON line per shape and, last, ``AB {...}`` with:

* ``K1_{eval,train}``, ``K2_{eval,train}``: CUDA-event ms per call and the
  profiler's device µs per call (every device kernel the call launches) at
  the main path's shapes (``chip_smoke.layer_inputs``, S = 4,400 and 600);
* ``train_window`` / ``eval_window``: ``torch.profiler`` over 30 train steps
  (after 50) and 30 scored val batches of the quickstart pipeline on the
  device sampler: host ms and device-busy ms per step, the idle share, and
  the device ms per step of K1, K2, memsets and the rest (by kernel name,
  this tree's ``ftl_*`` launches or the earlier sources' names).
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def classify(name: str) -> str:
    if "ftl_fwd_" in name or "fused_temporal_layer_fwd_kernel" in name:
        return "K1"
    if any(k in name for k in ("ftl_bwd_", "bwd_seed_kernel", "weight_grad_partial_kernel",
                               "sum_partials_kernel")):
        return "K2"
    return "memset" if "emset" in name else "other"


def window(prof, wall_us: float, steps: int) -> dict:
    from torch.autograd import DeviceType

    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if b > end:
            busy += b - max(a, end)
            end = b
    by = {}
    for e in dev:
        k = classify(e.name)
        by[k] = by.get(k, 0.0) + (e.time_range.end - e.time_range.start)
    return {"steps": steps, "wall_ms_per_step": wall_us / 1e3 / steps,
            "busy_ms_per_step": busy / 1e3 / steps, "idle_share": 1 - busy / wall_us,
            "device_ms_per_step_by_class": {k: v / 1e3 / steps for k, v in by.items()},
            "share_of_busy": {k: v / busy for k, v in by.items()}}


def main() -> int:
    tree = str(Path(sys.argv[1]).resolve())
    sys.path[:0] = [tree, str(ROOT)]
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as c
    import repro_torch
    from repro_torch.kernels import _build

    if not torch.cuda.is_available() or not repro_torch.__file__.startswith(tree):
        print("fused_layer_ab: needs a CUDA GPU and SRC_DIR/repro_torch", file=sys.stderr)
        return 2
    _build.build_all()
    from repro_torch.core import EVAL_KEY, TRAIN_KEY
    from repro_torch.kernels.temporal_attention import (
        fused_temporal_layer_bwd_kernel as k2,
        fused_temporal_layer_kernel as k1,
    )
    from repro_torch.train.metrics import mrr

    out = {"tree": tree, "nvidia_smi": c.nvidia_smi_line()}
    gen = torch.Generator().manual_seed(0)
    for name, S in (("eval", c.EVAL_S), ("train", c.TRAIN_S)):
        ops, kw = c.layer_inputs(torch, gen, S)
        g = torch.randn((S, c.H, c.D), generator=gen).to("cuda")
        for label, fn in (("K1", lambda: k1(**ops, **kw)), ("K2", lambda: k2(g, **ops, **kw))):
            out[f"{label}_{name}"] = dict(ms=c.time_ms(torch, fn, 20),
                                          device_us=c.device_us_per_call(torch, fn, 20))
        print(json.dumps({k: v for k, v in out.items() if k.endswith(name)}), flush=True)

    pipe = c.quickstart().compile(device="cuda")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    n = 30
    pipe.reset_epoch_state()
    with pipe.manager.activate(TRAIN_KEY):
        it = iter(pipe._loader(pipe.train_data))
        for _, batch in zip(range(50), it):
            pipe._train_step(batch)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _, batch in zip(range(n), it):
                pipe._train_step(batch)
            torch.cuda.synchronize()
            wall = 1e6 * (time.perf_counter() - t0)
        it.close()
    out["train_window"] = window(prof, wall, n)
    pipe.reset_epoch_state()
    with pipe.manager.activate(TRAIN_KEY):
        for _ in pipe._loader(pipe.train_data):
            pass
    torch.cuda.synchronize()
    with profile(activities=acts) as prof, pipe.manager.activate(EVAL_KEY):
        t0 = time.perf_counter()
        for _, batch in zip(range(n), pipe._loader(pipe.val_data)):
            pos, neg = pipe._eval_step(batch)
            mrr(pos, neg, batch["batch_mask"])
        torch.cuda.synchronize()
        wall = 1e6 * (time.perf_counter() - t0)
    out["eval_window"] = window(prof, wall, n)
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
