#!/usr/bin/env python3
"""Time the port's classic-path attention (K3 and its gradient) of one tree.

    python3 scripts/classic_attention_ab.py SRC_DIR

SRC_DIR holds a ``repro_torch`` package (``src`` of this checkout, or of
another commit unpacked with ``git archive <commit> src | tar -x -C DIR``).
The measuring code is this checkout's ``chip_smoke.py``, whatever the tree,
so two trees are timed alike; run them in turns in one process each (A, B,
B, A) on one card to compare. Needs a CUDA GPU and ``nvcc``. Prints one
JSON line per measurement and, last, ``AB {...}`` with:

* ``K3_{eval,train}``: CUDA-event ms per call and the profiler's device µs
  per call of ``temporal_attention_kernel`` at the classic path's shapes
  (``chip_smoke.attention_inputs`` with the "path" mask, S = 4,400 and 600);
* ``K3_backward_train``: the backward of ``_TemporalAttentionFn`` at S =
  600 (``torch.autograd.grad`` over a retained graph): CUDA-event ms per
  call, device µs per call and device launches per call (every device
  kernel the backward runs: the plain recompute's, or the backward kernel);
* ``train_window`` / ``eval_window``: ``torch.profiler`` over 30 train steps
  (after 50) and 30 scored val batches of the host-sampler quickstart
  (``chip_smoke.quickstart_host``): host ms and device-busy ms per step, the
  idle share, and the device ms per step of K3's forward, of its backward
  and of the rest. The backward is the backward kernel by name, or every
  device kernel launched under the ``_TemporalAttentionFnBackward`` node
  (the plain recompute of a tree without a backward kernel).
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BWD_NODE = "_TemporalAttentionFnBackward"


def classify(name: str) -> str:
    if "ta_fwd_kernel" in name or "temporal_attention_kernel" in name:
        return "K3"
    if "ta_bwd_kernel" in name:
        return "K3b"
    return "memset" if "emset" in name else "other"


def _subtree_kernels(ev):
    """(name, µs) of every device kernel attached to ``ev`` or its children."""
    out = [(k.name, k.duration) for k in ev.kernels]
    for ch in ev.cpu_children:
        out += _subtree_kernels(ch)
    return out


def backward_node_kernels(prof):
    """Device kernels launched under the outermost ``BWD_NODE`` events."""
    out = []
    for e in prof.events():
        if BWD_NODE not in e.name:
            continue
        p, nested = e.cpu_parent, False
        while p is not None:
            nested |= BWD_NODE in p.name
            p = p.cpu_parent
        if not nested:
            out += _subtree_kernels(e)
    return out


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
    # The plain recompute's kernels under the backward node move from
    # "other" to "K3b" (a named backward kernel is counted once).
    recompute = sum(us for name, us in backward_node_kernels(prof)
                    if classify(name) == "other")
    by["other"] = by.get("other", 0.0) - recompute
    by["K3b"] = by.get("K3b", 0.0) + recompute
    return {"steps": steps, "wall_ms_per_step": wall_us / 1e3 / steps,
            "busy_ms_per_step": busy / 1e3 / steps, "idle_share": 1 - busy / wall_us,
            "device_ms_per_step_by_class": {k: v / 1e3 / steps for k, v in by.items()},
            "share_of_busy": {k: v / busy for k, v in by.items()}}


def device_launches(torch, fn, n: int = 20) -> dict:
    """Device µs and device launches per call of ``fn`` (profiler, between
    the chip_smoke idle margins)."""
    import chip_smoke as c
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(c.PROFILE_MARGIN_S)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        time.sleep(c.PROFILE_MARGIN_S)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return {"device_us": None, "launches": None}
    return {"device_us": sum(e.time_range.end - e.time_range.start for e in dev) / n,
            "launches": len(dev) / n}


def main() -> int:
    tree = str(Path(sys.argv[1]).resolve())
    sys.path[:0] = [tree, str(ROOT)]
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as c
    import repro_torch

    if not torch.cuda.is_available() or not repro_torch.__file__.startswith(tree):
        print("classic_attention_ab: needs a CUDA GPU and SRC_DIR/repro_torch",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import EVAL_KEY, TRAIN_KEY
    from repro_torch.kernels.temporal_attention import ops
    from repro_torch.kernels.temporal_attention import temporal_attention_kernel as k3
    from repro_torch.train.metrics import mrr

    out = {"tree": tree, "nvidia_smi": c.nvidia_smi_line()}
    gen = torch.Generator().manual_seed(0)
    for name, S in (("eval", c.EVAL_S), ("train", c.TRAIN_S)):
        q, k, v, m = c.attention_inputs(torch, gen, S)
        fn = lambda: k3(q, k, v, m)  # noqa: E731
        out[f"K3_{name}"] = dict(ms=c.time_ms(torch, fn, 20),
                                 device_us=c.device_us_per_call(torch, fn, 20))
        print(json.dumps({f"K3_{name}": out[f"K3_{name}"]}), flush=True)

    q, k, v, m = c.attention_inputs(torch, gen, c.TRAIN_S)
    g = torch.randn((c.TRAIN_S, c.H, c.D), generator=gen).to("cuda")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = ops._TemporalAttentionFn.apply(*leaves, m)
    bwd = lambda: torch.autograd.grad(o, leaves, g, retain_graph=True)  # noqa: E731
    out["K3_backward_train"] = dict(ms=c.time_ms(torch, bwd, 20),
                                    **device_launches(torch, bwd))
    print(json.dumps({"K3_backward_train": out["K3_backward_train"]}), flush=True)

    pipe = c.quickstart_host().compile(device="cuda")
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
