#!/usr/bin/env python3
"""Profile 2-layer TGAT (the reference's default: two hops of k = 20) on
the card, on both recency samplers, and time its node-row gathers'
backward two ways.

    python3 scripts/tgat2_profile.py

Needs a CUDA GPU and ``nvcc`` (the kernels are built at first use). Uses
this checkout's ``chip_smoke.py`` for the experiment
(``chip_smoke.tgat2_experiment``: full-scale synthetic ``wikipedia``,
batch 200, 20 eval negatives) and its profiler windows
(``chip_smoke.trace_phase``). Prints one JSON line per measurement:

* ``{device,host}_eval_trace`` / ``{device,host}_train_trace``:
  ``torch.profiler`` over 10 scored val batches and over 20 train steps
  (after 50), as ``evaluate`` and ``train_epoch`` run them: window ms,
  device-busy ms, the device's idle share, device ms by kernel name;
* ``gather_ab``: host-sampler train steps (30, after 10, batches sampled
  beforehand, closed by a synchronise) with ``node_features``' row gather
  (the classic path's node embeddings of the seeds, the hop-1 and the
  hop-2 ids) by indexing (``table[ids]``, whose CUDA backward is
  ``indexing_backward_kernel``) and by ``models.tg.common.gather_rows``
  (``F.embedding``), in turns: indexing, embedding, embedding, indexing;
  ms per step of each;
* ``host_train_trace_indexing``: the host sampler's train window again,
  with the gather by indexing.

Last, the card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("tgat2_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as c
    import repro_torch.models.tg.common as common
    from repro_torch.core import TRAIN_KEY
    from repro_torch.data import generate
    from repro_torch.kernels import _build

    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    wiki = generate("wikipedia", scale=1.0)
    keys = ("window_ms", "device_busy_ms", "device_idle_share", "device_ms_by_name",
            "kernel_device_ms")
    for device_sampler in (True, False):
        label = "device" if device_sampler else "host"
        pipe = c.tgat2_experiment(device_sampler).compile(data=wiki, device="cuda")
        for name, train, n in (("eval", False, 10), ("train", True, 20)):
            r = c.trace_phase(torch, pipe, n_batches=n, train=train)
            c.emit({"measure": f"{label}_{name}_trace", "batches": n,
                    **{k: r[k] for k in keys}})
    # ``pipe`` is the host-sampler pipeline now.

    def indexing(table, ids):
        return table[ids]

    def steps(n=30):
        pipe.reset_epoch_state()
        with pipe.manager.activate(TRAIN_KEY):
            it = iter(pipe._loader(pipe.train_data))
            for _, b in zip(range(10), it):
                pipe._train_step(b)
            batches = [b for _, b in zip(range(n), it)]
            it.close()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for b in batches:
            pipe._train_step(b)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / n

    kept = common.gather_rows
    runs = []
    try:
        for name, fn in (("indexing", indexing), ("embedding", kept),
                         ("embedding", kept), ("indexing", indexing)):
            common.gather_rows = fn
            runs.append([name, steps()])
        common.gather_rows = indexing
        r = c.trace_phase(torch, pipe, n_batches=20, train=True)
    finally:
        common.gather_rows = kept
    c.emit({"measure": "gather_ab", "host_train_ms_per_step": runs})
    c.emit({"measure": "host_train_trace_indexing", "batches": 20,
            **{k: r[k] for k in keys}})
    print(c.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
