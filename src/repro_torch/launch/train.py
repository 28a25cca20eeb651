"""Training from the command line, with checkpoint/restart fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train --workload tg \\
        --dataset tiny --epochs 2 --ckpt-dir /tmp/ck --device cpu

Three workloads, selected by ``--workload``, as in the reference's
``launch/train.py``:
  * ``tg``   — CTDG link prediction (``--model``, default 2-layer TGAT
               with k = 20 on the host recency sampler) on a synthetic
               TGB-like stream; after every epoch the parameters and the
               optimizer state go to an ``AsyncCheckpointer``;
  * ``dtdg`` — DTDG snapshot link prediction through ``tg.Experiment``
               (``--model gclstm``, ``--discretization h``) with a
               checkpoint after every chunk of ``--chunk-size`` snapshot
               pairs, so a resume lands mid-epoch on the exact chunk
               boundary (``snapshot_cursor``);
  * ``lm``   — LM training (``--arch``, default qwen3-0.6b, at full width
               or ``--reduced``) on the synthetic token stream, random
               parameters from ``--seed``; on the card every attention
               runs K5 forward and K5b backward; the parameters and the
               optimizer state go to an ``AsyncCheckpointer`` every
               ``--ckpt-every`` steps, and a resumed run skips the batches
               already consumed (the stream is a pure function of the
               seed), so it ends on the uninterrupted run's bits.

The last line gives the test MRR (``tg``, ``dtdg``) or the final loss
(``lm``), also in full, to compare runs bit for bit. ``--resume`` restores
the newest checkpoint in ``--ckpt-dir``; ``--simulate-failure N`` exits
with code 42 after epoch N (``tg``), after N chunks (``dtdg``) or after
step N (``lm``), to exercise the restart path. Runs on the card by default
(``--device cuda``; it raises without a GPU).

    PYTHONPATH=src python -m repro_torch.launch.train --workload lm \\
        --arch qwen3-0.6b --reduced --steps 12 --batch-size 2 --seq-len 16 \\
        --device cpu
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np


def train_tg(args) -> int:
    """Epochs of CTDG link training with async per-epoch checkpoints, then
    the test MRR."""
    from repro_torch.data import generate
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.train.tg_trainer import LinkPredictionTrainer

    data = generate(args.dataset, scale=args.data_scale)
    tr = LinkPredictionTrainer(
        args.model, data, batch_size=args.batch_size, k=args.k,
        eval_negatives=args.eval_negatives, seed=args.seed, device=args.device,
    )

    start_epoch = 0
    if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
        tree, step, extra = ckpt.restore(
            args.ckpt_dir, target={"params": tr.params, "opt": tr.opt_state})
        tr.load_params(tree["params"])
        tr.load_opt_state(tree["opt"])
        start_epoch = extra.get("epoch", step) + 1
        print(f"[resume] restored epoch {start_epoch - 1} from {args.ckpt_dir}",
              flush=True)

    writer = ckpt.AsyncCheckpointer(args.ckpt_dir, keep=3)
    for epoch in range(start_epoch, args.epochs):
        loss, secs = tr.train_epoch()
        mrr, _ = tr.evaluate("val") if args.eval_every and (
            epoch % args.eval_every == 0) else (float("nan"), 0)
        print(f"epoch {epoch}: loss={loss:.4f} mrr={mrr:.4f} ({secs:.1f}s)",
              flush=True)
        writer.save(epoch, {"params": tr.params, "opt": tr.opt_state},
                    extra_meta={"epoch": epoch, "loss": float(loss)})
        if args.simulate_failure is not None and epoch == args.simulate_failure:
            writer.wait()
            print("[failure-injection] exiting mid-run", flush=True)
            os._exit(42)
    writer.close()
    mrr, _ = tr.evaluate("test")
    print(f"final test MRR: {mrr:.4f} ({mrr!r})", flush=True)
    return 0


def train_dtdg(args) -> int:
    """DTDG link training through ``tg.Experiment`` with a checkpoint after
    every chunk; a resumed run ends on the uninterrupted run's bits."""
    from repro_torch import tg
    from repro_torch.distributed import checkpoint as ckpt

    exp = tg.Experiment(
        task="link",
        data=tg.DataSpec(dataset=args.dataset, scale=args.data_scale,
                         discretization=args.discretization),
        model=tg.ModelSpec(name=args.model),
        train=tg.TrainSpec(epochs=args.epochs, seed=args.seed,
                           compiled=True, chunk_size=args.chunk_size),
    )
    pipe = exp.compile(device=args.device)

    start_epoch = 0
    if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
        step = pipe.restore_checkpoint(args.ckpt_dir)
        start_epoch = step // 100000
        print(f"[resume] restored step {step} "
              f"(epoch {start_epoch}, cursor {pipe.snapshot_cursor})",
              flush=True)

    chunks_done = 0
    for epoch in range(start_epoch, args.epochs):
        t0 = time.perf_counter()
        losses: list = []
        while True:
            chunk_losses = pipe.train_chunk()
            if chunk_losses is None:
                break
            losses.extend(chunk_losses)
            chunks_done += 1
            # The step encodes (epoch, cursor): unique, increasing, and
            # enough to place a resume at the exact chunk boundary.
            pipe.save_checkpoint(args.ckpt_dir,
                                 epoch * 100000 + pipe.snapshot_cursor)
            if (args.simulate_failure is not None
                    and chunks_done == args.simulate_failure):
                print("[failure-injection] exiting mid-run", flush=True)
                os._exit(42)
        loss = float(np.mean(losses)) if losses else 0.0
        print(f"epoch {epoch}: loss={loss:.4f} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    mrr, _ = pipe.evaluate("test")
    print(f"final test MRR: {mrr:.4f} ({mrr!r})", flush=True)
    return 0


def train_lm(args) -> int:
    """Steps of LM training on the synthetic token stream with async
    checkpoints every ``--ckpt-every`` steps, then the final loss."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic_token_batches
    from repro_torch.device import resolve_device
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.models.lm import model as M
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.lm_train import init_opt_state, make_train_step
    from repro_torch.tree import tree_leaves

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = M.init(cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, AdamWConfig(lr=args.lr),
                              kv_block=min(1024, args.seq_len))

    start = 0
    if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
        tree, start_step, _ = ckpt.restore(
            args.ckpt_dir, target={"params": params, "opt": opt_state})
        live = tree_leaves({"params": params, "opt": opt_state})
        with torch.no_grad():  # assemble() keeps the target's nesting and order
            for dst, src in zip(live, tree_leaves(tree)):
                dst.copy_(torch.as_tensor(src))
        start = start_step + 1
        print(f"[resume] restored step {start - 1}", flush=True)

    writer = ckpt.AsyncCheckpointer(args.ckpt_dir, keep=3)
    batches = synthetic_token_batches(cfg.vocab_size, args.batch_size,
                                      args.seq_len, args.steps, seed=args.seed)
    t0 = time.perf_counter()
    metrics = None
    for step, (tokens, labels) in enumerate(batches):
        if step < start:
            continue  # deterministic replay: skip the batches consumed
        batch = {"tokens": torch.as_tensor(tokens, device=device),
                 "labels": torch.as_tensor(labels, device=device)}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % args.log_every == 0:
            print(f"step {step}: loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
        if args.ckpt_every and step % args.ckpt_every == 0:
            writer.save(step, {"params": params, "opt": opt_state})
        if args.simulate_failure is not None and step == args.simulate_failure:
            writer.wait()
            print("[failure-injection] exiting mid-run", flush=True)
            os._exit(42)
    writer.close()
    loss = float(metrics["loss"])
    print(f"done: final loss {loss:.4f} ({loss!r})", flush=True)
    return 0


def main(argv: Optional[list] = None) -> int:
    """Parse the flags and run the workload; returns the exit code."""
    p = argparse.ArgumentParser()
    p.add_argument("--workload", choices=["tg", "dtdg", "lm"], default="tg")
    p.add_argument("--ckpt-dir", default="checkpoints")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--simulate-failure", type=int, default=None)
    p.add_argument("--device", default="cuda")
    # tg
    p.add_argument("--model", default="tgat")
    p.add_argument("--dataset", default="tiny")
    p.add_argument("--data-scale", type=float, default=1.0)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=200)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--eval-negatives", type=int, default=20)
    p.add_argument("--eval-every", type=int, default=0)
    # dtdg
    p.add_argument("--discretization", default="h")
    p.add_argument("--chunk-size", type=int, default=4)
    # lm
    p.add_argument("--arch", default="qwen3-0.6b")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--ckpt-every", type=int, default=20)
    args = p.parse_args(argv)
    if args.workload == "tg":
        return train_tg(args)
    if args.workload == "dtdg":
        return train_dtdg(args)
    return train_lm(args)


if __name__ == "__main__":
    raise SystemExit(main())
