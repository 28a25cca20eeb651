"""Batched serving from the command line: prefill a prompt batch, decode N
tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --reduced --batch 4 --prompt-len 32 --new-tokens 16 --device cpu

Runs on the card by default (``--device cuda``; it raises without a GPU),
where the prefill's attention runs K5 and its SSD mixers K6. Parameters are
random, drawn from ``--seed`` on the device; the prompt tokens come from
numpy's generator seeded the same way, as in the reference's
``launch/serve.py``.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch


def main(argv: Optional[list] = None) -> int:
    """Parse the flags, build the model and generate; prints the reference's
    line, then prefill and decode tokens per second on lines of their own."""
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen3-0.6b")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--new-tokens", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models.lm import model as M
    from repro_torch.serve import generate

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=dev)}

    timings = {}
    t0 = time.perf_counter()
    out = generate(params, cfg, batch, num_tokens=args.new_tokens,
                   temperature=args.temperature, seed=args.seed,
                   kv_block=min(256, args.prompt_len), timings=timings)
    dt = time.perf_counter() - t0
    print(f"{cfg.name}: {tuple(out.shape)} tokens in {dt:.1f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s incl. kernel build)")
    print(f"prefill: {args.batch * args.prompt_len / timings['prefill_s']:.1f} tok/s "
          f"({timings['prefill_s']:.3f} s)")
    print(f"decode: {args.batch * args.new_tokens / timings['decode_s']:.1f} tok/s "
          f"({1e3 * timings['decode_s'] / max(args.new_tokens, 1):.2f} ms per step)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
