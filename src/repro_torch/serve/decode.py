"""Serving steps: prefill + single-token decode (greedy/sampled), plus a
small batched generation loop, as in the reference's ``serve/decode.py``.

There is no ``jit``: the steps run eagerly. On the card the prefill runs K5
and K6 (``mode="auto"``); the decode step is plain PyTorch.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import model as M


def make_prefill_step(cfg: ArchConfig, max_len: Optional[int] = None,
                      kv_block: int = 1024, mode: str = "auto"):
    """``prefill_step(params, batch) -> (last logits, cache)``."""
    def prefill_step(params, batch):
        return M.prefill(params, cfg, batch, max_len=max_len, kv_block=kv_block,
                         mode=mode)

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """``serve_step(params, cache, tokens) -> (logits, cache)``, tokens
    (B,): the most recent token per sequence; the cache is updated in
    place."""
    def serve_step(params, cache, tokens):
        return M.decode_step(params, cfg, cache, tokens)

    return serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, cfg: ArchConfig, batch, num_tokens: int,
             temperature: float = 0.0, seed: int = 0, kv_block: int = 256,
             timings: Optional[dict] = None):
    """Greedy (``temperature`` 0: argmax, first index on ties) or sampled
    generation; returns (B, num_tokens) int32 tokens. Sampling draws from a
    ``torch.Generator`` on the tokens' device seeded by ``seed`` (not the
    reference's ``jax.random`` stream). With ``timings`` (a dict), the
    prefill's and the decode loop's seconds are stored under ``prefill_s``
    and ``decode_s``, each closed by a device synchronise."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    dev = tokens.device
    prefill = make_prefill_step(cfg, max_len=S + num_tokens + 1,
                                kv_block=kv_block)
    step = make_decode_step(cfg)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    if timings is not None:
        _sync(dev)
        t1 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for _ in range(num_tokens):
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
        else:
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
        logits, cache = step(params, cache, tok)
    if timings is not None:
        _sync(dev)
        timings["prefill_s"] = t1 - t0
        timings["decode_s"] = time.perf_counter() - t1
    return torch.stack(out, dim=1)  # (B, num_tokens)
