"""Deterministic fault injection for the online serving path.

A :class:`FaultInjector` perturbs the two places a live temporal-graph
service actually fails in production:

* the **event stream** — dropped, duplicated, and out-of-order updates
  (:meth:`FaultInjector.perturb_events`), and
* the **model path** — slow steps, raised model errors, and host<->device
  transfer errors (:meth:`FaultInjector.wrap_model` /
  :meth:`FaultInjector.wrap_transfer`).

Everything is driven by a seeded ``np.random.default_rng`` so chaos tests
are reproducible: the same seed yields the same fault schedule, which lets
tests assert exact shed/degrade behavior instead of flaky approximations.
The port's copy of ``repro.serve.faults``: its draws are the reference's,
draw for draw.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np


class ModelFault(RuntimeError):
    """Raised by a fault-wrapped model step to simulate a model failure."""


class TransferFault(RuntimeError):
    """Raised by a fault-wrapped transfer to simulate a host<->device error."""


class FaultInjector:
    """Seeded chaos source for :class:`~repro_torch.serve.graph_service.OnlineGraphService`.

    Probabilities are per-event (stream faults) or per-call (model faults);
    all default to 0 so an injector with no arguments is a no-op.
    """

    def __init__(self, seed: int = 0, *, drop_p: float = 0.0, dup_p: float = 0.0,
                 reorder_p: float = 0.0, reorder_span: int = 4,
                 slow_p: float = 0.0, slow_s: float = 0.05,
                 fail_p: float = 0.0, transfer_fail_p: float = 0.0):
        self.rng = np.random.default_rng(seed)
        self.drop_p = drop_p
        self.dup_p = dup_p
        self.reorder_p = reorder_p
        self.reorder_span = max(1, int(reorder_span))
        self.slow_p = slow_p
        self.slow_s = slow_s
        self.fail_p = fail_p
        self.transfer_fail_p = transfer_fail_p
        self.stats = {"dropped": 0, "duplicated": 0, "reordered": 0,
                      "slow_steps": 0, "model_faults": 0, "transfer_faults": 0}

    def perturb_events(self, events: Sequence[tuple]) -> list[tuple]:
        """Apply drop/duplicate/reorder faults to an event sequence.

        Events are opaque tuples (the service uses ``(src, dst, t, eid)``).
        Duplicates re-emit the same tuple (same eid — a retry, not a new
        edge); reordering swaps an event with one up to ``reorder_span``
        positions later.
        """
        out: list[tuple] = []
        for ev in events:
            if self.drop_p and self.rng.random() < self.drop_p:
                self.stats["dropped"] += 1
                continue
            out.append(ev)
            if self.dup_p and self.rng.random() < self.dup_p:
                self.stats["duplicated"] += 1
                out.append(ev)
        if self.reorder_p:
            i = 0
            while i < len(out) - 1:
                if self.rng.random() < self.reorder_p:
                    j = min(len(out) - 1,
                            i + 1 + int(self.rng.integers(self.reorder_span)))
                    out[i], out[j] = out[j], out[i]
                    self.stats["reordered"] += 1
                i += 1
        return out

    def wrap_model(self, fn: Callable) -> Callable:
        """Wrap a model step: sleeps ``slow_s`` with prob ``slow_p``, raises
        :class:`ModelFault` with prob ``fail_p``, else calls through."""

        def wrapped(*args, **kwargs):
            if self.slow_p and self.rng.random() < self.slow_p:
                self.stats["slow_steps"] += 1
                time.sleep(self.slow_s)
            if self.fail_p and self.rng.random() < self.fail_p:
                self.stats["model_faults"] += 1
                raise ModelFault("injected model fault")
            return fn(*args, **kwargs)

        return wrapped

    def wrap_transfer(self, fn: Callable) -> Callable:
        """Wrap a host<->device transfer: raises :class:`TransferFault` with
        prob ``transfer_fail_p``, else calls through."""

        def wrapped(*args, **kwargs):
            if self.transfer_fail_p and self.rng.random() < self.transfer_fail_p:
                self.stats["transfer_faults"] += 1
                raise TransferFault("injected transfer fault")
            return fn(*args, **kwargs)

        return wrapped
