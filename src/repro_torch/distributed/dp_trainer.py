"""Data-parallel trainer (DistTGL-style) for the TG models.

Port of ``repro.distributed.dp_trainer`` onto ``torch.distributed``: each
rank of the mesh's data axis runs the step on its contiguous block of the
global event batch (a time-ordered sub-stream):

  * per-microbatch ``torch.autograd.grad``, accumulated over
    ``accum_steps`` microbatches and averaged;
  * the gradients all-reduced over the data group, optionally compressed
    (``compression.py``: ``bf16`` or ``int8_ef`` with error feedback), to
    their mean over the ranks; the loss averaged likewise;
  * model state (e.g. TGN memory) synchronized by the masked mean
    (``sync_state_masked_psum``) for stateful models;
  * the AdamW update run replicated on every rank (the port's
    ``optim/adamw.py``), so the parameters stay equal across ranks.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed import compression as comp
from repro_torch.distributed.sharding import (
    axis_group,
    axis_index,
    axis_size,
    sync_state_masked_psum,
)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map


class DataParallelTrainer:
    """Data-parallel wrapper around a per-rank loss function.

    ``loss_fn(params, state, batch_shard) -> (loss, (new_state, touched))``;
    ``touched`` is a bool mask over state rows this rank updated (``None``
    for stateless models: pass ``state={}``). ``mesh`` is a ``DeviceMesh``
    with the data axis ``axis``.
    """

    def __init__(self, loss_fn: Callable, mesh,
                 opt_cfg: AdamWConfig = AdamWConfig(lr=1e-4),
                 axis: str = "data", compression: str = "none",
                 accum_steps: int = 1):
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.axis = axis
        self.opt_cfg = opt_cfg
        self.compression = compression
        self.accum_steps = accum_steps
        self._step = None

    def init(self, params):
        """``(opt_state, err)``: the AdamW state and the zero error tree
        (``None`` unless ``compression="int8_ef"``)."""
        opt_state = adamw_init(params)
        err = (comp.zeros_like_error(params)
               if self.compression == "int8_ef" else None)
        return opt_state, err

    def build_step(self, stateful: bool):
        """Install (and return) the step: ``(params, opt_state, err, state,
        batch) -> (params, opt_state, err, state, loss)``."""
        group = axis_group(self.mesh, self.axis)
        n = axis_size(self.mesh, self.axis)
        r = axis_index(self.mesh, self.axis)

        def shard_step(params, opt_state, err, state, batch):
            # batch leaves: (accum, global_B, ...); this rank's block of B.
            def block(x):
                bl = x.shape[1] // n
                return x[:, r * bl:(r + 1) * bl]

            local = tree_map(block, batch)
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(params)]
            it = iter(leaves)
            p_req = tree_map(lambda _: next(it), params)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in leaves]
            loss_acc, touched_any = 0.0, None
            for i in range(self.accum_steps):
                micro = tree_map(lambda x: x[i], local)
                loss, (state, touched) = self.loss_fn(p_req, state, micro)
                g = torch.autograd.grad(loss, leaves, allow_unused=True)
                grads = [a if b is None else a + b for a, b in zip(grads, g)]
                loss_acc = loss_acc + loss.detach()
                if touched is not None:
                    touched_any = (touched if touched_any is None
                                   else touched_any | touched)
            it = iter(grads)
            grads = tree_map(lambda _: next(it) / self.accum_steps, params)
            loss = torch.as_tensor(loss_acc / self.accum_steps,
                                   dtype=torch.float32)

            wire, err, _ = comp.compress_grads(grads, err, self.compression)
            grads = comp.psum_compressed(wire, self.compression, group)
            loss = loss.clone()
            dist.all_reduce(loss, group=group)
            loss = loss / n
            if stateful and touched_any is not None:
                state = sync_state_masked_psum(state, touched_any, group)
            params, opt_state = adamw_update(params, grads, opt_state,
                                             self.opt_cfg)
            return params, opt_state, err, state, loss

        self._step = shard_step
        return self._step

    def step(self, params, opt_state, err, state, batch):
        """One step; ``batch`` leaves are ``(accum, global_B, ...)`` and
        every rank passes the same global batch."""
        if self._step is None:
            raise RuntimeError("call build_step() first")
        return self._step(params, opt_state, err, state, batch)
