"""The LM training step: loss, gradient, clip and AdamW (the reference's
``repro.train.lm_train``).

On the card (``mode="auto"``) a step runs, per layer, the kernels of its
family: dense (qwen3) K5 forward and K5b backward for its attention; ssm
(mamba2) K6 forward and K6b backward for its SSD scan; hybrid (hymba) both
pairs, attention and scan side by side. Under remat (``cfg.remat``) each
layer's forward runs twice, so a step launches K5 or K6 twice a layer and
K5b or K6b once. ``mode="ref"`` runs the plain versions. Parameters may be
bfloat16 (the configs' default) with float32 AdamW moments.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import model as M
from repro_torch.models.lm.params import abstract
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map


def _like(tree, leaves):
    """``leaves`` (in ``tree_leaves`` order) in ``tree``'s nesting."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig = AdamWConfig(lr=3e-4),
                    clip_norm: float = 1.0, kv_block: int = 1024,
                    ce_chunks: int = 0, accum_steps: int = 1,
                    mode: str = "auto"):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``.

    The step differentiates ``loss_fn`` with ``torch.autograd.grad`` (no
    ``.grad`` state is kept) through detached leaves that share the
    parameters' storage, clips the gradients by their global norm and
    updates the parameters and moments in place with AdamW; the returned
    ``params`` and ``opt_state`` are the trees given. ``accum_steps > 1``
    splits the batch into that many microbatches along its first axis, run
    one after another: their gradients are summed in float32 in microbatch
    order and divided by ``accum_steps`` (the loss likewise), as the
    reference's scan does.
    """

    def value_and_grad(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = M.loss_fn(_like(params, leaves), cfg, batch, kv_block=kv_block,
                         ce_chunks=ce_chunks, mode=mode)
        return loss.detach(), list(torch.autograd.grad(loss, leaves))

    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in tree_leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=grads[0].device)
            for i in range(accum_steps):
                mb = {k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                mloss, mgrads = value_and_grad(params, mb)
                grads = [a + g for a, g in zip(grads, mgrads)]
                loss = loss + mloss
            grads = [g / accum_steps for g in grads]
            loss = loss / accum_steps
        grads, gnorm = clip_by_global_norm(_like(params, grads), clip_norm)
        params, opt_state = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def init_opt_state(params):
    """AdamW state for ``params``: float32 moments and an int32 step."""
    return adamw_init(params)


def abstract_opt_state(cfg: ArchConfig, mesh=None, rules=None):
    """Meta-device tensors of the AdamW state's shapes and dtypes (float32
    moments of every parameter, an int32 step): sizes without allocating.
    ``mesh`` (the reference shards the moments like the parameters) raises:
    placing LM parameters by their logical axes (DTensor) is ROADMAP A6's
    next item."""
    if mesh is not None:
        raise NotImplementedError(
            "abstract_opt_state(mesh=) places the moments by the parameters' "
            "logical axes (DTensor), which is not ported yet (ROADMAP A6)")
    mom = abstract(M.param_specs(cfg), torch.float32)
    return {"mu": mom, "nu": abstract(M.param_specs(cfg), torch.float32),
            "step": torch.empty((), dtype=torch.int32, device="meta")}
