"""The single-device train step (``repro.train.steps.make_train_step``'s
counterpart).

The step computes the loss and every parameter's gradient with autograd,
updates the parameters and the optimizer state in place, and returns the
metrics.  The sharded and shard_map trainers come with ROADMAP.md queue 1
item 5.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models import lm
from ..optim import Optimizer


def make_train_step(cfg: ArchConfig, optimizer: Optimizer, remat: str = "full",
                    loss_chunk: int = 0):
    """-> ``train_step(model, opt_state, batch, step) -> (model, opt_state,
    metrics)``.  ``batch`` holds tensors on the model's device; ``metrics``
    are 0-d tensors: ``loss`` (xent + aux_weight * aux), ``xent``, ``aux``
    (but for the audio encoder) and ``grad_norm`` (the fp32 square root of
    the sum of squares of every gradient).  The step makes the parameters
    trainable (``requires_grad_``); a parameter the loss does not read gets
    a zero gradient, as ``jax.grad`` gives it."""

    def train_step(model, opt_state, batch, step: int):
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        with torch.enable_grad():
            total, metrics = lm.loss_fn(model, batch, cfg, remat=remat, loss_chunk=loss_chunk)
            grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
        optimizer.update(grads, opt_state, params, step)
        metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
        metrics.update(loss=total.detach(), grad_norm=gnorm)
        return model, opt_state, metrics

    return train_step
