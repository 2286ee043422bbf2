"""Train steps (``repro.train.steps``'s counterparts).

* :func:`make_train_step`: the single-device step.  It computes the loss and
  every parameter's gradient with autograd, updates the parameters and the
  optimizer state in place, and returns the metrics.
* :func:`make_shardmap_dp_train_step`: the §6 trainer, explicit data
  parallelism whose gradient sync is the collective schedule the
  co-optimizer searched, by default the multi-ring TotientPerms AllReduce
  (:mod:`repro_torch.core.collectives`), optionally int8-compressed.  Every
  rank of the mesh axis runs it on the same global batch and keeps the rows
  of its own mesh position.

The GSPMD trainer (the reference's ``jit_train_step`` with its sharding
plan) comes with ROADMAP.md queue 1 item 1.7.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..core.collectives import psum, topoopt_psum_fn
from ..models import lm
from ..optim import Optimizer
from ..weights import jax_leaf_groups


def loss_and_grads(model, batch, cfg: ArchConfig, remat: str = "full", loss_chunk: int = 0):
    """-> (loss, metrics, params, grads): the loss (0-d, detached), the loss
    function's metrics, ``named_parameters()`` as a dict, and each
    parameter's gradient by name.  Makes the parameters trainable
    (``requires_grad_``); a parameter the loss does not read gets a zero
    gradient, as ``jax.grad`` gives it."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    with torch.enable_grad():
        total, metrics = lm.loss_fn(model, batch, cfg, remat=remat, loss_chunk=loss_chunk)
        grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(params.items(), grads)}
    return total.detach(), metrics, params, grads


def make_train_step(cfg: ArchConfig, optimizer: Optimizer, remat: str = "full",
                    loss_chunk: int = 0):
    """-> ``train_step(model, opt_state, batch, step) -> (model, opt_state,
    metrics)``.  ``batch`` holds tensors on the model's device; ``metrics``
    are 0-d tensors: ``loss`` (xent + aux_weight * aux), ``xent``, ``aux``
    (but for the audio encoder) and ``grad_norm`` (the fp32 square root of
    the sum of squares of every gradient)."""

    def train_step(model, opt_state, batch, step: int):
        total, metrics, params, grads = loss_and_grads(model, batch, cfg, remat, loss_chunk)
        gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
        optimizer.update(grads, opt_state, params, step)
        metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
        metrics.update(loss=total, grad_norm=gnorm)
        return model, opt_state, metrics

    return train_step


def make_shardmap_dp_train_step(
    cfg: ArchConfig,
    optimizer: Optimizer,
    mesh,
    axis_name: str = "data",
    ring_strides: tuple[int, ...] = (1,),
    compressor=None,
    schedule: str = "ring",
):
    """The §6 trainer -> ``step(model, opt_state, batch, step_idx, residual)
    -> (model, opt_state, mean loss, residual)``.

    ``batch`` is the global batch on this rank's device; the rank keeps rows
    ``[pos * b, (pos + 1) * b)``, ``pos`` its position on ``axis_name`` of
    ``mesh`` (a :class:`~repro_torch.core.device_order.Mesh`) and ``b`` the
    global batch over the axis size, as ``P(axis_name)`` splits them.  The
    loss and the gradients are :func:`make_train_step`'s (remat "full").
    The gradients are synced a reference leaf at a time, as the reference
    syncs its pytree: the layers a leaf stacks are stacked
    (:func:`~repro_torch.weights.jax_leaf_groups`), so the collective's
    segments, block scales and order of additions are the reference's.  Each
    leaf goes through :func:`topoopt_psum_fn`'s collective for ``schedule``
    and is divided by the axis size, or, with a ``compressor``
    (:class:`~repro_torch.parallel.compression.Compressor`; ring only, so
    ``schedule`` is not read), through its error-feedback sync, whose
    residual (:func:`init_compressor_residual`) the step takes and returns;
    else ``residual`` passes through.  The update is in place.  At world
    size 1 the step equals :func:`make_train_step`'s update to the bit.
    """
    axis = mesh.axis(axis_name)
    n = mesh.shape[axis_name]
    sync = topoopt_psum_fn(tuple(ring_strides), axis, schedule=schedule, group_size=n)
    groups = None

    def stack(tensors: dict) -> dict:
        return {path: torch.stack([tensors[k] for k in names]) for path, names in groups.items()}

    def split(stacked: dict) -> dict:
        return {k: t for path, names in groups.items()
                for k, t in zip(names, stacked[path].unbind(0))}

    def step(model, opt_state, batch, step_idx: int, residual=None):
        nonlocal groups
        rows = {k: v.shape[0] for k, v in batch.items()}
        if any(r % n for r in rows.values()):
            raise ValueError(f"global batch rows {rows} do not split over {n} ranks")
        pos = axis.index
        local = {k: v[pos * (v.shape[0] // n):(pos + 1) * (v.shape[0] // n)]
                 for k, v in batch.items()}
        total, _, params, grads = loss_and_grads(model, local, cfg, remat="full")
        if groups is None:
            groups = jax_leaf_groups(cfg, params)
        if compressor is not None:
            leaves, residual = compressor.sync(stack(grads), stack(residual), axis, ring_strides)
            grads, residual = split(leaves), split(residual)
        else:
            grads = split({path: sync(g) / n for path, g in stack(grads).items()})
        optimizer.update(grads, opt_state, params, step_idx)
        return model, opt_state, psum(total, axis) / n, residual

    return step


def init_compressor_residual(compressor, model) -> dict:
    """This rank's residual: an fp32 zero tensor of each parameter's shape
    (its slice of the reference's (n_devices, *shape) leaves)."""
    return compressor.init_residual(dict(model.named_parameters()))
