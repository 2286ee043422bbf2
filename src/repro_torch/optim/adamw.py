"""Optimizers on named tensors (``repro.optim.adamw``'s counterpart).

State is a dict of name -> tensor maps keyed by ``named_parameters()``
names: ``"m"``, ``"v"`` and, for bf16/fp16 parameters, an fp32
``"master"`` copy (fp32 parameters are their own master); ``"mom"`` for
SGD.  ``update(grads, state, params, step)`` follows the reference's
arithmetic but runs leaf by leaf in place under ``torch.no_grad``, so an
update adds no full copy of the state (minicpm-2b's is 43.6 GB): only a
few fp32 temporaries of the leaf at hand.  AdamW updates a leaf of more
than ``SLICE_ELEMENTS`` elements (DLRM's tables: 2.56e9 at 2 tables) slice
by slice along dim 0 of its flattened view, so those temporaries stay near
1 GB; every element sees the same arithmetic, so the result is bitwise the
whole leaf's.  It returns ``(params, state)``, the same objects.

Parameters may be DTensors (``train.steps.jit_train_step``): ``init`` makes
each state tensor in its parameter's placements (``zeros_like``), and
AdamW's ``update`` runs on the ``to_local()`` shards of the parameter, its
gradient, moments and master, which must share placements.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor


# AdamW's largest slice of a leaf: 2**28 fp32 elements, 1.07 GB a temporary.
SLICE_ELEMENTS = 2**28


class Optimizer(NamedTuple):
    init: Callable  # (params) -> state
    update: Callable  # (grads, state, params, step) -> (params, state), in place


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view: writes reach the DTensor), else ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def _needs_master(p) -> bool:
    return p.dtype in (torch.bfloat16, torch.float16)


def adamw(
    lr_fn: Callable[[int], float],
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    master_fp32: bool = True,
) -> Optimizer:
    @torch.no_grad()
    def init(params):
        state = {
            "m": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
            "v": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
        }
        if master_fp32:
            state["master"] = {n: p.detach().float() if _needs_master(p) else p.detach()
                               for n, p in params.items()}
        return state

    def update_leaf(lr, c1, c2, g, m, v, src, p):
        g = g.float()
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).add_(g * g, alpha=1 - b2)
        pf = src if src.dtype == torch.float32 else src.float()
        step_vec = (m / c1).div_((v / c2).sqrt_().add_(eps)).add_(pf, alpha=weight_decay)
        pf.sub_(step_vec.mul_(lr))
        if pf is not src:
            src.copy_(pf)
        if src.data_ptr() != p.data_ptr():
            p.copy_(pf)

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = lr_fn(step)
        t = float(step + 1)
        c1 = 1.0 - b1**t
        c2 = 1.0 - b2**t
        for name, p in params.items():
            # The master (the parameter itself where it is fp32) updates in
            # place; a bf16/fp16 parameter without one goes through an fp32 copy.
            src = state["master"][name] if "master" in state else p.detach()
            leaf = tuple(_local(x) for x in
                         (grads[name], state["m"][name], state["v"][name], src, p.detach()))
            n = leaf[-1].numel()
            if n > SLICE_ELEMENTS:
                flat = [leaf[0].reshape(-1)] + [x.view(-1) for x in leaf[1:]]
                for i in range(0, n, SLICE_ELEMENTS):
                    update_leaf(lr, c1, c2, *(x[i:i + SLICE_ELEMENTS] for x in flat))
            else:
                update_leaf(lr, c1, c2, *leaf)
        return params, state

    return Optimizer(init=init, update=update)


def sgd_momentum(lr_fn: Callable[[int], float], momentum: float = 0.9) -> Optimizer:
    @torch.no_grad()
    def init(params):
        return {"mom": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = lr_fn(step)
        for name, p in params.items():
            m = state["mom"][name].mul_(momentum).add_(grads[name].float())
            p.copy_(p.float() - lr * m)
        return params, state

    return Optimizer(init=init, update=update)


@torch.no_grad()
def apply_updates(params, updates):
    """``params[n] = (params[n] + updates[n])`` cast to the parameter's
    dtype, in place; returns ``params``."""
    for name, p in params.items():
        p.copy_(p + updates[name])
    return params
