"""Activation sharding (``repro.parallel.act_sharding``'s counterpart).

The reference constrains activations to batch-over-data at block
boundaries (GSPMD hints, ``with_sharding_constraint``), so the partitioner
all-gathers the small layer weights and keeps the activations sharded.  The
port writes that schedule out (``train.steps.jit_train_step``): each rank
computes on plain local tensors, its own rows of the batch, with every
weight gathered whole.  :func:`constrain` is kept for the slice that
computes over ``"model"``: on a DTensor it redistributes to the kind's
placements, on a plain tensor it returns it, as the reference does outside
a mesh.  The models do not call it yet.

:func:`gather_batch` is what the MoE layer needs of the policy now: its
capacity, its drops and its aux loss are functions of the global batch, so
under a policy whose data axes span more than one rank it gathers the rows
of every data rank, with a gradient, and keeps its own.

The policy is process-global, as in the reference (models are functions of
(params, batch)); the step installs it for its own duration
(:func:`using_policy`), so none outlives the step.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .sharding import data_position, placements


@dataclass(frozen=True)
class ActivationPolicy:
    dp: tuple | str | None  # axes for the batch dim
    tp: str | None  # axis for feature/head dims
    seq: str | None = None  # axis for the sequence dim (sequence parallelism)
    mesh: object = None  # the port's Mesh: its axes' ranks and groups


_POLICY: ActivationPolicy | None = None


def set_policy(policy: ActivationPolicy | None) -> None:
    global _POLICY
    _POLICY = policy


def get_policy() -> ActivationPolicy | None:
    return _POLICY


@contextlib.contextmanager
def using_policy(policy: ActivationPolicy | None):
    """``policy`` installed for the block, the previous one after it."""
    before = get_policy()
    set_policy(policy)
    try:
        yield policy
    finally:
        set_policy(before)


def _spec(pol: ActivationPolicy, kind: str):
    return {"btd": (pol.dp, pol.seq, None), "bd": (pol.dp, None),
            "btf": (pol.dp, pol.seq, pol.tp), "ecd": (pol.tp, None, None),
            "nd": (pol.dp, None)}.get(kind)


def constrain(x, kind: str):
    """Redistribute a DTensor ``x`` by activation kind.

    kinds: 'btd' (batch, seq, features), 'bd' (batch, features),
    'btf' (batch, seq, sharded features), 'ecd' (expert, capacity, features),
    'nd' (flattened tokens, features).  A plain tensor, or no policy, or an
    unknown kind: ``x`` as it is."""
    from torch.distributed.tensor import DTensor

    pol = _POLICY
    spec = None if pol is None else _spec(pol, kind)
    if spec is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


class _GatherRows(torch.autograd.Function):
    """The rows of every rank on a mesh axis, in mesh order; the backward
    reduce-scatters the gradient, so each rank gets the sum over the ranks
    of its own rows' gradients.  A process group orders its ranks by global
    rank, which a reordered mesh axis need not."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        parts = [torch.empty_like(x) for _ in axis.ranks]
        dist.all_gather(parts, x.contiguous(), group=axis.group)
        by_rank = dict(zip(sorted(axis.ranks), parts))
        return torch.cat([by_rank[r] for r in axis.ranks], dim=0)

    @staticmethod
    def backward(ctx, grad):
        axis = ctx.axis
        by_rank = dict(zip(axis.ranks, grad.contiguous().chunk(len(axis.ranks))))
        out = torch.empty_like(by_rank[axis.ranks[0]])
        dist.reduce_scatter_tensor(out, torch.cat([by_rank[r] for r in sorted(axis.ranks)]),
                                   group=axis.group)
        return out, None


def gather_batch(x: torch.Tensor) -> tuple[torch.Tensor, slice]:
    """-> (the global batch's rows of ``x``, this rank's rows in it).

    Under a policy whose data axes span more than one rank, ``x`` (this
    rank's rows on dim 0) is gathered over them, inner axis first, so the
    rows come in the global batch's order (pod major, as ``P(("pod",
    "data"))`` splits them).  Otherwise ``x`` and all its rows."""
    pol = _POLICY
    if pol is None or pol.mesh is None or pol.dp is None:
        return x, slice(None)
    names = [a for a in ((pol.dp,) if isinstance(pol.dp, str) else pol.dp)
             if pol.mesh.shape[a] > 1]
    if not names:
        return x, slice(None)
    b = x.shape[0]
    for name in reversed(names):
        x = _GatherRows.apply(x, pol.mesh.axis(name))
    pos, _ = data_position(pol.mesh, names)
    return x, slice(pos * b, (pos + 1) * b)
