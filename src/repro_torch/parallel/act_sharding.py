"""Activation sharding and the ``"model"`` axis's collectives
(``repro.parallel.act_sharding``'s counterpart).

The reference constrains activations at block boundaries (GSPMD hints,
``with_sharding_constraint``) and lets the partitioner insert the
collectives its tensor-, sequence- and expert-parallel rules imply.  The
port writes them out (``train.steps.jit_train_step``): each rank computes on
plain local tensors, its own rows of the batch, and under a ``"model"``
axis of more than one rank its own heads, MLP columns, experts, channels
and vocabulary rows, reading those weights as its block
(``parallel.sharding.model_reads``).  The residual stream between blocks is
whole and the same on every model rank, or under sequence parallelism
(``ActivationPolicy.seq``) the rank's share of the sequence.  The layers
change its layout where they enter and leave their split compute:

* ``constrain(x, "btf")``: the stream -> the input of column-parallel
  products, the full sequence on every model rank (:func:`enter`, or under
  sequence parallelism :func:`gather_seq`);
* ``constrain(y, "btd", partial=True)``: a row-parallel product's addend
  on this rank -> the stream (:func:`reduce`, or :func:`scatter_seq`);
* ``constrain(x, "btd")``: a tensor whole and the same on every model rank
  (an input, or a layer computed whole) -> the stream (``x``, or this
  rank's share of the sequence);
* ``constrain(x, "whole")``: the stream -> whole on every model rank, for a
  layer computed whole (``x``, or an all-gather along the sequence whose
  backward keeps this rank's share).

The collectives are autograd functions over the model axis's process group:
its ranks in rank order are the model ranks in order, as the parameters'
``DeviceMesh`` places their blocks.  With no policy, or a model axis of one
rank, every one of them returns ``x`` itself, so world size 1 is
:func:`~repro_torch.train.steps.make_train_step` to the bit.

:func:`gather_batch` is what the MoE layer needs of the data axes: its
capacity, its drops and its aux loss are functions of the global batch, so
under a policy whose data axes span more than one rank it gathers the rows
of every data rank, with a gradient, and keeps its own.

The policy is process-global, as in the reference (models are functions of
(params, batch)); the step installs it for its own duration
(:func:`using_policy`), so none outlives the step.

Serving (``train.steps.jit_serve_step``) adds the KV caches' layout: a
cache leaf named in ``ActivationPolicy.cache_seq`` holds, on each model
rank, every KV head over the rank's share of its positions
(flash-decoding).  :func:`cache_share` says which share; prefill moves its
keys and values there (:func:`all_to_all`), and a decode step's attention
combines the ranks' shares (``models.layers.attention_decode``).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from .sharding import WHOLE, Read, data_position


@dataclass(frozen=True)
class ActivationPolicy:
    dp: tuple | str | None  # axes for the batch dim
    tp: str | None  # axis for feature/head dims
    seq: str | None = None  # axis for the sequence dim (sequence parallelism)
    mesh: object = None  # the port's Mesh: its axes' ranks and groups
    # parameter name -> how a placed model reads it (sharding.model_reads);
    # train.steps.activation_policy fills it for every parameter
    reads: dict = field(default_factory=dict)
    # cache leaves ("k", "xk") whose sequence is split over ``tp``
    cache_seq: frozenset = frozenset()


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


# --- the model axis ----------------------------------------------------------


def model_size() -> int:
    """The model axis's rank count under the installed policy; 1 without one."""
    pol = _POLICY
    if pol is None or pol.tp is None or pol.mesh is None:
        return 1
    return pol.mesh.shape[pol.tp]


def model_rank() -> tuple[int, int]:
    """(this rank's position on the model axis, its rank count): the
    position among the axis's ranks in rank order, which is the order of
    its process group and of the parameters' ``DeviceMesh``; (0, 1) without
    a policy or a model axis."""
    n = model_size()
    if n == 1:
        return 0, 1
    axis = _POLICY.mesh.axis(_POLICY.tp)
    return sorted(axis.ranks).index(dist.get_rank()), n


def seq_parallel() -> bool:
    """Whether the residual stream holds this rank's share of the sequence."""
    return _POLICY is not None and _POLICY.seq is not None and model_size() > 1


def cache_share(name: str) -> tuple[int, int]:
    """(this rank's share, the number of shares) of the positions of cache
    leaf ``name`` (``"k"`` for self-attention, ``"xk"`` for the image's):
    (its model position, the model axis's rank count) where the installed
    policy splits that cache's sequence over the model axis, else (0, 1)."""
    if model_size() == 1 or name not in _POLICY.cache_seq:
        return 0, 1
    return model_rank()


def read_of(name: str) -> Read:
    """How a placed model reads parameter ``name`` under the installed
    policy: whole, without one or over a model axis of one rank.  Raises
    where the policy has no read of it (one not built by
    ``train.steps.activation_policy``)."""
    pol = _POLICY
    if pol is None or model_size() == 1:
        return WHOLE
    if name not in pol.reads:
        raise KeyError(f"{name}: the activation policy has no read of it; build the policy "
                       "with train.steps.activation_policy(plan, mesh, cfg)")
    return pol.reads[name]


def reads_block(module, name: str) -> bool:
    """Whether ``module.<name>`` reads as this model rank's block of it
    (``parallel.sharding.place`` and the policy's reads): the layers compute
    on their own heads, columns, experts or channels where it does."""
    plist = getattr(module, "parametrizations", None)
    if plist is None or name not in plist:
        return False
    return read_of(plist[name][0].name).dim is not None


class _Axis:
    """The model axis as the collectives see it: its process group, its
    rank count and this rank's position; taken at the forward, so a
    backward runs on the forward's axis."""

    def __init__(self):
        self.index, self.size = model_rank()
        self.group = _POLICY.mesh.axis(_POLICY.tp).group

    def gather(self, x, dim: int):
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def reduce_scatter(self, x, dim: int):
        x = x.movedim(dim, 0).contiguous()
        out = x.new_empty((x.shape[0] // self.size,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=self.group)
        return out.movedim(0, dim)

    def all_reduce(self, x):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=self.group)
        return x

    def all_to_all(self, x):
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out

    def own(self, x, dim: int):
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.index * n, n)


class _Enter(torch.autograd.Function):
    """Identity forward, all-reduce backward: the start of a column-parallel region."""

    @staticmethod
    def forward(ctx, x):
        ctx.axis = _Axis()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.all_reduce(grad)


class _Reduce(torch.autograd.Function):
    """All-reduce forward, identity backward: the end of a row-parallel product."""

    @staticmethod
    def forward(ctx, x):
        return _Axis().all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _GatherSeq(torch.autograd.Function):
    """All-gather along ``dim`` forward, reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.axis, ctx.dim = _Axis(), dim
        return ctx.axis.gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.reduce_scatter(grad, ctx.dim), None


class _ScatterSeq(torch.autograd.Function):
    """Reduce-scatter along ``dim`` forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.axis, ctx.dim = _Axis(), dim
        return ctx.axis.reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.gather(grad, ctx.dim), None


class _ReplicateSeq(torch.autograd.Function):
    """All-gather along ``dim`` forward for a consumer that computes the
    same on every model rank; the backward keeps this rank's share of the
    (equal) gradients."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.axis, ctx.dim = _Axis(), dim
        return ctx.axis.gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.own(grad, ctx.dim).contiguous(), None


class _SplitSeq(torch.autograd.Function):
    """This rank's share along ``dim`` forward; the backward all-gathers the
    shares' gradients, so every model rank gets the whole gradient."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.axis, ctx.dim = _Axis(), dim
        return ctx.axis.own(x, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.gather(grad, ctx.dim), None


def enter(x):
    """Identity forward, all-reduce over the model axis backward."""
    return x if model_size() == 1 else _Enter.apply(x)


def reduce(x):
    """All-reduce over the model axis forward, identity backward."""
    return x if model_size() == 1 else _Reduce.apply(x)


def gather_seq(x, dim: int = 1):
    """The model ranks' shares along ``dim`` concatenated in order, forward;
    reduce-scatter backward."""
    return x if model_size() == 1 else _GatherSeq.apply(x, dim)


def scatter_seq(x, dim: int = 1):
    """The sum over the model ranks, this rank's share of it along ``dim``,
    forward; all-gather backward."""
    return x if model_size() == 1 else _ScatterSeq.apply(x, dim)


def all_reduce_max(x):
    """The elementwise max over the model ranks of ``x``, which carries no
    gradient (a softmax's shift)."""
    if model_size() == 1:
        return x
    x = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=_Axis().group)
    return x


def all_to_all(x):
    """``x``: (n, ...), one piece for each model rank in order, the model
    axis's n ranks -> (n, ...), piece r the one model rank r sent this rank
    (no gradient)."""
    return x if model_size() == 1 else _Axis().all_to_all(x)


def seq_share(x, dim: int = 1):
    """This rank's share of the sequence of an input that needs no gradient
    (tokens, targets, masks) under sequence parallelism; else ``x``."""
    return _Axis().own(x, dim) if seq_parallel() else x


def constrain(x, kind: str, partial: bool = False):
    """``x`` in the layout of activation kind ``kind`` over the model axis.

    kinds: 'btd' (the residual stream: batch, sequence, features; from a
    row-parallel addend with ``partial``, else from a tensor whole on every
    model rank), 'btf' (from the stream, the input of column-parallel
    products: batch, the whole sequence, features to be split), 'whole'
    (from the stream, whole on every model rank).  'bd', 'ecd', 'nd' and
    unknown kinds, no policy, or a model axis of one rank: ``x`` as it is.
    See the module's docstring."""
    if model_size() == 1:
        return x
    sp = seq_parallel()
    if sp and kind in ("btd", "btf", "whole") and x.dim() != 3:
        # A (B, d_model) decode tensor has no sequence: dim 1 is its features.
        raise ValueError(f"sequence parallelism splits dim 1 of (B, S, D); got {tuple(x.shape)}")
    if kind == "btd":
        if partial:
            return scatter_seq(x) if sp else reduce(x)
        return _SplitSeq.apply(x, 1) if sp else x
    if kind == "btf":
        return gather_seq(x) if sp else enter(x)
    if kind == "whole":
        return _ReplicateSeq.apply(x, 1) if sp else x
    return x


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
