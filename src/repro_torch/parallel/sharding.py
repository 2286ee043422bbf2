"""Sharding plans -> partition specs -> DTensor placements
(``repro.parallel.sharding``'s counterpart).

DP/FSDP over the ``data`` (and ``pod``) axes, TP/EP over ``model``; sequence
dims of long caches shard over ``model`` (flash-decoding style).  Every spec
is sanitized against actual divisibility (e.g. minicpm's prime vocab 122753
cannot shard over 16: the rule falls back to the next dim) so a single rule
set covers every architecture.

A spec is a plain tuple in ``PartitionSpec`` form, one entry a tensor dim:
``None``, an axis name, or a tuple of names.  The rules read only a mesh's
``axis_names`` and ``shape`` (a dict of axis sizes), so they run on a
:class:`~repro_torch.core.device_order.Mesh` or on any stand-in with those
two attributes.  The port keeps one parameter a layer
(``blocks.3.attn.wq``) where the reference stacks layers along leading
dims, so a port spec is the reference's with its leading stacking ``None``s
dropped; rules match on the last one or two names of the dotted path, as
the reference's ``_path_names`` does, and an optimizer-state path
(``m``/``v``/``master``, then the parameter's name) resolves by the
parameter it carries.

:func:`placements` turns a spec into one DTensor placement a mesh dim, and
:class:`Layout` pairs them with a ``DeviceMesh`` (``NamedSharding``'s
counterpart).  :func:`place` shards a module's parameters into DTensors
and has each one gathered where the model reads it: over the data axes
only, as this model rank's block, where :func:`model_reads` says the layer
computes on its own heads, columns, experts, channels or vocabulary rows,
else whole (see :mod:`repro_torch.parallel.act_sharding` and
:mod:`repro_torch.train.steps`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..configs.base import ArchConfig


@dataclass(frozen=True)
class ShardingPlan:
    """How a job is laid out on the mesh (the Comp x Comm plane choice)."""

    fsdp: bool = True          # ZeRO-3: shard params/opt-state over data axes
    zero1: bool = False        # ZeRO-1: replicate params, shard opt state
    seq_parallel: bool = False  # shard activation sequence dim over "model"
    # TopoOpt integration: collective schedule from the co-optimizer
    # (the searched ``Strategy.schedule`` family plus its ring strides).
    ring_strides: tuple[int, ...] = ()
    schedule: str = "ring"
    remat: str = "full"
    loss_chunk: int = 0

    def dp_axes(self, mesh):
        axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        return axes if len(axes) > 1 else (axes[0] if axes else None)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return math.prod(mesh.shape[a] for a in axes)


def sanitize(spec: tuple, shape: tuple[int, ...], mesh) -> tuple:
    """Drop axes whose size does not divide the corresponding dim."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for d, axes in zip(shape, dims):
        size = _axis_size(mesh, axes)
        out.append(None if axes is None or size == 0 or d % size != 0 else axes)
    return tuple(out)


# --- parameter rules --------------------------------------------------------

# (context, name) -> base spec expressed with symbolic axes:
#   "tp"   -> "model"; "fsdp" -> data axes (if plan.fsdp)
# The reference's extra leading (layer stacking) dims have no counterpart:
# the port's parameters are per layer.
_PARAM_RULES: list[tuple[tuple[str, ...], tuple]] = [
    (("embed",), ("tp", "fsdp")),
    (("lm_head",), ("fsdp", "tp")),
    (("moe", "router"), ("fsdp", None)),
    (("moe", "wg"), ("tp", "fsdp", None)),
    (("moe", "wu"), ("tp", "fsdp", None)),
    (("moe", "wd"), ("tp", None, "fsdp")),
    (("wq",), ("fsdp", "tp")),
    (("wk",), ("fsdp", "tp")),
    (("wv",), ("fsdp", "tp")),
    (("wo",), ("tp", "fsdp")),
    (("wg",), ("fsdp", "tp")),
    (("wu",), ("fsdp", "tp")),
    (("wd",), ("tp", "fsdp")),
    (("w1",), ("fsdp", "tp")),
    (("w2",), ("tp", "fsdp")),
    (("w_in",), ("fsdp", "tp")),
    (("w_x",), ("fsdp", "tp")),
    (("w_y",), ("fsdp", "tp")),
    (("w_xdbc",), ("tp", None)),
    (("w_dt",), (None, "tp")),
    (("w_input_gate",), ("tp", None)),
    (("w_rec_gate",), ("tp", None)),
    (("w_out",), ("tp", "fsdp")),
    (("conv_w",), (None, "tp")),
    (("conv_b",), ("tp",)),
    (("a_log",), ("tp", None)),
    (("d_skip",), ("tp",)),
    (("b_dt",), ("tp",)),
    (("lambda_p",), ("tp",)),
    (("tables",), (None, "tp", None)),
]


def _shape(leaf) -> tuple[int, ...]:
    """A leaf's shape: a tensor's, or the first entry of a ``(shape, dtype)``
    pair (``configs.base.input_specs``, ``models.lm.param_specs``)."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf[0])


def _map_tree(fn, tree, path: tuple[str, ...] = ()):
    """``fn(names, leaf)`` over a dict tree, ``names`` the keys on the way
    down split on dots."""
    return {k: _map_tree(fn, v, path + tuple(k.split(".")))
            if isinstance(v, dict) else fn(path + tuple(k.split(".")), v)
            for k, v in tree.items()}


def _resolve(sym, plan: ShardingPlan, mesh, for_params: bool):
    if sym == "tp":
        return "model" if "model" in mesh.axis_names else None
    if sym == "fsdp":
        if for_params and not plan.fsdp:
            return None
        return plan.dp_axes(mesh)
    return sym


def param_spec_tree(param_shapes: dict, plan: ShardingPlan, mesh, for_params: bool = True):
    """A spec for every leaf of ``param_shapes`` (a dict tree of tensors or
    ``(shape, dtype)`` pairs keyed by dotted parameter names)."""

    def one(names, leaf):
        shape = _shape(leaf)
        for key, base in _PARAM_RULES:
            if names[-len(key):] == key and len(shape) >= len(base):
                # A leaf of more dims than its rule (DLRM's tables alone)
                # keeps the reference's leading Nones.
                resolved = tuple(_resolve(s, plan, mesh, for_params) for s in base)
                return sanitize((None,) * (len(shape) - len(base)) + resolved, shape, mesh)
        return (None,) * len(shape)  # replicate what no rule names

    return _map_tree(one, param_shapes)


def opt_state_sharding(opt_shapes: dict, plan: ShardingPlan, mesh):
    """Optimizer moments follow the parameters; under ZeRO-1 the moments are
    sharded over data even when the params are replicated."""
    if plan.zero1:
        plan = ShardingPlan(fsdp=True, zero1=True, seq_parallel=plan.seq_parallel,
                            ring_strides=plan.ring_strides, schedule=plan.schedule,
                            remat=plan.remat, loss_chunk=plan.loss_chunk)
    return param_spec_tree(opt_shapes, plan, mesh, for_params=True)


# --- batch / cache rules -----------------------------------------------------


def batch_spec_tree(batch_shapes: dict, cfg: ArchConfig, plan: ShardingPlan, mesh):
    dp = plan.dp_axes(mesh)
    tp = "model" if "model" in mesh.axis_names else None
    seq = tp if plan.seq_parallel else None

    def cache_spec(name: str, shape):
        if name in ("ssm",):  # (L, B, DI, ST)
            return sanitize((None, dp, tp, None), shape, mesh)
        if name in ("conv",):  # (L, B, W, DI)
            return sanitize((None, dp, None, tp), shape, mesh)
        if name in ("lru",):  # (L, B, DI)
            return sanitize((None, dp, tp), shape, mesh)
        if name in ("k", "v", "xk", "xv"):  # (L, B, KV, S, D)
            # Batch over dp, cache sequence over model (flash-decoding).
            return sanitize((None, dp, None, tp, None), shape, mesh)
        return (None,) * len(shape)

    def one(names, leaf):
        shape = _shape(leaf)
        name = names[-1]
        if "cache" in names:
            return cache_spec(name, shape)
        if name in ("tokens", "labels"):  # (B, S)
            return sanitize((dp, seq), shape, mesh)
        if name == "frames":  # (B, S, D)
            return sanitize((dp, seq, None), shape, mesh)
        if name == "image_embeds":  # (B, T, D)
            return sanitize((dp, None, None), shape, mesh)
        if name == "token":  # (B,)
            return sanitize((dp,), shape, mesh)
        if name == "pos":
            return ()
        if name in ("dense", "sparse", "label"):
            return sanitize((dp,) + (None,) * (len(shape) - 1), shape, mesh)
        return (None,) * len(shape)

    return _map_tree(one, batch_shapes)


def data_axes(plan: ShardingPlan, mesh) -> tuple[str, ...]:
    """The plan's data axes on ``mesh`` as a tuple (pod first)."""
    dp = plan.dp_axes(mesh)
    return () if dp is None else (dp,) if isinstance(dp, str) else tuple(dp)


def data_position(mesh, names) -> tuple[int, int]:
    """(this rank's position over the axes ``names``, their rank count),
    the first axis major, as ``P(("pod", "data"))`` splits a dim; ``mesh``
    is the port's ``Mesh``."""
    pos, n = 0, 1
    for name in names:
        pos = pos * mesh.shape[name] + mesh.axis(name).index
        n *= mesh.shape[name]
    return pos, n


# --- specs -> DTensor placements ---------------------------------------------


def _mesh_axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "axis_names", None) or getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError(f"{mesh!r} names no axes")
    return tuple(names)


def placements(spec: tuple, mesh) -> tuple:
    """One DTensor placement a mesh dim: ``Shard(d)`` where tensor dim ``d``
    is split over that axis, else ``Replicate()``.  A dim over a tuple of
    axes is ``Shard(d)`` on each of them, which DTensor applies in mesh order
    (pod major, as ``P(("pod", "data"))``); a tuple against the mesh's order
    has no plain placement and raises.  ``mesh`` names its axes as
    ``axis_names`` (the port's ``Mesh``) or ``mesh_dim_names`` (a
    ``DeviceMesh``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = _mesh_axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {axes} is not in the mesh's axis order {names}")
        for i in dims:
            out[i] = Shard(d)
    return tuple(out)


class Layout(NamedTuple):
    """A DTensor's place: its ``DeviceMesh`` and one placement a mesh dim
    (the port's ``NamedSharding``)."""

    mesh: object
    placements: tuple


def layouts(spec_tree: dict, device_mesh) -> dict:
    """``spec_tree`` with each spec turned into a :class:`Layout` on ``device_mesh``."""
    return {k: layouts(v, device_mesh) if isinstance(v, dict)
            else Layout(device_mesh, placements(v, device_mesh))
            for k, v in spec_tree.items()}


# --- the device mesh ---------------------------------------------------------


def ascending_grid(grid) -> np.ndarray:
    """``grid`` with each axis's lines put in ascending rank order, one
    permutation an axis: the same lines, as sets, as ``grid`` has.  Raises
    where an axis's lines are permuted differently (no ``topoopt_mesh``
    makes such a grid)."""
    grid = np.asarray(grid)
    for a in range(grid.ndim):
        orders = np.argsort(np.moveaxis(grid, a, -1), axis=-1).reshape(-1, grid.shape[a])
        if not (orders == orders[0]).all():
            raise ValueError(f"the lines of axis {a} of {grid.tolist()} are not one permutation")
        grid = np.take(grid, orders[0], axis=a)
    return grid


def device_mesh(mesh, device: torch.device):
    """The ``DeviceMesh`` of the port's :class:`Mesh`: its axis names, and
    its grid with each axis in ascending rank order (:func:`ascending_grid`).
    DTensor gathers a mesh dim's shards in its process group's order, which
    is by rank, and places them by mesh coordinate, so a TopoOpt-reordered
    axis (``device_order.topoopt_mesh``) would put them out of order.  The
    parameters' shards follow the ``DeviceMesh``; the batch's rows follow
    the port's mesh.  Every rank must build it, in the same order, as with
    any ``new_group``.  A ``meta`` device (the dry run's stand-in for the
    card) gets a CPU mesh, whose shards stay on ``meta``: DTensor asks a
    mesh's device module for its device count, and ``meta`` has none."""
    from torch.distributed.device_mesh import DeviceMesh

    kind = "cpu" if device.type == "meta" else device.type
    return DeviceMesh(kind, ascending_grid(mesh.devices), mesh_dim_names=mesh.axis_names)


# --- sharded parameters -------------------------------------------------------


def shard(t: torch.Tensor, layout: Layout):
    """``t`` (the whole tensor, the same on every rank) as a DTensor of
    ``layout``; the local shard is a tensor of its own, so ``t`` can be freed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    d = distribute_tensor(t.detach(), layout.mesh, layout.placements, src_data_rank=None)
    local = d.to_local()
    if local.untyped_storage().nbytes() != local.numel() * local.element_size():
        local = local.clone()
    return DTensor.from_local(local, layout.mesh, layout.placements, run_check=False,
                              shape=d.shape, stride=d.stride())


class Read(NamedTuple):
    """How a layer reads a placed parameter under a model axis of more than
    one rank.  ``dim`` not None: this model rank's block along that dim (the
    dim its spec splits over ``"model"``), gathered over the data axes only;
    its gradient is exact and stays a shard.  ``dim`` None: the parameter
    whole; ``reduce`` says how its gradient adds up over the model ranks,
    ``"avg"`` where every model rank uses all of it (each holds the whole
    gradient) and ``"sum"`` where each uses a part (a norm on the rank's
    share of the sequence, the one K/V head of its query heads)."""

    dim: int | None = None
    reduce: str = "avg"


WHOLE = Read()


def _attention_split(n_heads: int, n_kv_heads: int, tp: int) -> str | None:
    """How attention splits over ``tp`` model ranks: ``"kv"``, query and KV
    heads both (each rank its own of each); ``"q"``, query heads only, where
    every rank's query heads share one KV head, which it computes from
    ``wk``/``wv`` read whole; None, computed whole (heads that do not divide,
    or a rank's query heads across KV heads)."""
    if tp == 1 or n_heads % tp:
        return None
    if n_kv_heads % tp == 0:
        return "kv"
    return "q" if (n_heads // n_kv_heads) % (n_heads // tp) == 0 else None


_CHANNELS = {"conv_w": 1, "conv_b": 0, "w_xdbc": 0, "w_dt": 1, "b_dt": 0, "a_log": 0,
             "d_skip": 0, "w_x": 1, "w_y": 1, "w_input_gate": 0, "w_rec_gate": 0,
             "lambda_p": 0, "w_out": 0}
_STREAM = ("norm", "xnorm", "final_norm", "gate")


def model_reads(cfg: ArchConfig, p_specs: dict, plan: ShardingPlan, mesh) -> dict:
    """name -> :class:`Read` for every parameter of ``p_specs`` (name ->
    ``(shape, dtype)``) on ``mesh``: the reference's tensor-, sequence- and
    expert-parallel compute.  A block read where the spec's ``"model"``
    split falls on whole units: attention heads (:func:`_attention_split`),
    MLP columns, experts, Mamba and RG-LRU channels, vocabulary rows (the
    embedding's and the head's, tied or not).  Read whole: ``w_in`` (its x
    and z halves are each split; summed), K/V with fewer heads than ranks
    (summed), the router, and the weights of a layer whose units do not
    divide; norms, the cross gates and a split MoE's router are summed under
    sequence parallelism, where each rank applies them to its share.  Raises where a block read's
    dim is not split over ``"model"`` by the plan's specs."""
    tp = mesh.shape["model"] if "model" in mesh.axis_names else 1
    if tp == 1:
        return {n: WHOLE for n in p_specs}
    stream = Read(reduce="sum") if plan.seq_parallel else WHOLE
    heads = _attention_split(cfg.n_heads, cfg.n_kv_heads, tp)
    by_unit = {
        "vocab": cfg.vocab % tp == 0,
        "ff": cfg.d_ff % tp == 0,
        "experts": cfg.n_experts > 0 and cfg.n_experts % tp == 0,
        "channels": cfg.d_inner % tp == 0,
    }

    def one(name: str) -> Read:
        path = name.split(".")
        leaf, ctx = path[-1], path[-2] if len(path) > 1 else ""
        if leaf == "embed":
            return Read(0) if by_unit["vocab"] else stream
        if leaf == "lm_head":
            return Read(1) if by_unit["vocab"] else stream
        if leaf in _STREAM:
            return stream
        if ctx == "moe":
            if leaf == "router":  # every rank routes its share of the stream
                return stream if by_unit["experts"] else WHOLE
            return Read(0) if by_unit["experts"] else WHOLE
        if ctx == "attn":
            if heads is None:
                return WHOLE
            if leaf in ("wk", "wv") and heads == "q":
                return Read(reduce="sum")
            return Read(0 if leaf == "wo" else 1)
        if ctx == "mlp":
            return Read(0 if leaf in ("wd", "w2") else 1) if by_unit["ff"] else WHOLE
        if leaf == "w_in":
            return Read(reduce="sum") if by_unit["channels"] else WHOLE
        if leaf in _CHANNELS:
            return Read(_CHANNELS[leaf]) if by_unit["channels"] else WHOLE
        return WHOLE

    reads = {n: one(n) for n in p_specs}
    specs = param_spec_tree(p_specs, plan, mesh)
    for n, r in reads.items():
        if r.dim is not None and specs[n][r.dim] != "model":
            raise ValueError(f"{n}: read as a model block along dim {r.dim}, but its spec "
                             f"{specs[n]} does not split that dim over 'model'")
    return reads


class _Gather(nn.Module):
    """The parametrization that reads a DTensor parameter ``name``: by the
    installed activation policy's :class:`Read` of it
    (``act_sharding.read_of``), this model rank's block (an all-gather over
    the other mesh dims) or the whole (an all-gather over every mesh dim).
    The backward sends each gradient back to the parameter's placements:
    averaged over the data dims (a reduce-scatter over a sharded dim, an
    all-reduce over a replicated one), a shard over ``"model"`` for a block,
    and for a whole read by its ``reduce`` over ``"model"``."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name

    def forward(self, w):
        from torch.distributed.tensor import Partial, Replicate, Shard

        from .act_sharding import read_of

        read = read_of(self.name)
        names = w.device_mesh.mesh_dim_names
        if read.dim is None:
            to = [Replicate()] * len(names)
            grad = [Partial(read.reduce if a == "model" else "avg") for a in names]
        else:
            to = [Shard(read.dim) if a == "model" else Replicate() for a in names]
            grad = [Shard(read.dim) if a == "model" else Partial("avg") for a in names]
        return w.redistribute(w.device_mesh, to).to_local(grad_placements=grad)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def place(module: nn.Module, param_layouts: dict, prefix: str = "") -> nn.Module:
    """Shards every parameter of ``module`` that is not yet a DTensor into
    the :class:`Layout` of its name (``prefix`` + its name in ``module``)
    and has the module gather it where it is read
    (``torch.nn.utils.parametrize``, :class:`_Gather`), so the model's code
    and the kernels see plain tensors.  Returns ``module``."""
    from torch.nn.utils import parametrize

    # Names, not the parameters: each whole tensor is freed as soon as its
    # shard replaces it, so placing a built model holds one tensor twice at
    # most, not all of them.
    for name in [n for n, p in module.named_parameters() if not _is_dtensor(p)]:
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner)
        p = sub._parameters[leaf]
        setattr(sub, leaf, nn.Parameter(shard(p, param_layouts[prefix + name]),
                                        requires_grad=p.requires_grad))
        del p
        parametrize.register_parametrization(sub, leaf, _Gather(prefix + name), unsafe=True)
    return module


def placer(param_layouts: dict):
    """:func:`place` bound to ``param_layouts``: the hook ``models.lm.init``
    calls on each block as it builds it."""
    return lambda module, prefix: place(module, param_layouts, prefix)


def parameters(model: nn.Module) -> dict:
    """``named_parameters()`` as a dict, a :func:`place`\\ d model's DTensors
    under their plain names (``blocks.0.attn.wq``, not the parametrization's
    ``blocks.0.attn.parametrizations.wq.original``)."""
    return {n.replace("parametrizations.", "").removesuffix(".original"): p
            for n, p in model.named_parameters()}
