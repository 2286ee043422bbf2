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
* :func:`jit_train_step`: the GSPMD/FSDP trainer.  The reference writes the
  step in global terms and lets GSPMD insert the collectives its sharding
  plan implies; the port writes them out with DTensor:

  - every parameter is a DTensor in its spec's placements
    (``parallel.sharding``), gathered where the model reads it and its
    gradient sent back into those placements (averaged over the data axes:
    a reduce-scatter over a sharded dim);
  - the batch is split over the data axes: each rank computes the loss of
    its own contiguous rows, and the average over the data ranks of those
    equal shards' means is the global mean (every row of every family
    masks the same number of tokens).  The MoE layer, whose capacity,
    drops and aux loss depend on the global batch, gathers the rows of
    every data rank (``parallel.act_sharding.gather_batch``);
  - over ``"model"`` each rank computes the reference's tensor- and
    expert-parallel share (``parallel.sharding.model_reads``): its own
    attention heads, MLP columns, experts, Mamba and RG-LRU channels and
    vocabulary rows, each such weight gathered over the data axes only as
    its block, the kernels run at those local widths, and the row-parallel
    products' addends reduced over the model axis's process group
    (``parallel.act_sharding.constrain``).  A layer whose units do not
    divide the axis computes whole, from weights gathered whole.  Under
    ``plan.seq_parallel`` the residual stream between blocks holds the
    rank's share of the sequence: the norms run on it, the column-parallel
    products take it gathered, the row-parallel ones reduce-scatter it;
  - AdamW updates each rank's shards in place; under ZeRO-1 (moments and
    master sharded, parameters replicated) each rank updates the slice its
    moments own, then the parameter is all-gathered.

  At world size 1 it joins a process group of one rank and runs the same
  path, and equals :func:`make_train_step` to the bit.
* :func:`jit_serve_step`: serving under the same plan and mesh, the
  reference's sharded serve step (``repro.launch.dryrun``'s prefill and
  decode cells).  Each rank computes its rows of the batch over its share
  of ``"model"`` as the trainer does; the KV caches keep every KV head over
  the rank's share of their positions (flash-decoding: a decode step's
  attention combines the shares over ``"model"``), the recurrent states
  the rank's channels; the logits come back whole, the caches as DTensors
  in the reference's ``out_shardings``.  At world size 1 it equals
  :func:`make_serve_step` to the bit.
"""

from __future__ import annotations

import dataclasses

import torch

from ..compat import resolve_device
from ..configs.base import ArchConfig, ShapeSpec, input_specs
from ..core.collectives import psum, topoopt_psum_fn
from ..launch.mesh import one_rank_world
from ..models import lm
from ..optim import Optimizer
from ..parallel.act_sharding import ActivationPolicy, gather_batch, set_policy, using_policy
from ..parallel.sharding import (
    ShardingPlan,
    batch_spec_tree,
    data_axes,
    data_position,
    device_mesh,
    layouts,
    model_reads,
    opt_state_sharding,
    param_spec_tree,
    parameters,
)
from ..weights import jax_leaf_groups


def loss_and_grads(model, batch, cfg: ArchConfig, remat: str = "full", loss_chunk: int = 0):
    """-> (loss, metrics, params, grads): the loss (0-d, detached), the loss
    function's metrics, the parameters by name (``parallel.sharding.parameters``:
    a placed model's DTensors under their plain names), and each
    parameter's gradient by name.  Makes the parameters trainable
    (``requires_grad_``); a parameter the loss does not read gets a zero
    gradient, as ``jax.grad`` gives it."""
    model.requires_grad_(True)
    params = parameters(model)
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


# ---------------------------------------------------------------------------
# The GSPMD/FSDP trainer: a sharding plan on a mesh, through DTensor
# ---------------------------------------------------------------------------


def activation_policy(plan: ShardingPlan, mesh, cfg: ArchConfig) -> ActivationPolicy:
    """The plan's activation policy: batch over the data axes, features over
    ``"model"``, the sequence too under ``plan.seq_parallel`` (see
    ``parallel.act_sharding``), and how a placed model of ``cfg`` reads each
    parameter (``parallel.sharding.model_reads``)."""
    return ActivationPolicy(
        dp=plan.dp_axes(mesh),
        tp="model" if "model" in mesh.axis_names else None,
        seq="model" if plan.seq_parallel else None,
        mesh=mesh,
        reads=model_reads(cfg, lm.param_specs(cfg), plan, mesh),
    )


def install_activation_policy(plan: ShardingPlan, mesh, cfg: ArchConfig) -> ActivationPolicy:
    """Installs :func:`activation_policy` for the whole process, as the
    reference's does, and returns it.  :func:`jit_train_step` does not call
    it: its step installs the policy for its own duration only, so no MoE
    layer run later in the process gathers over this mesh."""
    policy = activation_policy(plan, mesh, cfg)
    set_policy(policy)
    return policy


def make_serve_step(cfg: ArchConfig, shape: ShapeSpec):
    """``serve_step(params, batch)``: ``lm.prefill`` for a prefill cell, else
    ``lm.decode_step``."""
    if shape.kind == "prefill":
        def serve_step(params, batch):
            return lm.prefill(params, batch, cfg)
        return serve_step

    def serve_step(params, batch):
        return lm.decode_step(params, batch, cfg)

    return serve_step


def contiguous_stride(shape: tuple[int, ...]) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``, worked out without
    making one (the dry run counts every tensor a step makes, meta or not)."""
    stride, n = [], 1
    for d in reversed(shape):
        stride.append(n)
        n *= d
    return tuple(reversed(stride))


def shapes_of(tree: dict) -> dict:
    """A dict tree of tensors -> the same tree of ``(shape, dtype)`` pairs."""
    return {k: shapes_of(v) if isinstance(v, dict) else (tuple(v.shape), v.dtype)
            for k, v in tree.items()}


def _state_layouts(o_layouts: dict) -> dict:
    """name -> the Layout every optimizer-state tensor of that parameter has."""
    return next(iter(o_layouts.values()))


def init_opt_state(optimizer: Optimizer, model, o_layouts: dict) -> dict:
    """``optimizer.init`` of a placed model's parameters, each state tensor in
    its ``o_layouts`` placements: the parameters' own, or under ZeRO-1 the
    moments' (the parameter is sliced, and the slice copied, into them)."""
    want = _state_layouts(o_layouts)
    with torch.no_grad():
        views = {n: p.detach() if p.placements == want[n].placements
                 else p.detach().redistribute(want[n].mesh, want[n].placements).clone()
                 for n, p in parameters(model).items()}
    return optimizer.init(views)


def jit_train_step(cfg: ArchConfig, optimizer: Optimizer, plan: ShardingPlan, mesh,
                   device=None):
    """The train step with the plan's layouts on ``mesh`` (the port's
    :class:`~repro_torch.core.device_order.Mesh` over the process group).

    Returns ``(step, (p_specs, o_specs, p_layouts, o_layouts, batch_fn))``
    in the reference's order: the parameters' and the optimizer state's
    ``(shape, dtype)`` trees, their :class:`~repro_torch.parallel.sharding.Layout`
    trees (the reference's shardings) and ``batch_fn(shape)``, a cell's
    batch layouts.  Build the model with ``lm.init(seed, cfg, device,
    place=parallel.sharding.placer(p_layouts))`` (or :func:`place` a built
    one) and its state with :func:`init_opt_state`.

    ``step(model, opt_state, batch, step_idx) -> (model, opt_state,
    metrics)`` takes the global batch (every rank the same, on ``device``)
    and computes on this rank's rows of it; ``metrics`` (``loss``,
    ``xent``, ``aux``, ``grad_norm``) are the global batch's.  ``device``:
    the card unless ``"cpu"``; without a process group the step joins one
    of one rank (NCCL on the card, gloo on the CPU).
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    device = resolve_device(device)
    one_rank_world(device)
    policy = activation_policy(plan, mesh, cfg)
    p_specs = lm.param_specs(cfg)
    o_specs = shapes_of(optimizer.init(
        {n: torch.empty(shape, dtype=dt, device="meta") for n, (shape, dt) in p_specs.items()}))
    dmesh = device_mesh(mesh, device)
    p_layouts = layouts(param_spec_tree(p_specs, plan, mesh), dmesh)
    o_layouts = layouts(opt_state_sharding(o_specs, plan, mesh), dmesh)
    state_layouts = _state_layouts(o_layouts)
    # A list: every rank must run the gathers below in the same order.
    zero1 = [n for n, lay in p_layouts.items() if lay.placements != state_layouts[n].placements]
    dp_names = data_axes(plan, mesh)
    pos, n_dp = data_position(mesh, dp_names)
    mean_over_dp = [Partial("avg") if a in dp_names else Replicate() for a in mesh.axis_names]

    def batch_fn(shape: ShapeSpec) -> dict:
        return layouts(batch_spec_tree(input_specs(cfg, shape), cfg, plan, mesh), dmesh)

    def grad_norm(grads: dict):
        """The square root of the sum of squares of every gradient, summed
        in ``grads``' order as make_train_step sums them.  Each local
        shard's sum of squares is partial over the mesh dims its DTensor is
        sharded on (not over a replica's dims, which would count it twice);
        the sums with the same such dims are added over the ranks in one
        all-reduce."""
        sums = [(g.to_local().float() ** 2).sum() for g in grads.values()]
        sharded = [tuple(isinstance(pl, Shard) for pl in g.placements) for g in grads.values()]
        for dims in sorted(set(sharded)):  # sorted: every rank in the same order
            at = [i for i, d in enumerate(sharded) if d == dims]
            partial = [Partial("sum") if d else Replicate() for d in dims]
            whole = DTensor.from_local(torch.stack([sums[i] for i in at]), dmesh, partial,
                                       run_check=False).full_tensor()
            for j, i in enumerate(at):
                sums[i] = whole[j]
        return torch.sqrt(sum(sums))

    def global_mean(t):
        """The mean over the data ranks of a 0-d tensor each computed."""
        return DTensor.from_local(torch.as_tensor(t).detach().reshape(()), dmesh,
                                  mean_over_dp, run_check=False).full_tensor()

    def step(model, opt_state, batch, step_idx: int):
        rows = {k: v.shape[0] for k, v in batch.items()}
        if any(r % n_dp for r in rows.values()):
            raise ValueError(f"global batch rows {rows} do not split over {n_dp} data ranks")
        local = {k: v[pos * (v.shape[0] // n_dp):(pos + 1) * (v.shape[0] // n_dp)]
                 for k, v in batch.items()}
        with using_policy(policy):
            total, metrics, params, grads = loss_and_grads(
                model, local, cfg, remat=plan.remat, loss_chunk=plan.loss_chunk)
        # The unplaced model's order (placing reorders a module's
        # parameters), so the norm adds its terms in make_train_step's order.
        params = {n: params[n] for n in p_specs}
        grads = {n: grads[n] for n in p_specs}
        gnorm = grad_norm(grads)
        if zero1:
            with torch.no_grad():
                lay = state_layouts
                views = {n: p.detach().redistribute(lay[n].mesh, lay[n].placements)
                         if n in zero1 else p for n, p in params.items()}
                grads = {n: g.redistribute(lay[n].mesh, lay[n].placements)
                         if n in zero1 else g for n, g in grads.items()}
            optimizer.update(grads, opt_state, views, step_idx)
            with torch.no_grad():
                for n in zero1:
                    lay = p_layouts[n]
                    whole = views[n].redistribute(lay.mesh, lay.placements)
                    params[n].to_local().copy_(whole.to_local())
        else:
            optimizer.update(grads, opt_state, params, step_idx)
        metrics = {k: global_mean(v) for k, v in metrics.items()}
        metrics.update(loss=global_mean(total), grad_norm=gnorm)
        return model, opt_state, metrics

    return step, (p_specs, o_specs, p_layouts, o_layouts, batch_fn)


def jit_serve_step(cfg: ArchConfig, shape: ShapeSpec, plan: ShardingPlan, mesh, device=None,
                   pad_to: int = 0):
    """The serve step of ``shape.kind`` with the plan's layouts on ``mesh``
    (the port's :class:`~repro_torch.core.device_order.Mesh`).

    Returns ``(step, (p_specs, p_layouts, batch_fn))``: the parameters'
    ``(shape, dtype)`` tree and :class:`~repro_torch.parallel.sharding.Layout`
    tree, and ``batch_fn(shape)``, a cell's batch layouts.  Build the model
    with ``lm.init(seed, cfg, device, place=parallel.sharding.placer(p_layouts))``
    (or :func:`place` a built one).

    Prefill (``shape.kind == "prefill"``): ``step(model, batch) -> (logits,
    cache)`` takes the global batch (every rank the same, on ``device``) and
    computes this rank's rows with ``lm.prefill(..., pad_to=pad_to)``; the
    logits are the global batch's, (B, V) or the audio encoder's (B, S, V),
    on every rank; the cache is a dict of DTensors in
    ``batch_fn(decode shape)["cache"]``'s layouts (batch over the data axes,
    the K/V caches' positions over ``"model"`` where they divide, the
    recurrent states' channels over it).  Sequence parallelism runs where
    the plan asks for it and the prompt divides over ``"model"``.

    Decode: ``step(model, {"token", "pos", "cache"}) -> (logits, cache)``
    takes the global tokens (B,) and the cache as prefill returned it,
    updates this rank's shard of it in place and returns the global logits
    (B, V) and the cache.  It runs without sequence parallelism.

    Rows that do not divide over the data ranks (``long_500k``'s one
    sequence) are not split: the batch's spec leaves them whole, as
    ``sanitize`` leaves any dim an axis does not divide, and every data
    rank computes all of them.  ``device``: the card unless ``"cpu"``;
    without a process group the step joins one of one rank.  The step installs its activation policy for its own duration
    only.
    """
    from torch.distributed.tensor import DTensor

    device = resolve_device(device)
    one_rank_world(device)
    p_specs = lm.param_specs(cfg)
    dmesh = device_mesh(mesh, device)
    p_layouts = layouts(param_spec_tree(p_specs, plan, mesh), dmesh)
    pos, n_dp = data_position(mesh, data_axes(plan, mesh))
    base = activation_policy(plan, mesh, cfg)

    def batch_fn(shape: ShapeSpec) -> dict:
        return layouts(batch_spec_tree(input_specs(cfg, shape), cfg, plan, mesh), dmesh)

    def policy_for(shapes: dict, rows: int) -> ActivationPolicy:
        """The policy for a batch of these global ``(shape, dtype)``s and
        ``rows`` rows: the rows over the data axes where they divide, the
        sequence over ``"model"`` where the inputs' spec splits it, and the
        caches whose positions their spec splits."""
        specs = batch_spec_tree(shapes, cfg, plan, mesh)
        seq = any(specs[k][1] == "model" for k in ("tokens", "frames") if k in specs)
        cache_seq = frozenset(n for n, s in specs.get("cache", {}).items()
                              if n in ("k", "xk") and s[3] == "model")
        return dataclasses.replace(base, dp=base.dp if rows % n_dp == 0 else None,
                                   seq=base.tp if seq else None, cache_seq=cache_seq)

    def rows(t):
        if t.shape[0] % n_dp:  # left whole on every data rank
            return t
        b = t.shape[0] // n_dp
        return t[pos * b:(pos + 1) * b]

    def as_dtensors(cache: dict, specs: dict) -> dict:
        lay = layouts(batch_spec_tree({"cache": specs}, cfg, plan, mesh), dmesh)["cache"]
        return {n: DTensor.from_local(t, lay[n].mesh, lay[n].placements, run_check=False,
                                      shape=specs[n][0], stride=contiguous_stride(specs[n][0]))
                for n, t in cache.items()}

    if shape.kind == "prefill":
        @torch.no_grad()
        def step(model, batch):
            B, S = batch["frames" if cfg.family == "audio" else "tokens"].shape[:2]
            specs = lm.prefill_cache_specs(cfg, B, S, pad_to)
            with using_policy(policy_for({**shapes_of(batch), "cache": specs}, B)):
                logits, cache = lm.prefill(model, {k: rows(v) for k, v in batch.items()}, cfg,
                                           pad_to=pad_to)
                logits, _ = gather_batch(logits)
            return logits, as_dtensors(cache, specs)
        return step, (p_specs, p_layouts, batch_fn)

    @torch.no_grad()
    def step(model, batch):
        cache = batch["cache"]
        shapes = {"cache": {n: (tuple(t.shape), t.dtype) for n, t in cache.items()}}
        local = {"token": rows(batch["token"]), "pos": batch["pos"],
                 "cache": {n: t.to_local() for n, t in cache.items()}}
        with using_policy(policy_for(shapes, batch["token"].shape[0])):
            logits, _ = lm.decode_step(model, local, cfg)
            logits, _ = gather_batch(logits)
        return logits, cache

    return step, (p_specs, p_layouts, batch_fn)


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
