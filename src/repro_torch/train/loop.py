"""Fault-tolerant training loop (``repro.train.loop``'s counterpart).

- checkpoint every N steps (atomic), resume from the latest on start;
- deterministic stateless data pipeline (restart-safe): the loop checks
  that the stream hands it the step it expects;
- straggler detection: per-step wall time against the running median; slow
  steps are counted and logged;
- failure injection (``fail_at``) for tests, proving restart works.

It trains through ``train.steps.jit_train_step`` on a sharding plan and a
mesh: by default ``ShardingPlan(fsdp=False)`` on a ``("data",)`` mesh over
every rank of the process group (one rank, joined here, where there is
none).  The model is drawn from the seed block by block, each block placed
into its layout before the next is drawn; every rank reads the same global
batch and computes on its own rows; rank 0 logs and writes the checkpoints,
which hold global tensors, so a run resumes on another mesh.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint.ckpt import latest_step, load_checkpoint, prune_checkpoints, save_checkpoint
from ..compat import resolve_device
from ..configs.base import ArchConfig, ShapeSpec
from ..core.device_order import Mesh
from ..data.pipeline import DataSpec, Prefetcher
from ..launch.mesh import one_rank_world
from ..models import lm
from ..optim import Optimizer
from ..parallel.sharding import ShardingPlan, parameters, placer
from .steps import init_opt_state, jit_train_step


class InjectedFailure(RuntimeError):
    pass


@dataclass
class TrainResult:
    final_step: int
    losses: list[float] = field(default_factory=list)
    straggler_steps: int = 0
    restarts: int = 0


def _to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


@torch.no_grad()
def _restore(tree, loaded) -> None:
    for name, t in tree.items():
        if isinstance(t, dict):
            _restore(t, loaded[name])
        else:
            t.copy_(loaded[name])


def train(
    cfg: ArchConfig,
    shape: ShapeSpec,
    optimizer: Optimizer,
    plan: ShardingPlan | None = None,
    mesh: Mesh | None = None,
    *,
    total_steps: int,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    seed: int = 0,
    fail_at: int | None = None,
    straggler_factor: float = 3.0,
    log_every: int = 10,
    logger=print,
    device=None,
) -> TrainResult:
    """Trains ``lm.init(seed, cfg)`` laid out by ``plan`` (which also
    carries ``remat`` and ``loss_chunk``) on ``mesh``, the module
    docstring's defaults where None, on ``device`` (the card unless given
    ``"cpu"``), from the latest checkpoint in ``ckpt_dir``, if any, to
    ``total_steps``.  Every rank of the process group calls it."""
    device = resolve_device(device)
    made_world = one_rank_world(device)
    try:
        if mesh is None:
            mesh = Mesh(np.arange(dist.get_world_size()), ("data",))
        if plan is None:
            plan = ShardingPlan(fsdp=False)
        return _train(cfg, shape, optimizer, plan, mesh, total_steps, ckpt_dir, ckpt_every,
                      seed, fail_at, straggler_factor, log_every, logger, device)
    finally:
        if made_world:
            dist.destroy_process_group()


def _train(cfg, shape, optimizer, plan, mesh, total_steps, ckpt_dir, ckpt_every, seed,
           fail_at, straggler_factor, log_every, logger, device) -> TrainResult:
    rank = dist.get_rank()
    if rank != 0:
        logger = _quiet
    step_fn, (_, _, p_layouts, o_layouts, _) = jit_train_step(cfg, optimizer, plan, mesh, device)
    model = lm.init(seed, cfg, device=device, place=placer(p_layouts))
    params = parameters(model)
    opt_state = init_opt_state(optimizer, model, o_layouts)

    start_step = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        start_step, p, o, _ = load_checkpoint(ckpt_dir, params, opt_state, device=device,
                                              param_layouts=p_layouts, opt_layouts=o_layouts)
        _restore(params, p)
        if o is not None:
            _restore(opt_state, o)
        logger(f"[loop] resumed from step {start_step}")

    data = Prefetcher(DataSpec(cfg=cfg, shape=shape, seed=seed), start_step)
    result = TrainResult(final_step=start_step)
    step_times: list[float] = []

    try:
        step = start_step
        while step < total_steps:
            got_step, batch = data.next()
            if got_step != step:
                raise RuntimeError(f"pipeline desync {got_step} != {step}")
            t0 = time.perf_counter()
            _, _, metrics = step_fn(model, opt_state, _to_device(batch, device), step)
            loss = float(metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            step_times.append(dt)
            med = float(np.median(step_times[-50:]))
            if len(step_times) > 5 and dt > straggler_factor * med:
                result.straggler_steps += 1
                logger(f"[loop] straggler at step {step}: {dt:.3f}s vs median {med:.3f}s")

            result.losses.append(loss)
            if step % log_every == 0:
                logger(f"[loop] step {step} loss {loss:.4f} ({dt * 1e3:.1f} ms)")

            step += 1
            result.final_step = step

            if ckpt_dir and step % ckpt_every == 0:
                save_checkpoint(ckpt_dir, step, params, opt_state)
                if rank == 0:
                    prune_checkpoints(ckpt_dir, keep=3)

            if fail_at is not None and step == fail_at:
                raise InjectedFailure(f"injected failure at step {step}")
    finally:
        data.close()

    if ckpt_dir:
        save_checkpoint(ckpt_dir, result.final_step, params, opt_state)
    return result


def _quiet(*args, **kwargs) -> None:
    pass
