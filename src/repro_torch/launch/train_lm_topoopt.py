"""Train a small LM with the full TopoOpt pipeline, data-parallel; the twin of
``examples/train_lm_topoopt.py``:

1. TopologyFinder plans the rings for a data-parallel job over the world,
2. the mesh's rank order is reordered so the primary ring is stride 1,
3. gradient sync runs over the multi-ring TotientPerms AllReduce (§6),
   point to point over ``torch.distributed`` (NCCL on cards, gloo on CPUs),
4. checkpoints every 50 steps (``checkpoint.ckpt``); restart-safe.

Eight ranks on the CPU, one process each::

    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 8 \\
        -m repro_torch.launch.train_lm_topoopt --device cpu --steps 300

Without ``torch.distributed.run``'s environment the world is one rank, on the
card unless given ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.train_lm_topoopt --steps 60 --ckpt-dir /tmp/ck

Several ranks on cards need one card each (NCCL puts no two ranks on one
device).  The example's flags and defaults, its model (granite-8b's layout
at ``--d-model``, 8 heads, 4 kv heads, head dim 32, d_ff 4 d_model, vocab
32768, fp32) and its printed lines, printed by rank 0.  The weights are
drawn from seed 0 by every rank (the reference draws them from
``PRNGKey(0)``: other numbers), and rank 0 writes the checkpoints.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.ckpt import latest_step, load_checkpoint, save_checkpoint
from repro_torch.compat import resolve_device
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.core import topology_finder
from repro_torch.core.demand import data_parallel_demand
from repro_torch.core.device_order import topoopt_mesh
from repro_torch.data.pipeline import DataSpec, batch_for_step
from repro_torch.launch.mesh import init_world
from repro_torch.models import lm
from repro_torch.optim import adamw, cosine
from repro_torch.train.steps import make_shardmap_dp_train_step


@torch.no_grad()
def _restore(tree, loaded) -> None:
    for name, t in tree.items():
        if isinstance(t, dict):
            _restore(t, loaded[name])
        else:
            t.copy_(loaded[name])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--n-layers", type=int, default=8)
    ap.add_argument("--schedule", default="ring",
                    choices=["ring", "recursive_hd", "multi_tree"],
                    help="collective schedule for gradient sync "
                         "(normally the searched Strategy.schedule)")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for gloo ranks")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    n_dev = init_world(device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    say = print if rank == 0 else (lambda *a, **k: None)

    cfg = dataclasses.replace(
        get_config("granite-8b"),
        n_layers=args.n_layers, d_model=args.d_model, n_heads=8, n_kv_heads=4,
        head_dim=32, d_ff=args.d_model * 4, vocab=32768,
        param_dtype="float32", activation_dtype="float32",
    )
    shape = ShapeSpec("example", seq_len=128, global_batch=n_dev * 2, kind="train")
    model = lm.init(0, cfg, device=device)
    params = dict(model.named_parameters())

    # --- TopoOpt plan: degree-3 rings for the DP AllReduce -----------------
    n_params = sum(p.numel() for p in params.values())
    say(f"model: {n_params/1e6:.1f}M params on {n_dev} devices")
    topo = topology_finder(data_parallel_demand(n_dev, n_params * 4), degree=3)
    strides = tuple(topo.ring_strides(tuple(range(n_dev))))
    say(f"TotientPerms ring strides: {strides}")

    mesh = topoopt_mesh((n_dev,), ("data",), allreduce_axis="data",
                        stride=strides[0] if strides else 1)
    opt = adamw(cosine(3e-3, args.steps))
    step_fn = make_shardmap_dp_train_step(
        cfg, opt, mesh, axis_name="data", ring_strides=strides or (1,),
        schedule=args.schedule,
    )
    state = opt.init(params)

    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start, p, o, _ = load_checkpoint(args.ckpt_dir, params, state, device=device)
        _restore(params, p)
        _restore(state, o)
        say(f"resumed from step {start}")

    spec = DataSpec(cfg=cfg, shape=shape, seed=0)
    loss = None
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch_for_step(spec, step).items()}
        _, _, loss, _ = step_fn(model, state, batch, step, None)
        if step % 20 == 0:
            value = float(loss)  # waits for the step
            dt = (time.perf_counter() - t0) / max(step - start, 1)
            say(f"step {step:4d} loss {value:.4f} ({dt*1e3:.0f} ms/step)")
        if args.ckpt_dir and (step + 1) % 50 == 0:  # rank 0 writes, every rank waits
            save_checkpoint(args.ckpt_dir, step + 1, params, state)
    if loss is not None:
        say(f"final loss: {float(loss):.4f}")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
