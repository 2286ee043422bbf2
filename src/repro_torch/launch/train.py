"""End-to-end training on one device: the command line of ``repro.launch.train``, ported.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b --smoke \
        --device cpu --steps 20 --ckpt-dir /tmp/ckpt

Runs on the card unless given ``--device cpu``; ``--smoke`` takes the
reduced config, whose head dim 16 the attention kernels do not take, so
smoke runs are CPU only, but for falcon-mamba-7b's (no attention).  On the
card every family trains (the grouped matmul, the Mamba scan, the RG-LRU
scan and attention at head dims 64, 80, 128 and 256 have their backward
kernels); hubert-xlarge fits whole (about 15 GB of training state)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge \
        --seq-len 4096 --global-batch 4 --lr 3e-4 --steps 100 \
        --ckpt-dir build/ckpt-hubert

qwen3-moe-30b-a3b's training state at full depth (about 490 GB) does not
fit one card, nor do falcon-mamba-7b's (about 116 GB), recurrentgemma-9b's
(about 167 GB) and llama-3.2-vision-11b's (about 156 GB), so they train
there at full width and a cut depth from Python, as ``chip_smoke.py``
phases 5c, 5d, 5e and 5f do (recurrentgemma-9b at 5 layers: one (rec, rec,
attn) block and the (rec, rec) tail, its 4096-token sequence past its
2048-token window; the VLM at 10 layers, two groups of 4 self layers and a
cross layer, each batch with its 1601-token images)::

    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), n_layers=4)
    train(cfg, ShapeSpec("train", 4096, 4, "train"), adamw(wsd(3e-4, 100)),
          ShardingPlan(fsdp=False, loss_chunk=1024), total_steps=100)
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=16)
    train(cfg, ShapeSpec("train", 4096, 4, "train"), adamw(cosine(3e-4, 100)),
          total_steps=100)
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), n_layers=5)
    train(cfg, ShapeSpec("train", 4096, 1, "train"), adamw(cosine(3e-4, 100)),
          total_steps=100)
    cfg = dataclasses.replace(get_config("llama-3.2-vision-11b"), n_layers=10)
    train(cfg, ShapeSpec("train", 4096, 4, "train"), adamw(cosine(3e-4, 100)),
          ShardingPlan(fsdp=False, loss_chunk=1024), total_steps=100)

(remat "full" is the plan's default.)

This command line takes no depth flag, as the reference's has none.  The
schedule is WSD where the config asks for it
(minicpm-2b), else cosine.

``--mesh`` lays the job out as the reference's does, through
``train.steps.jit_train_step``: ``cpu`` (the default; the name is the
reference's) is a 1-D ``("data",)`` mesh over every rank of the world with
``fsdp=False``, on the card unless given ``--device cpu``; ``single`` and
``multi`` are the production meshes (``launch.mesh``: 256 ranks as
(data 16, model 16), or 512 with a pod axis of 2), and ``DxM`` (``2x4``) a
(data D, model M) mesh over a world of D x M ranks, each with ``fsdp=not
--no-fsdp`` and ``--seq-parallel``: over a model axis of more than one rank
each rank computes its own heads, MLP columns, experts, channels and
vocabulary rows (``train.steps.jit_train_step``).  Under
``torch.distributed.run`` every rank joins its process group (NCCL on
cards, one rank a card; gloo with ``--device cpu``); without it the world
is one rank.  Eight gloo ranks, data parallel and on a (2, 4) mesh::

    PYTHONPATH=src torchrun --standalone --nproc-per-node 8 -m repro_torch.launch.train \
        --arch granite-8b --smoke --device cpu --mesh cpu --steps 20
    PYTHONPATH=src torchrun --standalone --nproc-per-node 8 -m repro_torch.launch.train \
        --arch qwen3-moe-30b-a3b --smoke --device cpu --mesh 2x4 --seq-parallel --steps 20
"""

from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from repro_torch.compat import resolve_device
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.launch.mesh import init_world, make_production_mesh, make_test_mesh
from repro_torch.optim import adamw, cosine, wsd
from repro_torch.parallel.sharding import ShardingPlan
from repro_torch.train.loop import train


def mesh_arg(value: str) -> str:
    """``cpu``, ``single``, ``multi`` or ``DxM`` (two positive ints)."""
    if value in ("cpu", "single", "multi"):
        return value
    parts = value.split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise argparse.ArgumentTypeError(f"--mesh {value!r}: cpu, single, multi or DxM (2x4)")
    return value


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="TopoOpt training (PyTorch port)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", type=mesh_arg, default="cpu",
                    help="cpu, single, multi, or DxM: a (data D, model M) mesh")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none"])
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--loss-chunk", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the plain path")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    shape = ShapeSpec("cli", args.seq_len, args.global_batch, "train")
    device = resolve_device(args.device)
    joined = not dist.is_initialized()
    init_world(device)
    joined = joined and dist.is_initialized()
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    try:
        if args.mesh == "cpu":  # the loop's default mesh: ("data",) over the world
            mesh = None
            plan = ShardingPlan(fsdp=False, remat=args.remat, loss_chunk=args.loss_chunk)
        else:
            if args.mesh in ("single", "multi"):
                mesh = make_production_mesh(multi_pod=args.mesh == "multi")
            else:
                mesh = make_test_mesh(tuple(int(p) for p in args.mesh.split("x")))
            plan = ShardingPlan(fsdp=not args.no_fsdp, seq_parallel=args.seq_parallel,
                                remat=args.remat, loss_chunk=args.loss_chunk)
        sched = (wsd if cfg.schedule == "wsd" else cosine)(args.lr, args.steps)
        res = train(
            cfg, shape, adamw(sched), plan, mesh, total_steps=args.steps,
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, fail_at=args.fail_at,
            device=device,
        )
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(
                f"done: step={res.final_step} loss {res.losses[0]:.4f} -> "
                f"{res.losses[-1]:.4f} stragglers={res.straggler_steps}"
            )
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
