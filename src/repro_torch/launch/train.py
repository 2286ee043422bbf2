"""End-to-end training on one device: the command line of ``repro.launch.train``, ported.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b --smoke \
        --device cpu --steps 20 --ckpt-dir /tmp/ckpt

Runs on the card unless given ``--device cpu``; ``--smoke`` takes the
reduced config, whose head dim 16 the attention kernels do not take, so
smoke runs are CPU only.  The schedule is WSD where the config asks for it
(minicpm-2b), else cosine.  ``--mesh``, ``--no-fsdp`` and
``--seq-parallel`` come with sharding (ROADMAP.md queue 1 item 5).
"""

from __future__ import annotations

import argparse

from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.optim import adamw, cosine, wsd
from repro_torch.train.loop import train


def main() -> None:
    ap = argparse.ArgumentParser(description="TopoOpt training (PyTorch port)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none"])
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--loss-chunk", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the plain path")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    shape = ShapeSpec("cli", args.seq_len, args.global_batch, "train")
    sched = (wsd if cfg.schedule == "wsd" else cosine)(args.lr, args.steps)
    res = train(
        cfg, shape, adamw(sched), total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, fail_at=args.fail_at, remat=args.remat,
        loss_chunk=args.loss_chunk, device=args.device,
    )
    print(
        f"done: step={res.final_step} loss {res.losses[0]:.4f} -> "
        f"{res.losses[-1]:.4f} stragglers={res.straggler_steps}"
    )


if __name__ == "__main__":
    main()
