"""Where a training step's device time goes: one traced train step.

    PYTHONPATH=src python -m repro_torch.launch.trace_train --arch minicpm-2b \
        --batch 4 --seq-len 4096 --loss-chunk 1024

Builds the arch at full size on the card (random weights from ``--seed``),
AdamW with the config's schedule, and ``train.steps.make_train_step``; runs
one untraced warm-up step on ``batch_for_step(0)``, then traces step 1 with
``torch.profiler`` and prints the host-clock wall time, the summed device
time of its kernels, the device idle share, the kernels that took the most
device time (as ``trace_serve`` does) and the device time by group: the
attention backward kernels (either tiling, and the sum of the head dim 256
kernel's partials), the attention forward kernels, the Mamba scan's
backward (its kernel and the sum of its partials) and forward kernels, the
RG-LRU scan's backward and forward kernels (one launch each), cuBLAS GEMMs
and the rest.  Card only: device time is what it reports.
"""

from __future__ import annotations

import argparse
import re
import sys
import time
from pathlib import Path

if __name__ == "__main__" and not __package__:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.compat import default_device
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.data.pipeline import DataSpec, batch_for_step
from repro_torch.launch.trace_serve import _report
from repro_torch.models import lm
from repro_torch.optim import adamw, cosine, wsd
from repro_torch.train.steps import make_train_step

# Kernel-name patterns of each group, tried in order; the rest is "other".
GROUPS = (
    ("attention backward",
     re.compile(r"delta_kernel|dkdv_(d80_)?(wgmma_|sum_)?kernel|dq_(wgmma_|d80_cast_)?kernel")),
    ("attention forward", re.compile(r"flash_attention_(d80_)?(wgmma|fwd|fwd_ragged)_kernel")),
    ("selective scan backward", re.compile(r"mamba_bwd_")),
    ("selective scan forward", re.compile(r"mamba_scan_kernel")),
    ("RG-LRU backward", re.compile(r"lru_bwd_kernel")),
    ("RG-LRU forward", re.compile(r"lru_fwd_kernel")),
    ("GEMM", re.compile(r"gemm|cutlass|xmma|sm90_|nvjet", re.IGNORECASE)),  # cuBLAS
)


def group_of(kernel: str) -> str:
    """The group of a kernel, by its name as the profiler reports it."""
    return next((name for name, pat in GROUPS if pat.search(kernel)), "other")


def _groups(prof) -> None:
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels)
    sums = {name: 0.0 for name, _ in GROUPS} | {"other": 0.0}
    for e in kernels:
        sums[group_of(e.key)] += e.self_device_time_total
    for name, t in sums.items():
        print(f"  group {name}: {t / 1e3} ms ({t / total:.2%})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Trace one training step")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none"])
    ap.add_argument("--loss-chunk", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = default_device()
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = lm.init(args.seed, cfg, device)
    opt = adamw((wsd if cfg.schedule == "wsd" else cosine)(args.lr, 10))
    state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(cfg, opt, remat=args.remat, loss_chunk=args.loss_chunk)
    spec = DataSpec(cfg=cfg, shape=ShapeSpec("trace", args.seq_len, args.batch, "train"),
                    seed=args.seed)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in batch_for_step(spec, i).items()}
               for i in range(2)]
    step_fn(model, state, batches[0], 0)  # warm-up
    torch.cuda.synchronize()
    print(f"device: {torch.cuda.get_device_name(device)}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, metrics = step_fn(model, state, batches[1], 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(f"train step {args.batch}x{args.seq_len} (remat {args.remat}, loss chunk "
            f"{args.loss_chunk}), loss {float(metrics['loss'])}", prof, wall)
    _groups(prof)


if __name__ == "__main__":
    main()
