"""Where a serving request's device time goes: one traced ``generate``.

    PYTHONPATH=src python -m repro_torch.launch.trace_serve --arch granite-8b \
        --batch 4 --prompt-len 1000 --decode-steps 4
    PYTHONPATH=src python -m repro_torch.launch.trace_serve --arch falcon-mamba-7b \
        --batch 4 --prompt-len 1000 --decode-steps 4
    PYTHONPATH=src python -m repro_torch.launch.trace_serve --arch recurrentgemma-9b \
        --batch 4 --prompt-len 2048 --decode-steps 4
    PYTHONPATH=src python -m repro_torch.launch.trace_serve --arch llama-3.2-vision-11b \
        --batch 4 --prompt-len 1000 --decode-steps 4
    PYTHONPATH=src python -m repro_torch.launch.trace_serve --arch hubert-xlarge \
        --batch 4 --prompt-len 1000
    PYTHONPATH=src python -m repro_torch.launch.trace_serve --dlrm 8 --batch 4096

Runs one untraced warm-up, then traces a prefill and a decode loop apart with
``torch.profiler`` and prints, for each: the host-clock wall time, the summed
device time of the kernels it ran (CUDA activity), the device idle share
(1 - device time / wall time; the port runs on one stream, so kernels do
not overlap), and the kernels that took the most device time.  Card only: device time is what it
reports, and a CPU run has none.  The VLM prefills with image embeddings
(``img_tokens`` of them: ``launch.serve.image_draw`` from numpy's
``--seed``); an encoder-only arch (hubert-xlarge) has no
decode, so one ``lm.forward`` over ``--prompt-len`` frames (standard normal,
numpy, ``--seed``) is traced instead.  ``--smoke`` traces the arch's smoke config,
which the card takes only where it has no attention (falcon-mamba-7b): the
others' smoke head dim (16) is not one the attention kernel takes.
``--dlrm N`` traces one forward of the paper's DLRM with N tables
(``models.dlrm.paper_config``) at ``--batch`` instead, ids and dense
features drawn with numpy from ``--seed``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

if __name__ == "__main__" and not __package__:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.compat import default_device
from repro_torch.configs.base import get_config, torch_dtype
from repro_torch.launch.serve import image_draw
from repro_torch.models import dlrm, lm

TOP_KERNELS = 12


def _report(name: str, prof, wall_s: float) -> None:
    # Kernel events only: a CPU op's self device time repeats its kernels'.
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    print(f"{name}: wall {wall_s * 1e3} ms, device busy {device_us / 1e3} ms, "
          f"idle share {1 - device_us / 1e3 / (wall_s * 1e3)}")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:TOP_KERNELS]:
        t = e.self_device_time_total
        print(f"  {t / 1e3:12.3f} ms {t / device_us:7.2%} x{e.count:<5d} {e.key[:100]}")


def trace_dlrm(n_tables: int, batch: int, seed: int, device) -> None:
    """One traced forward of ``paper_config(n_tables)`` after one untraced."""
    cfg = dlrm.paper_config(n_tables)
    model = dlrm.init(seed, cfg, device)
    rng = np.random.default_rng(seed)
    sparse = torch.from_numpy(
        rng.integers(0, cfg.rows_per_table, (batch, n_tables)).astype(np.int32)).to(device)
    dense = torch.from_numpy(
        rng.standard_normal((batch, cfg.dense_features)).astype(np.float32)).to(device)
    dlrm.forward(model, dense, sparse, cfg)  # warm-up
    torch.cuda.synchronize()
    print(f"device: {torch.cuda.get_device_name(device)}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dlrm.forward(model, dense, sparse, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(f"dlrm forward {n_tables} tables, batch {batch}", prof, wall)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Trace one serving request")
    ap.add_argument("--arch")
    ap.add_argument("--dlrm", type=int, metavar="N_TABLES",
                    help="trace a forward of the paper's DLRM instead of an LM")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1000)
    ap.add_argument("--decode-steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if (args.arch is None) == (args.dlrm is None):
        ap.error("give one of --arch and --dlrm")

    device = default_device()
    if args.dlrm is not None:
        trace_dlrm(args.dlrm, args.batch, args.seed, device)
        return
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = lm.init(args.seed, cfg, device)
    B, S = args.batch, args.prompt_len
    rng = np.random.default_rng(args.seed)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if cfg.is_encoder:
        frames = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)))
        batch = {"frames": frames.to(torch_dtype(cfg.activation_dtype)).to(device)}
        lm.forward(model, batch, cfg)  # warm-up
        torch.cuda.synchronize()
        print(f"device: {torch.cuda.get_device_name(device)}")
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            lm.forward(model, batch, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _report(f"encoder forward {B}x{S} frames", prof, wall)
        return
    gen = torch.Generator(device=device).manual_seed(args.seed)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device)
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["image_embeds"] = image_draw(rng, cfg, B).to(device)
    max_len = S + args.decode_steps
    lm.prefill(model, batch, cfg, pad_to=max_len)  # warm-up
    torch.cuda.synchronize()
    print(f"device: {torch.cuda.get_device_name(device)}")

    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, cache = lm.prefill(model, batch, cfg, pad_to=max_len)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(f"prefill {B}x{S}", prof, wall)

    tok = logits.argmax(-1)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(args.decode_steps):
            logits, cache = lm.decode_step(
                model, {"token": tok, "pos": S + i, "cache": cache}, cfg
            )
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(f"decode {args.decode_steps} steps", prof, wall)


if __name__ == "__main__":
    main()
