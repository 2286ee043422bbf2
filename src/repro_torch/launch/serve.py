"""Serving entry point: prefill a batch of prompts, then greedy decode with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --batch 4 --prompt-len 1000 --decode-steps 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \
        --batch 4 --prompt-len 1000 --decode-steps 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
        --batch 4 --prompt-len 1000 --decode-steps 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b \
        --batch 4 --prompt-len 2048 --decode-steps 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-3.2-vision-11b \
        --batch 4 --prompt-len 1000 --decode-steps 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b --smoke \
        --device cpu

Runs on the card unless ``--device cpu`` is given; without a card it raises.
Weights are drawn on the device from ``--seed``; prompts (and the VLM's image
embeddings, drawn after them) are the same numpy draws as
``repro.launch.serve``'s.  Encoder-only archs (hubert-xlarge) have no decode
and exit, as the reference does; their forward is ``models.lm.forward`` on
``frames`` (``launch/trace_serve.py`` times one).  ``--smoke`` takes the
reduced config (head dim 16, which the attention kernels compute at a width
of 64 on the card), on the card or the CPU.
recurrentgemma-9b's decode cache is exact once the prompt reaches its
2048-token window; below it the reference overwrites the last prompt key,
and the port does the same.
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

from repro_torch.compat import resolve_device
from repro_torch.configs.base import get_config, torch_dtype
from repro_torch.models import lm


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, tokens, decode_steps: int, timings: dict | None = None,
             image_embeds=None):
    """Prefill ``tokens`` (B, S), then ``decode_steps`` greedy tokens -> (B, steps).

    As ``repro.launch.serve``: the first token comes from the prefill logits,
    each later one from a ``decode_step``.  ``image_embeds`` (B, img_tokens,
    d_model) goes into the VLM's prefill batch.  If ``timings`` is a dict, the
    host-clock seconds of the prefill and of the decode loop (each ended by a
    device synchronise) are stored under ``"prefill_s"`` and ``"decode_s"``.
    """
    cfg = model.cfg
    S = tokens.shape[1]
    t0 = time.perf_counter()
    batch = {"tokens": tokens}
    if image_embeds is not None:
        batch["image_embeds"] = image_embeds
    logits, cache = lm.prefill(model, batch, cfg, pad_to=S + decode_steps)
    tok = logits.argmax(dim=-1)
    if timings is not None:
        _sync(tokens.device)
        timings["prefill_s"] = time.perf_counter() - t0
    generated = [tok]
    t0 = time.perf_counter()
    for i in range(decode_steps - 1):
        logits, cache = lm.decode_step(
            model, {"token": tok, "pos": S + i, "cache": cache}, cfg
        )
        tok = logits.argmax(dim=-1)
        generated.append(tok)
    if timings is not None:
        _sync(tokens.device)
        timings["decode_s"] = time.perf_counter() - t0
    return torch.stack(generated, dim=1)


def image_draw(rng, cfg, batch: int) -> torch.Tensor:
    """``repro.launch.serve``'s image embeddings: ``standard_normal`` from
    ``rng`` in the activation dtype (on the CPU)."""
    draw = rng.standard_normal((batch, cfg.img_tokens, cfg.d_model))
    return torch.from_numpy(draw).to(torch_dtype(cfg.activation_dtype))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="TopoOpt serving (PyTorch port)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")

    rng = np.random.default_rng(args.seed)
    B, S = args.batch, args.prompt_len
    model = lm.init(args.seed, cfg, device)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).to(device)
    image_embeds = None
    if cfg.family == "vlm":
        image_embeds = image_draw(rng, cfg, B).to(device)

    timings: dict = {}
    out = generate(model, tokens, args.decode_steps, timings, image_embeds).cpu().numpy()
    if device.type == "cuda":
        where = f"{torch.cuda.get_device_name(device)} (host clock after synchronise)"
    else:
        where = "cpu (host clock; not a device time)"
    steps = out.shape[1]
    print(f"device: {where}")
    print(f"prefill: {B}x{S} in {timings['prefill_s'] * 1e3:.1f} ms on {where}")
    print(
        f"decode: {steps} steps in {timings['decode_s'] * 1e3:.1f} ms "
        f"({timings['decode_s'] / max(steps - 1, 1) * 1e3:.2f} ms/token) on {where}"
    )
    print("generated ids (first seq):", out[0][:16])


if __name__ == "__main__":
    main()
