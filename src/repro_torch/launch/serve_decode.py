"""Serve a small model with batched requests in the port: prefill, then
greedy decode with a KV cache, reporting tokens/s; the twin of
``examples/serve_decode.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve_decode --arch recurrentgemma-9b
    PYTHONPATH=src python -m repro_torch.launch.serve_decode --arch recurrentgemma-9b \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_decode --arch falcon-mamba-7b

Serves the ``.smoke()`` config of ``--arch`` through ``lm.prefill(...,
pad_to=)`` and ``lm.decode_step`` (``launch.serve.generate``: the example's
loop, with ``pos`` a Python int as the port's decode takes it), with the
example's flags and defaults, on the card unless given ``--device cpu``;
without a card it raises.  Weights are drawn from seed 0 on the device,
prompts (and the VLM's image embeddings, drawn after them) from numpy seed
0 as the example draws them.  The smoke configs' head dim (16) runs on the
card's attention kernels at a width of 64.  The rate is the decode loop's
tokens over its host-clock seconds, ended by a device synchronise.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import generate, image_draw
from repro_torch.models import lm


def serve(model, batch: int, prompt_len: int, decode_steps: int):
    """The example's requests on ``model`` (on its device): ``batch`` prompts
    of ``prompt_len`` tokens drawn from numpy seed 0, then ``decode_steps``
    greedy tokens -> (ids (batch, decode_steps) numpy, decode tokens, decode
    seconds)."""
    cfg = model.cfg
    device = next(model.parameters()).device
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt_len))).to(device)
    image_embeds = image_draw(rng, cfg, batch).to(device) if cfg.family == "vlm" else None
    timings: dict = {}
    ids = generate(model, tokens, decode_steps, timings, image_embeds).cpu().numpy()
    return ids, batch * (decode_steps - 1), timings["decode_s"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-9b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the plain path")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).smoke()
    if cfg.is_encoder:
        raise SystemExit("encoder-only arch has no decode path")
    model = lm.init(0, cfg, device)
    B = args.batch
    _, n_tokens, dt = serve(model, B, args.prompt_len, args.decode_steps)
    print(f"{cfg.name} (smoke): {n_tokens} tokens in {dt:.2f}s "
          f"= {n_tokens / dt:.1f} tok/s (batch {B})")


if __name__ == "__main__":
    main()
