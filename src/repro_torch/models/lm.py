"""Uniform model facade used by serving (``repro.models.lm``'s counterpart).

``init`` / ``forward`` / ``prefill`` / ``decode_step`` take the reference's
arguments, with a ``Transformer`` module in place of the parameter pytree.
The dense and MoE families are served so far; the others raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import torch

from ..compat import resolve_device
from ..configs.base import ArchConfig
from . import transformer


def init(seed: int, cfg: ArchConfig, device: str | torch.device | None = None):
    """Random weights drawn directly on ``device`` (the card by default)."""
    transformer.require_ported(cfg)
    return transformer.Transformer(cfg, seed, resolve_device(device))


def forward(params, batch, cfg: ArchConfig):
    transformer.require_ported(cfg)
    return transformer.forward(params, cfg, batch["tokens"])


def prefill(params, batch, cfg: ArchConfig, pad_to: int = 0):
    transformer.require_ported(cfg)
    return transformer.prefill(params, cfg, batch["tokens"], pad_to=pad_to)


def decode_step(params, batch, cfg: ArchConfig):
    transformer.require_ported(cfg)
    return transformer.decode_step(params, cfg, batch["token"], batch["pos"], batch["cache"])
