"""Uniform model facade used by serving (``repro.models.lm``'s counterpart).

``init`` / ``forward`` / ``prefill`` / ``decode_step`` take the reference's
arguments, with a module in place of the parameter pytree, and dispatch on
``cfg.family``: ``ssm`` and ``hybrid`` to ``models.recurrent``; ``dense``,
``moe``, ``vlm`` and ``audio`` to ``models.transformer``.  ``recsys`` (DLRM)
raises ``NotImplementedError``: it lives in ``models.dlrm``.
"""

from __future__ import annotations

import torch

from ..compat import resolve_device
from ..configs.base import ArchConfig
from . import recurrent, transformer


def init(seed: int, cfg: ArchConfig, device: str | torch.device | None = None):
    """Random weights drawn directly on ``device`` (the card by default)."""
    transformer.require_ported(cfg)
    device = resolve_device(device)
    if cfg.family == "ssm":
        return recurrent.MambaLM(cfg, seed, device)
    if cfg.family == "hybrid":
        return recurrent.GriffinLM(cfg, seed, device)
    return transformer.Transformer(cfg, seed, device)


def forward(params, batch, cfg: ArchConfig):
    transformer.require_ported(cfg)
    if cfg.family == "ssm":
        return recurrent.mamba_forward(params, cfg, batch["tokens"])
    if cfg.family == "hybrid":
        return recurrent.griffin_forward(params, cfg, batch["tokens"])
    if cfg.family == "audio":
        return transformer.forward(params, cfg, frames=batch["frames"])
    return transformer.forward(params, cfg, tokens=batch.get("tokens"),
                               image_embeds=batch.get("image_embeds"))


def prefill(params, batch, cfg: ArchConfig, pad_to: int = 0):
    """``pad_to`` sizes a transformer's KV cache; the recurrent families'
    caches do not grow, and they ignore it, as the reference does.  The
    audio encoder returns the full sequence's logits and no cache."""
    transformer.require_ported(cfg)
    if cfg.family == "ssm":
        return recurrent.mamba_prefill(params, cfg, batch["tokens"])
    if cfg.family == "hybrid":
        return recurrent.griffin_prefill(params, cfg, batch["tokens"])
    if cfg.family == "audio":
        logits, _ = transformer.forward(params, cfg, frames=batch["frames"])
        return logits, {}
    return transformer.prefill(params, cfg, batch["tokens"],
                               image_embeds=batch.get("image_embeds"), pad_to=pad_to)


def decode_step(params, batch, cfg: ArchConfig):
    transformer.require_ported(cfg)
    token, pos, cache = batch["token"], batch["pos"], batch["cache"]
    if cfg.family == "ssm":
        return recurrent.mamba_decode_step(params, cfg, token, pos, cache)
    if cfg.family == "hybrid":
        return recurrent.griffin_decode_step(params, cfg, token, pos, cache)
    return transformer.decode_step(params, cfg, token, pos, cache)
