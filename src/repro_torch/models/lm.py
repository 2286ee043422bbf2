"""Uniform model facade used by training and serving (``repro.models.lm``'s
counterpart).

``init`` / ``forward`` / ``prefill`` / ``decode_step`` / ``loss_fn`` take the
reference's arguments, with a module in place of the parameter pytree, and
dispatch on ``cfg.family``: ``ssm`` and ``hybrid`` to ``models.recurrent``;
``dense``, ``moe``, ``vlm`` and ``audio`` to ``models.transformer``.
``recsys`` (DLRM) raises ``NotImplementedError``: it lives in
``models.dlrm``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


# ---------------------------------------------------------------------------
# Training loss (next-token CE; masked-frame CE for the audio encoder)
# ---------------------------------------------------------------------------


def _hidden(params, batch, cfg: ArchConfig, remat: str):
    """Grad-enabled forward up to the final norm -> (x, aux)."""
    if cfg.family in ("ssm", "hybrid"):
        hidden = recurrent.mamba_hidden if cfg.family == "ssm" else recurrent.griffin_hidden
        x = hidden(params, cfg, batch["tokens"], remat)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "audio":
        return transformer.hidden_forward(params, cfg, frames=batch["frames"], remat=remat)
    return transformer.hidden_forward(params, cfg, tokens=batch.get("tokens"),
                                      image_embeds=batch.get("image_embeds"), remat=remat)


def _nll(logits, targets, mask):
    """The masked next-token NLL summed over (B, S), in fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return ((logz - gold) * mask).sum()


def _xent(logits, targets, mask):
    return _nll(logits, targets, mask) / torch.clamp(mask.sum(), min=1.0)


def _chunk_nll(x, head, targets, mask):
    return _nll(x @ head, targets, mask), mask.sum()


def _hidden_xent_chunked(x, head, targets, mask, chunk: int):
    """CE over sequence chunks, each chunk's logits recomputed in the
    backward (``torch.utils.checkpoint``), so the (B, S, V) logits never
    exist at once: minicpm-2b at 4 x 4096 would need 8 GB for them in fp32."""
    S = x.shape[1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    nll = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, S + pad, chunk):
        part = (x[:, c:c + chunk], head, targets[:, c:c + chunk], mask[:, c:c + chunk])
        n, m = checkpoint(_chunk_nll, *part, use_reentrant=False)
        nll, cnt = nll + n, cnt + m
    return nll / torch.clamp(cnt, min=1.0)


def loss_fn(params, batch, cfg: ArchConfig, remat: str = "full", loss_chunk: int = 0,
            aux_weight: float = 0.01):
    """Scalar training loss (+ metrics dict), grad-enabled; ``batch`` holds
    tensors on the model's device.  On the card, a family whose kernel has
    no backward yet raises ``NotImplementedError`` (``kernels/ops.py``)."""
    transformer.require_ported(cfg)
    x, aux = _hidden(params, batch, cfg, remat)
    head = params.head()
    if cfg.family == "audio":
        targets = batch["labels"]
        loss = _xent(x @ head, targets, torch.ones(targets.shape, device=x.device))
        return loss, {"xent": loss}

    tokens = batch["tokens"]
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    if loss_chunk > 0 and cfg.family not in ("ssm", "hybrid"):
        # the recurrent stacks take the full CE, as in the reference
        loss = _hidden_xent_chunked(x, head, targets, mask, loss_chunk)
    else:
        loss = _xent(x @ head, targets, mask)
    total = loss + aux_weight * aux
    return total, {"xent": loss, "aux": aux}
