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
from ..configs.base import ArchConfig, cache_specs
from ..parallel.act_sharding import (
    all_reduce_max, constrain, model_rank, reads_block, reduce, seq_parallel, seq_share,
)
from . import recurrent, transformer


def init(seed: int, cfg: ArchConfig, device: str | torch.device | None = None, place=None):
    """Random weights drawn directly on ``device`` (the card by default).

    ``place(module, prefix) -> module``, where given, is called on each block
    as soon as it is built (``prefix`` its parameters' name prefix, e.g.
    ``"blocks.3."``) and on the model for the parameters outside the blocks
    (prefix ``""``): ``parallel.sharding.placer`` shards them there, so no
    rank holds more than a block unsharded.  The weights are those of
    ``init(seed, cfg, device)``."""
    transformer.require_ported(cfg)
    device = resolve_device(device)
    if cfg.family == "ssm":
        return recurrent.MambaLM(cfg, seed, device, place)
    if cfg.family == "hybrid":
        return recurrent.GriffinLM(cfg, seed, device, place)
    return transformer.Transformer(cfg, seed, device, place)


def param_specs(cfg: ArchConfig) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """Each parameter's ``(shape, dtype)`` by name, without allocating (for
    the sharding plan and the dry-run): the model is built on the ``meta``
    device, where nothing is drawn."""
    model = init(0, cfg, device="meta")
    return {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}


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


def prefill_cache_specs(cfg: ArchConfig, batch: int, seq_len: int, pad_to: int = 0) -> dict:
    """The cache :func:`prefill` returns for ``batch`` prompts of ``seq_len``
    tokens, as ``(shape, dtype)`` pairs (``cache_specs``): a transformer's at
    ``max(pad_to, seq_len)`` positions, the recurrent families' at the
    prompt's; none for the audio encoder."""
    if cfg.family == "audio":
        return {}
    return cache_specs(cfg, batch, seq_len if cfg.family in ("ssm", "hybrid")
                       else max(pad_to, seq_len))


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


def _nll(logits, targets, mask, v0=None):
    """The masked next-token NLL summed over (B, S), in fp32.  ``v0`` not
    None: ``logits`` are this model rank's vocabulary columns from ``v0``
    on, and the row max, the sum of exponentials and the target's logit are
    reduced over the model ranks (the (B, S, V) logits are never gathered)."""
    logits = logits.float()
    if v0 is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    else:
        top = all_reduce_max(logits.detach().amax(dim=-1))
        logz = top + torch.log(reduce(torch.exp(logits - top[..., None]).sum(dim=-1)))
        ids = targets.long() - v0
        mine = (ids >= 0) & (ids < logits.shape[-1])
        gold = torch.gather(logits, -1, torch.where(mine, ids, 0)[..., None])[..., 0]
        gold = reduce(torch.where(mine, gold, 0.0))
    return ((logz - gold) * mask).sum()


def _chunk_nll(x, head, targets, mask, v0=None):
    return _nll(x @ head, targets, mask, v0)


def _nll_sum(x, head, targets, mask, chunk: int = 0, v0=None):
    """The NLL summed over the rows of ``x``.  With ``chunk``, over sequence
    chunks, each chunk's logits recomputed in the backward
    (``torch.utils.checkpoint``), so the (B, S, V) logits never exist at
    once: minicpm-2b at 4 x 4096 would need 8 GB for them in fp32."""
    if chunk <= 0:
        return _chunk_nll(x, head, targets, mask, v0)
    S = x.shape[1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, S + pad, chunk):
        part = (x[:, c:c + chunk], head, targets[:, c:c + chunk], mask[:, c:c + chunk], v0)
        nll = nll + checkpoint(_chunk_nll, *part, use_reentrant=False)
    return nll


def _xent(params, x, targets, mask, cfg: ArchConfig, chunk: int = 0):
    """The mean masked CE of the head over the final hidden ``x`` (the
    residual stream's layout).  Over a model axis: the head split by
    vocabulary (its columns this rank's, over the whole sequence), or read
    whole on this rank's share of the sequence under sequence parallelism,
    the NLL summed over the model ranks."""
    head = params.head()
    owner = "embed" if cfg.tie_embeddings else "lm_head"
    if reads_block(params, owner):
        mi, _ = model_rank()
        v0 = mi * head.shape[1]
        nll = _nll_sum(constrain(x, "btf"), head, targets, mask, chunk, v0)
    elif seq_parallel():
        nll = reduce(_nll_sum(x, head, seq_share(targets), seq_share(mask), chunk))
    else:
        nll = _nll_sum(x, head, targets, mask, chunk)
    return nll / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, batch, cfg: ArchConfig, remat: str = "full", loss_chunk: int = 0,
            aux_weight: float = 0.01):
    """Scalar training loss (+ metrics dict), grad-enabled; ``batch`` holds
    tensors on the model's device.  On the card every family's kernels
    have their backward kernels (``kernels/ops.py``); attention's takes every
    head dim from 1 to 256, so every family trains there."""
    transformer.require_ported(cfg)
    x, aux = _hidden(params, batch, cfg, remat)
    if cfg.family == "audio":
        targets = batch["labels"]
        loss = _xent(params, x, targets, torch.ones(targets.shape, device=x.device), cfg)
        return loss, {"xent": loss}

    tokens = batch["tokens"]
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    # the recurrent stacks take the full CE, as in the reference
    chunk = loss_chunk if cfg.family not in ("ssm", "hybrid") else 0
    loss = _xent(params, x, targets, mask, cfg, chunk)
    total = loss + aux_weight * aux
    return total, {"xent": loss, "aux": aux}
