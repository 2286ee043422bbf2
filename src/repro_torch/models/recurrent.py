"""Recurrent stacks: Falcon-Mamba (pure Mamba-1 SSM, family ``ssm``) and
RecurrentGemma / Griffin (RG-LRU + local attention in a 2:1 pattern, family
``hybrid``); the counterpart of ``repro.models.recurrent``.

The reference scans stacked layer weights; here each layer is one module and
a Python loop walks them in the reference's order.  Prefill and forward run
every scan from h = 0 through the kernels (``ops.selective_scan``,
``ops.lru_scan``) and Griffin's local attention through ``ops.attention``;
a decode step takes one plain step from the cached states, which it updates
in place (the reference returns new ones).

Training runs :func:`mamba_hidden` / :func:`griffin_hidden` (grad-enabled,
stopping before the head); any ``remat`` but ``"none"`` recomputes each
layer in the backward, as the reference checkpoints each block for any
policy but ``"none"``.  On the card the scans have no backward kernel yet,
so their wrappers raise under grad (``kernels/ops.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig, cache_specs, torch_dtype
from . import layers as L
from .transformer import _remat


class _LM(nn.Module):
    """Embedding, final norm and a separate ``lm_head``, as both reference
    inits have; subclasses add the layers."""

    def __init__(self, cfg: ArchConfig, gen, device):
        super().__init__()
        self.cfg = cfg
        dt = torch_dtype(cfg.param_dtype)
        self.embed = L.parameter(
            L.truncated_normal(gen, (cfg.vocab, cfg.d_model), 0.02, dt, device)
        )
        self.final_norm = L.parameter(torch.zeros(cfg.d_model, dtype=dt, device=device))
        self.lm_head = L.parameter(L.dense_init(gen, cfg.d_model, cfg.vocab, dt, device))

    def head(self) -> torch.Tensor:
        return self.lm_head


def _embed(params, cfg, tokens):
    return params.embed[tokens].to(torch_dtype(cfg.activation_dtype))


def _zero_cache(cfg, batch, seq_len, device):
    return {
        name: torch.zeros(shape, dtype=dt, device=device)
        for name, (shape, dt) in cache_specs(cfg, batch, seq_len).items()
    }


# ---------------------------------------------------------------------------
# Falcon-Mamba (ssm)
# ---------------------------------------------------------------------------


class MambaLM(_LM):
    """``init_mamba_params``: ``blocks`` is one ``layers.Mamba`` per layer."""

    def __init__(self, cfg: ArchConfig, seed: int, device: torch.device):
        gen = torch.Generator(device=device).manual_seed(seed)
        super().__init__(cfg, gen, device)
        self.blocks = nn.ModuleList(L.Mamba(cfg, gen, device) for _ in range(cfg.n_layers))


def _mamba_layer(blk, x, cfg):
    y, _ = L.mamba_block(blk, L.rms_norm(x, blk.norm), cfg)
    return x + y


def mamba_hidden(params: MambaLM, cfg: ArchConfig, tokens, remat: str = "full"):
    """Full-sequence forward up to the final norm -> x (B, S, d_model),
    grad-enabled."""
    x = _embed(params, cfg, tokens)
    layer = _remat(_mamba_layer, "none" if remat == "none" else "full")
    for blk in params.blocks:
        x = layer(blk, x, cfg)
    return L.rms_norm(x, params.final_norm)


@torch.no_grad()
def mamba_forward(params: MambaLM, cfg: ArchConfig, tokens):
    """Full-sequence forward -> (logits (B, S, V), aux_loss 0)."""
    x = mamba_hidden(params, cfg, tokens, remat="none")
    return x @ params.lm_head, torch.zeros((), dtype=torch.float32, device=x.device)


@torch.no_grad()
def mamba_prefill(params: MambaLM, cfg: ArchConfig, tokens):
    """-> (last-token logits (B, V), cache {"conv", "ssm"} per ``cache_specs``)."""
    x = _embed(params, cfg, tokens)
    B, S = tokens.shape
    cache = _zero_cache(cfg, B, S, x.device)
    for i, blk in enumerate(params.blocks):
        y, st = L.mamba_block(blk, L.rms_norm(x, blk.norm), cfg)
        x = x + y
        cache["conv"][i] = st["conv"]
        cache["ssm"][i] = st["ssm"]
    x = L.rms_norm(x[:, -1], params.final_norm)
    return x @ params.lm_head, cache


@torch.no_grad()
def mamba_decode_step(params: MambaLM, cfg: ArchConfig, token, pos, cache):
    """One decode step; ``pos`` is unused, as in the reference.  Updates
    ``cache`` in place and returns (logits (B, V), cache)."""
    x = _embed(params, cfg, token)
    for i, blk in enumerate(params.blocks):
        state = {"conv": cache["conv"][i], "ssm": cache["ssm"][i]}
        y, st = L.mamba_block(blk, L.rms_norm(x, blk.norm)[:, None], cfg, state=state)
        x = x + y[:, 0]
        cache["conv"][i] = st["conv"]
        cache["ssm"][i] = st["ssm"]
    x = L.rms_norm(x, params.final_norm)
    return x @ params.lm_head, cache


# ---------------------------------------------------------------------------
# RecurrentGemma / Griffin (hybrid)
# ---------------------------------------------------------------------------


class RecLayer(nn.Module):
    """``_init_rec_layer``: an RG-LRU block and an MLP."""

    def __init__(self, cfg, gen, device):
        super().__init__()
        self.rec = L.RGLRU(cfg, gen, device)
        self.mlp = L.MLP(cfg, gen, device)


class AttnLayer(nn.Module):
    """``_init_attn_layer``: local attention and an MLP."""

    def __init__(self, cfg, gen, device):
        super().__init__()
        self.attn = L.Attention(cfg, gen, device)
        self.mlp = L.MLP(cfg, gen, device)


class GriffinLM(_LM):
    """``init_griffin_params``: ``layers`` holds, for each of the
    ``n_layers // 3`` blocks, two ``RecLayer``s and an ``AttnLayer``, then
    one ``RecLayer`` for each entry of ``tail_pattern``, in that order."""

    def __init__(self, cfg: ArchConfig, seed: int, device: torch.device):
        gen = torch.Generator(device=device).manual_seed(seed)
        super().__init__(cfg, gen, device)
        layers = []
        for _ in range(n_blocks(cfg)):
            layers += [RecLayer(cfg, gen, device), RecLayer(cfg, gen, device),
                       AttnLayer(cfg, gen, device)]
        layers += [RecLayer(cfg, gen, device) for _ in cfg.tail_pattern]
        self.layers = nn.ModuleList(layers)


def n_blocks(cfg: ArchConfig) -> int:
    return cfg.n_layers // len(cfg.block_pattern)


def _rec_layer_apply(lyr, h, cfg, state=None):
    y, st = L.rglru_block(lyr.rec, L.rms_norm(h, lyr.rec.norm), cfg, state=state)
    h = h + y
    h = h + L.mlp(lyr.mlp, L.rms_norm(h, lyr.mlp.norm))
    return h, st


def _attn_layer_apply(lyr, h, cfg, positions):
    """-> (new h, k, v), k/v the rotated keys and values as (B, KV, S, D)."""
    att, k, v = L.attention(
        lyr.attn, L.rms_norm(h, lyr.attn.norm), cfg,
        causal=True, window=cfg.attn_window, positions=positions,
    )
    h = h + att
    h = h + L.mlp(lyr.mlp, L.rms_norm(h, lyr.mlp.norm))
    return h, k, v


def _griffin_layer(lyr, x, cfg, positions):
    if isinstance(lyr, AttnLayer):
        return _attn_layer_apply(lyr, x, cfg, positions)[0]
    return _rec_layer_apply(lyr, x, cfg)[0]


def griffin_hidden(params: GriffinLM, cfg: ArchConfig, tokens, remat: str = "full"):
    """Full-sequence forward up to the final norm -> x (B, S, d_model),
    grad-enabled."""
    x = _embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    layer = _remat(_griffin_layer, "none" if remat == "none" else "full")
    for lyr in params.layers:
        x = layer(lyr, x, cfg, positions)
    return L.rms_norm(x, params.final_norm)


@torch.no_grad()
def griffin_forward(params: GriffinLM, cfg: ArchConfig, tokens):
    """Full-sequence forward -> (logits (B, S, V), aux_loss 0)."""
    x = griffin_hidden(params, cfg, tokens, remat="none")
    return x @ params.lm_head, torch.zeros((), dtype=torch.float32, device=x.device)


@torch.no_grad()
def griffin_prefill(params: GriffinLM, cfg: ArchConfig, tokens):
    """-> (last-token logits (B, V), cache {"lru", "conv", "k", "v"}).

    The K/V cache keeps the last ``min(attn_window, S)`` positions as a ring
    buffer (slot = pos % window), so decode continues in place.  Below the
    window the cache is S long and decode's write clamps to its last slot,
    as the reference's does (``layers.attention_decode``).
    """
    x = _embed(params, cfg, tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None, :]
    window = min(cfg.attn_window, S)
    roll = -((S - window) % window)
    cache = _zero_cache(cfg, B, S, x.device)
    i_rec = i_attn = 0
    for lyr in params.layers:
        if isinstance(lyr, AttnLayer):
            x, k, v = _attn_layer_apply(lyr, x, cfg, positions)
            cache["k"][i_attn] = torch.roll(k[:, :, S - window:], roll, dims=2)
            cache["v"][i_attn] = torch.roll(v[:, :, S - window:], roll, dims=2)
            i_attn += 1
        else:
            x, st = _rec_layer_apply(lyr, x, cfg)
            cache["lru"][i_rec] = st["lru"]
            cache["conv"][i_rec] = st["conv"]
            i_rec += 1
    x = L.rms_norm(x[:, -1], params.final_norm)
    return x @ params.lm_head, cache


@torch.no_grad()
def griffin_decode_step(params: GriffinLM, cfg: ArchConfig, token, pos, cache):
    """One decode step.  The cache's ``lru`` and ``conv`` hold the 2 *
    n_blocks main recurrent layers first, then the tail, which is the order
    the layers are walked in.  Updates ``cache`` in place and returns
    (logits (B, V), cache)."""
    x = _embed(params, cfg, token)
    i_rec = i_attn = 0
    for lyr in params.layers:
        if isinstance(lyr, AttnLayer):
            att, _, _ = L.attention_decode(
                lyr.attn, L.rms_norm(x, lyr.attn.norm), cache["k"][i_attn],
                cache["v"][i_attn], pos, cfg, window=cfg.attn_window,
            )
            x = x + att
            x = x + L.mlp(lyr.mlp, L.rms_norm(x, lyr.mlp.norm))
            i_attn += 1
        else:
            state = {"lru": cache["lru"][i_rec], "conv": cache["conv"][i_rec]}
            h, st = _rec_layer_apply(lyr, x[:, None], cfg, state=state)
            x = h[:, 0]
            cache["lru"][i_rec] = st["lru"]
            cache["conv"][i_rec] = st["conv"]
            i_rec += 1
    x = L.rms_norm(x, params.final_norm)
    return x @ params.lm_head, cache
