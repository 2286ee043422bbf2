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
policy but ``"none"``.  On the card both scans train through their
backward kernels (``kernels.mamba_scan.SelectiveScanFn``,
``kernels.rglru_scan.LruScanFn``), and Griffin's local attention through
the attention backward at head dim 256 with its window.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig, cache_specs, torch_dtype
from . import layers as L
from .transformer import _remat, as_built, cache_shares


class _LM(nn.Module):
    """Embedding, final norm and a separate ``lm_head``, as both reference
    inits have; subclasses add the layers."""

    def __init__(self, cfg: ArchConfig, gen, device, place):
        super().__init__()
        self.cfg = cfg
        dt = torch_dtype(cfg.param_dtype)
        self.embed = L.parameter(
            L.truncated_normal(gen, (cfg.vocab, cfg.d_model), 0.02, dt, device)
        )
        self.final_norm = L.parameter(torch.zeros(cfg.d_model, dtype=dt, device=device))
        self.lm_head = L.parameter(L.dense_init(gen, cfg.d_model, cfg.vocab, dt, device))
        place(self, "")

    def head(self) -> torch.Tensor:
        return self.lm_head


def _embed(params, cfg, tokens):
    return L.embed(params, tokens, torch_dtype(cfg.activation_dtype))


def _stacked(cfg, batch, seq_len, layers: dict) -> dict:
    """name -> each layer's state in order -> the cache, each leaf stacked
    over the layers in ``cache_specs``' dtype.  Under a mesh the states are
    this rank's (its rows and channels, its share of the ring's slots), so
    the leaves take their shapes from them."""
    specs = cache_specs(cfg, batch, seq_len)
    return {name: torch.stack(states).to(specs[name][1]) for name, states in layers.items()}


# ---------------------------------------------------------------------------
# Falcon-Mamba (ssm)
# ---------------------------------------------------------------------------


class MambaLM(_LM):
    """``init_mamba_params``: ``blocks`` is one ``layers.Mamba`` per layer;
    ``place`` as in ``transformer.Transformer``."""

    def __init__(self, cfg: ArchConfig, seed: int, device: torch.device, place=None):
        place = place or as_built
        gen = L.generator(seed, device)
        super().__init__(cfg, gen, device, place)
        self.blocks = nn.ModuleList(place(L.Mamba(cfg, gen, device), f"blocks.{i}.")
                                    for i in range(cfg.n_layers))


def _mamba_layer(blk, x, cfg):
    y, _ = L.mamba_block(blk, L.rms_norm(x, blk.norm), cfg)
    return x + y


def mamba_hidden(params: MambaLM, cfg: ArchConfig, tokens, remat: str = "full"):
    """Full-sequence forward up to the final norm -> x (B, S, d_model) in
    the residual stream's layout, grad-enabled."""
    x = _embed(params, cfg, tokens)
    layer = _remat(_mamba_layer, "none" if remat == "none" else "full")
    for blk in params.blocks:
        x = layer(blk, x, cfg)
    return L.rms_norm(x, params.final_norm)


@torch.no_grad()
def mamba_forward(params: MambaLM, cfg: ArchConfig, tokens):
    """Full-sequence forward -> (logits (B, S, V), aux_loss 0)."""
    x = mamba_hidden(params, cfg, tokens, remat="none")
    return L.head_logits(params, x), torch.zeros((), dtype=torch.float32, device=x.device)


@torch.no_grad()
def mamba_prefill(params: MambaLM, cfg: ArchConfig, tokens):
    """-> (last-token logits (B, V), cache {"conv", "ssm"} per ``cache_specs``).
    Under a mesh: this rank's rows, its logits whole over the vocabulary,
    its states over its channels where the layers split them."""
    x = _embed(params, cfg, tokens)
    B, S = tokens.shape
    states = {"conv": [], "ssm": []}
    for blk in params.blocks:
        y, st = L.mamba_block(blk, L.rms_norm(x, blk.norm), cfg)
        x = x + y
        states["conv"].append(st["conv"])
        states["ssm"].append(st["ssm"])
    x = L.rms_norm(L.last_position(x), params.final_norm)
    return L.head_logits(params, x), _stacked(cfg, B, S, states)


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
    return L.head_logits(params, x), cache


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

    def __init__(self, cfg: ArchConfig, seed: int, device: torch.device, place=None):
        place = place or as_built
        gen = L.generator(seed, device)
        super().__init__(cfg, gen, device, place)
        kinds = [RecLayer, RecLayer, AttnLayer] * n_blocks(cfg) + [RecLayer] * len(cfg.tail_pattern)
        self.layers = nn.ModuleList(place(kind(cfg, gen, device), f"layers.{j}.")
                                    for j, kind in enumerate(kinds))


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
    """Full-sequence forward up to the final norm -> x (B, S, d_model) in
    the residual stream's layout, grad-enabled."""
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
    return L.head_logits(params, x), torch.zeros((), dtype=torch.float32, device=x.device)


@torch.no_grad()
def griffin_prefill(params: GriffinLM, cfg: ArchConfig, tokens):
    """-> (last-token logits (B, V), cache {"lru", "conv", "k", "v"}).

    The K/V cache keeps the last ``min(attn_window, S)`` positions as a ring
    buffer (slot = pos % window), so decode continues in place.  Below the
    window the cache is S long and decode's write clamps to its last slot,
    as the reference's does (``layers.attention_decode``).  Under a mesh:
    this rank's rows, its logits whole over the vocabulary, its RG-LRU
    states over its channels, and every KV head over its share of the
    ring's slots, the ring laid out in slot order first.
    """
    x = _embed(params, cfg, tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None, :]
    window = min(cfg.attn_window, S)
    roll = -((S - window) % window)
    ring_shape = cache_shares(cfg, B, S)["k"][0][1:]
    states = {"lru": [], "conv": [], "k": [], "v": []}
    for lyr in params.layers:
        if isinstance(lyr, AttnLayer):
            x, k, v = _attn_layer_apply(lyr, x, cfg, positions)
            for name, t in (("k", k), ("v", v)):
                ring = torch.zeros(ring_shape, dtype=t.dtype, device=t.device)
                L.cache_kv(ring, torch.roll(t[:, :, S - window:], roll, dims=2),
                           cfg.n_kv_heads, "k")
                states[name].append(ring)
        else:
            x, st = _rec_layer_apply(lyr, x, cfg)
            states["lru"].append(st["lru"])
            states["conv"].append(st["conv"])
    x = L.rms_norm(L.last_position(x), params.final_norm)
    return L.head_logits(params, x), _stacked(cfg, B, S, states)


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
    return L.head_logits(params, x), cache
