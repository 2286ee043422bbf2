"""Transformer stacks: the dense (llama-arch) and MoE (qwen3-arch) families
of ``repro.models.transformer``.

The reference scans stacked layer weights; here the layers are a
``ModuleList`` walked by a Python loop.  The recurrent families (``ssm``,
``hybrid``) live in ``models.recurrent``; the other families raise
``NotImplementedError`` saying where they are (DLRM: ``models.dlrm``) or
which ROADMAP item ports them.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig, cache_specs, torch_dtype
from . import layers as L

# Why the LM facade takes no config of the other families.
NOT_PORTED = {
    "recsys": "DLRM is no LM, and this facade takes it no more than repro.models.lm "
              "does: it lives in repro_torch.models.dlrm (init, forward, loss_fn)",
    "vlm": "not ported yet: ROADMAP.md queue 1, item 6 (VLM and audio families)",
    "audio": "not ported yet: ROADMAP.md queue 1, item 6 (VLM and audio families)",
}


PORTED = ("dense", "moe", "ssm", "hybrid")


def require_ported(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED:
        why = NOT_PORTED.get(cfg.family, "not ported yet: ROADMAP.md queue 1")
        raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} family: {why}")


class Block(nn.Module):
    """``init_self_block``: attention, then an MLP or (``moe`` family) experts."""

    def __init__(self, cfg, gen, device):
        super().__init__()
        self.attn = L.Attention(cfg, gen, device)
        if cfg.family == "moe":
            self.moe = L.MoE(cfg, gen, device)
        else:
            self.mlp = L.MLP(cfg, gen, device)


class Transformer(nn.Module):
    """Parameters of a decoder LM (``init_params`` in the reference).

    Weights are drawn on ``device`` from a ``torch.Generator`` seeded with
    ``seed``; the same seed gives other numbers than ``jax.random`` does,
    so tests copy the reference's weights in with ``weights.params_from_jax``.
    """

    def __init__(self, cfg: ArchConfig, seed: int, device: torch.device):
        super().__init__()
        require_ported(cfg)
        self.cfg = cfg
        dt = torch_dtype(cfg.param_dtype)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.embed = L.parameter(
            L.truncated_normal(gen, (cfg.vocab, cfg.d_model), 0.02, dt, device)
        )
        self.blocks = nn.ModuleList(Block(cfg, gen, device) for _ in range(cfg.n_layers))
        self.final_norm = L.parameter(torch.zeros(cfg.d_model, dtype=dt, device=device))
        if cfg.tie_embeddings:
            self.register_parameter("lm_head", None)
        else:
            self.lm_head = L.parameter(L.dense_init(gen, cfg.d_model, cfg.vocab, dt, device))

    def head(self) -> torch.Tensor:
        return self.embed.T if self.lm_head is None else self.lm_head


def _self_block_apply(blk, x, cfg, positions):
    """One layer -> (new residual stream, aux loss, k, v), k/v as (B, KV, S, D)."""
    att, k, v = L.attention(
        blk.attn, L.rms_norm(x, blk.attn.norm), cfg,
        causal=True, window=cfg.attn_window, positions=positions,
    )
    h = x + att
    if hasattr(blk, "moe"):
        y, aux = L.moe(blk.moe, L.rms_norm(h, blk.moe.norm), cfg)
        return h + y, aux, k, v
    y = L.mlp(blk.mlp, L.rms_norm(h, blk.mlp.norm))
    return h + y, 0.0, k, v


def _embed(params, cfg, tokens):
    return params.embed[tokens].to(torch_dtype(cfg.activation_dtype))


@torch.no_grad()
def forward(params: Transformer, cfg: ArchConfig, tokens):
    """Full-sequence forward -> (logits (B, S, V), aux_loss)."""
    x = _embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in params.blocks:
        x, a, _, _ = _self_block_apply(blk, x, cfg, positions)
        aux = aux + a
    x = L.rms_norm(x, params.final_norm)
    return x @ params.head(), aux


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill(params: Transformer, cfg: ArchConfig, tokens, pad_to: int = 0):
    """Full-sequence forward that also fills the KV cache.

    The cache is allocated at ``max(pad_to, S)`` positions from the start, so
    decode can append without a copy.  Returns (last-token logits (B, V),
    cache {"k", "v"} of (n_layers, B, KV, T, D) as in ``cache_specs``).
    """
    x = _embed(params, cfg, tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None, :]
    cache = {
        name: torch.zeros(shape, dtype=dt, device=x.device)
        for name, (shape, dt) in cache_specs(cfg, B, max(pad_to, S)).items()
    }
    for i, blk in enumerate(params.blocks):
        x, _, k, v = _self_block_apply(blk, x, cfg, positions)
        cache["k"][i, :, :, :S] = k
        cache["v"][i, :, :, :S] = v
    x = L.rms_norm(x[:, -1], params.final_norm)
    return x @ params.head(), cache


@torch.no_grad()
def decode_step(params: Transformer, cfg: ArchConfig, token, pos, cache):
    """One decode step.  token: (B,) int; pos: int; cache per ``prefill``.

    Updates ``cache`` in place (each layer writes its slot at ``pos``) and
    returns (logits (B, V), cache).
    """
    x = _embed(params, cfg, token)
    for i, blk in enumerate(params.blocks):
        att, _, _ = L.attention_decode(
            blk.attn, L.rms_norm(x, blk.attn.norm), cache["k"][i], cache["v"][i],
            pos, cfg, window=cfg.attn_window,
        )
        x = x + att
        if hasattr(blk, "moe"):  # N = B tokens of one position each
            y, _ = L.moe(blk.moe, L.rms_norm(x, blk.moe.norm)[:, None], cfg)
            x = x + y[:, 0]
        else:
            x = x + L.mlp(blk.mlp, L.rms_norm(x, blk.mlp.norm))
    x = L.rms_norm(x, params.final_norm)
    return x @ params.head(), cache
