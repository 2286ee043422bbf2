"""Transformer stacks: the dense (llama-arch), MoE (qwen3-arch), VLM
(cross-attention image blocks) and encoder-only audio (hubert) families of
``repro.models.transformer``.

The reference scans stacked layer weights; here the layers are a
``ModuleList`` walked by a Python loop.  The VLM's list holds its layers in
order: each ``cross_attn_every``-th layer is a :class:`CrossBlock`, the
others :class:`Block`s, as the reference's (n_super, inner) self stack and
(n_super,) cross stack interleave.  The recurrent families (``ssm``,
``hybrid``) live in ``models.recurrent``; DLRM (``recsys``) is no LM and
raises ``NotImplementedError`` saying where it lives.

Training runs :func:`hidden_forward` (grad-enabled, stopping before the
head) with ``remat`` ``"full"`` (each self block recomputed in the
backward, ``torch.utils.checkpoint``), ``"dots"`` (the same, keeping the
matmul outputs) or ``"none"``; serving's :func:`forward` runs it under
``torch.no_grad``.
"""

from __future__ import annotations

import math
from functools import partial

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..configs.base import ArchConfig, cache_specs, torch_dtype
from . import layers as L

# Why the LM facade takes no config of the other families.
NOT_PORTED = {
    "recsys": "DLRM is no LM, and this facade takes it no more than repro.models.lm "
              "does: it lives in repro_torch.models.dlrm (init, forward, loss_fn)",
}


PORTED = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def require_ported(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED:
        why = NOT_PORTED.get(cfg.family, "not ported yet: ROADMAP.md queue 1")
        raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} family: {why}")


def is_cross_layer(cfg: ArchConfig, i: int) -> bool:
    """Whether layer ``i`` of a VLM is a cross-attention block: the last of
    each ``cross_attn_every`` layers."""
    every = cfg.cross_attn_every
    return cfg.family == "vlm" and i % every == every - 1


class Block(nn.Module):
    """``init_self_block``: attention, then an MLP (GELU for ``audio``) or
    (``moe`` family) experts."""

    def __init__(self, cfg, gen, device):
        super().__init__()
        self.attn = L.Attention(cfg, gen, device)
        if cfg.family == "moe":
            self.moe = L.MoE(cfg, gen, device)
        else:
            kind = "gelu" if cfg.family == "audio" else "swiglu"
            self.mlp = L.MLP(cfg, gen, device, kind=kind)


class CrossBlock(nn.Module):
    """``init_cross_block``: gated cross-attention over the image, then a
    SwiGLU MLP."""

    def __init__(self, cfg, gen, device):
        super().__init__()
        self.attn = L.Attention(cfg, gen, device, cross=True)
        self.mlp = L.MLP(cfg, gen, device)


class Transformer(nn.Module):
    """Parameters of a transformer LM or encoder (``init_params`` in the
    reference); ``audio`` has no ``embed``.

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
        if cfg.family == "audio":
            self.register_parameter("embed", None)
        else:
            self.embed = L.parameter(
                L.truncated_normal(gen, (cfg.vocab, cfg.d_model), 0.02, dt, device)
            )
        self.blocks = nn.ModuleList(
            (CrossBlock if is_cross_layer(cfg, i) else Block)(cfg, gen, device)
            for i in range(cfg.n_layers)
        )
        self.final_norm = L.parameter(torch.zeros(cfg.d_model, dtype=dt, device=device))
        if cfg.tie_embeddings:
            self.register_parameter("lm_head", None)
        else:
            self.lm_head = L.parameter(L.dense_init(gen, cfg.d_model, cfg.vocab, dt, device))

    def head(self) -> torch.Tensor:
        return self.embed.T if self.lm_head is None else self.lm_head


def _self_block_apply(blk, x, cfg, positions):
    """One layer -> (new residual stream, aux loss, k, v), k/v as (B, KV, S, D).
    The audio encoder attends both ways, without rope."""
    att, k, v = L.attention(
        blk.attn, L.rms_norm(x, blk.attn.norm), cfg,
        causal=cfg.family != "audio", window=cfg.attn_window, positions=positions,
        use_rope=cfg.family != "audio",
    )
    h = x + att
    if hasattr(blk, "moe"):
        y, aux = L.moe(blk.moe, L.rms_norm(h, blk.moe.norm), cfg)
        return h + y, aux, k, v
    y = L.mlp(blk.mlp, L.rms_norm(h, blk.mlp.norm))
    return h + y, 0.0, k, v


def _gate(blk, x):
    return torch.tanh(blk.attn.gate.float()).to(x.dtype)


def _cross_block_apply(blk, x, img, cfg):
    """Gated cross-attention over the (unnormed) image, then the MLP ->
    (new residual stream, k, v) with the image's k/v as (B, KV, T, D)."""
    att, k, v = L.attention(blk.attn, L.rms_norm(x, blk.attn.xnorm), cfg, kv_x=img,
                            use_rope=False)
    h = x + _gate(blk, x) * att
    y = L.mlp(blk.mlp, L.rms_norm(h, blk.mlp.norm))
    return h + y, k, v


def _layers(params):
    """(block, is cross, its cache index) in layer order: self blocks count
    the ``k``/``v`` cache slots, cross blocks the ``xk``/``xv`` ones."""
    seen = [0, 0]
    for blk in params.blocks:
        cross = isinstance(blk, CrossBlock)
        yield blk, cross, seen[cross]
        seen[cross] += 1


def _embed(params, cfg, tokens):
    return params.embed[tokens].to(torch_dtype(cfg.activation_dtype))


def _inputs(params, cfg, tokens, frames, image_embeds):
    """The residual stream's input (token embeddings, or ``audio``'s frames
    in the activation dtype) and the image in the same dtype (or None)."""
    if cfg.family == "vlm" and image_embeds is None:
        raise ValueError(f"{cfg.name}: the cross-attention layers need image_embeds")
    if cfg.family == "audio":
        x = frames.to(torch_dtype(cfg.activation_dtype))
    else:
        x = _embed(params, cfg, tokens)
    img = None if image_embeds is None else image_embeds.to(x.dtype)
    return x, img


# Matmuls without batch dimensions: what JAX's
# ``dots_with_no_batch_dims_saveable`` keeps.  The attention and MoE
# products (``bmm``, or the kernels) are recomputed.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    policy = ckpt.CheckpointPolicy
    return policy.MUST_SAVE if op in _DOTS else policy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """``fn`` recomputed in the backward (``"full"``), the same keeping the
    matmul outputs (``"dots"``), or as it is (``"none"``): the reference's
    ``transformer._remat``."""
    if policy == "none":
        return fn
    if policy == "dots":
        ctx = partial(ckpt.create_selective_checkpoint_contexts, _save_dots)
        return partial(ckpt.checkpoint, fn, use_reentrant=False, context_fn=ctx)
    if policy == "full":
        return partial(ckpt.checkpoint, fn, use_reentrant=False)
    raise ValueError(f"remat {policy!r} not in ('full', 'dots', 'none')")


def _self_block(blk, x, cfg, positions):
    x, aux, _, _ = _self_block_apply(blk, x, cfg, positions)
    return x, aux


def hidden_forward(params: Transformer, cfg: ArchConfig, tokens=None, frames=None,
                   image_embeds=None, remat: str = "full"):
    """Full-sequence forward up to the final norm -> (x (B, S, d_model),
    aux_loss), grad-enabled.  Self blocks run under ``remat``; a VLM's cross
    blocks are not rematerialized, as in the reference."""
    x, img = _inputs(params, cfg, tokens, frames, image_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    self_block = _remat(_self_block, remat)
    for blk, cross, _ in _layers(params):
        if cross:
            x, _, _ = _cross_block_apply(blk, x, img, cfg)
        else:
            x, a = self_block(blk, x, cfg, positions)
            aux = aux + a
    return L.rms_norm(x, params.final_norm), aux


@torch.no_grad()
def forward(params: Transformer, cfg: ArchConfig, tokens=None, frames=None, image_embeds=None):
    """Full-sequence forward -> (logits (B, S, V), aux_loss)."""
    x, aux = hidden_forward(params, cfg, tokens, frames, image_embeds, remat="none")
    return x @ params.head(), aux


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill(params: Transformer, cfg: ArchConfig, tokens, image_embeds=None, pad_to: int = 0):
    """Full-sequence forward that also fills the KV cache.

    The cache is allocated at ``max(pad_to, S)`` positions from the start, so
    decode can append without a copy.  Returns (last-token logits (B, V),
    cache as in ``cache_specs``: {"k", "v"} of (n_self, B, KV, T, D), and for
    the VLM {"xk", "xv"} of (n_cross, B, KV, img_tokens, D), the image's
    keys and values).
    """
    x, img = _inputs(params, cfg, tokens, None, image_embeds)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None, :]
    cache = {
        name: torch.zeros(shape, dtype=dt, device=x.device)
        for name, (shape, dt) in cache_specs(cfg, B, max(pad_to, S)).items()
    }
    for blk, cross, i in _layers(params):
        if cross:
            x, k, v = _cross_block_apply(blk, x, img, cfg)
            cache["xk"][i] = k
            cache["xv"][i] = v
        else:
            x, _, k, v = _self_block_apply(blk, x, cfg, positions)
            cache["k"][i, :, :, :S] = k
            cache["v"][i, :, :, :S] = v
    x = L.rms_norm(x[:, -1], params.final_norm)
    return x @ params.head(), cache


def _cross_decode(blk, x, xk, xv, cfg):
    """One token's cross-attention against the cached image K/V (no mask),
    in plain PyTorch as in the reference, then the MLP.  x: (B, d_model)."""
    hd = cfg.hd
    B = x.shape[0]
    q = L.rms_norm(x, blk.attn.xnorm) @ blk.attn.wq
    qg = q.reshape(B, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, hd)
    scores = torch.einsum("bkgd,bktd->bkgt", qg, xk).float() / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", probs.to(xv.dtype), xv)
    h = x + _gate(blk, x) * (out.reshape(B, -1) @ blk.attn.wo)
    return h + L.mlp(blk.mlp, L.rms_norm(h, blk.mlp.norm))


@torch.no_grad()
def decode_step(params: Transformer, cfg: ArchConfig, token, pos, cache):
    """One decode step.  token: (B,) int; pos: int; cache per ``prefill``.

    Updates ``cache`` in place (each self layer writes its slot at ``pos``)
    and returns (logits (B, V), cache).
    """
    if cfg.is_encoder:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    x = _embed(params, cfg, token)
    for blk, cross, i in _layers(params):
        if cross:
            x = _cross_decode(blk, x, cache["xk"][i], cache["xv"][i], cfg)
            continue
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
