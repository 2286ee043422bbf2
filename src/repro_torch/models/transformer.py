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
from ..parallel.act_sharding import cache_share, constrain, gather_seq
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
    ``place(module, prefix)`` (see :func:`models.lm.init`) is called on the
    embedding as soon as it is drawn, on each block as soon as it is built,
    and on the model at the end.
    """

    def __init__(self, cfg: ArchConfig, seed: int, device: torch.device, place=None):
        super().__init__()
        require_ported(cfg)
        self.cfg = cfg
        place = place or as_built
        dt = torch_dtype(cfg.param_dtype)
        gen = L.generator(seed, device)
        if cfg.family == "audio":
            self.register_parameter("embed", None)
        else:
            self.embed = L.parameter(
                L.truncated_normal(gen, (cfg.vocab, cfg.d_model), 0.02, dt, device)
            )
            place(self, "")
        self.blocks = nn.ModuleList(
            place((CrossBlock if is_cross_layer(cfg, i) else Block)(cfg, gen, device),
                  f"blocks.{i}.")
            for i in range(cfg.n_layers)
        )
        self.final_norm = L.parameter(torch.zeros(cfg.d_model, dtype=dt, device=device))
        if cfg.tie_embeddings:
            self.register_parameter("lm_head", None)
        else:
            self.lm_head = L.parameter(L.dense_init(gen, cfg.d_model, cfg.vocab, dt, device))
        place(self, "")

    def head(self) -> torch.Tensor:
        # The config, not ``lm_head``, says which: reading a placed
        # parameter gathers it.
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


def as_built(module, prefix: str):
    """The default ``place`` hook of the models' constructors: the module as
    it was built, on its device."""
    return module


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
    return L.embed(params, tokens, torch_dtype(cfg.activation_dtype))


def _inputs(params, cfg, tokens, frames, image_embeds):
    """The residual stream's input in its layout (token embeddings, or
    ``audio``'s frames in the activation dtype) and the image in the same
    dtype (or None)."""
    if cfg.family == "vlm" and image_embeds is None:
        raise ValueError(f"{cfg.name}: the cross-attention layers need image_embeds")
    if cfg.family == "audio":
        x = constrain(frames.to(torch_dtype(cfg.activation_dtype)), "btd")
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
    """Full-sequence forward up to the final norm -> (x (B, S, d_model) in
    the residual stream's layout, aux_loss), grad-enabled.  Self blocks run
    under ``remat``; a VLM's cross blocks are not rematerialized, as in the
    reference."""
    x, img = _inputs(params, cfg, tokens, frames, image_embeds)
    S = (frames if tokens is None else tokens).shape[1]  # the stream may hold a share
    positions = torch.arange(S, device=x.device)[None, :]
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
    """Full-sequence forward -> (logits (B, S, V), aux_loss); the logits are
    whole on every model rank (``layers.head_logits``)."""
    x, aux = hidden_forward(params, cfg, tokens, frames, image_embeds, remat="none")
    return L.head_logits(params, x), aux


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode
# ---------------------------------------------------------------------------


def cache_shares(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """``cache_specs(cfg, batch, seq_len)`` as this rank holds it: a cache
    whose positions the installed policy splits over the model axis
    (``act_sharding.cache_share``) keeps its share of them."""
    out = {}
    for name, (shape, dt) in cache_specs(cfg, batch, seq_len).items():
        if name in ("k", "v", "xk", "xv"):
            _, n = cache_share(name[:-1] + "k")
            shape = shape[:3] + (shape[3] // n,) + shape[4:]
        out[name] = (shape, dt)
    return out


@torch.no_grad()
def prefill(params: Transformer, cfg: ArchConfig, tokens, image_embeds=None, pad_to: int = 0):
    """Full-sequence forward that also fills the KV cache.

    The cache is allocated at ``max(pad_to, S)`` positions from the start, so
    decode can append without a copy.  Returns (last-token logits (B, V),
    cache as in ``cache_specs``: {"k", "v"} of (n_self, B, KV, T, D), and for
    the VLM {"xk", "xv"} of (n_cross, B, KV, img_tokens, D), the image's
    keys and values).

    Under a mesh (``train.steps.jit_serve_step``) each rank gets its rows of
    the batch and returns their logits, whole over the vocabulary; the
    layers compute its heads, columns and experts, the stream holding its
    share of the sequence under sequence parallelism (the last position
    comes from the last model rank).  Its cache holds its rows, and every
    KV head over its share of the positions where the policy splits them
    (``cache_shares``; ``layers.cache_kv`` moves them there).
    """
    x, img = _inputs(params, cfg, tokens, None, image_embeds)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None, :]
    cache = {
        name: torch.zeros(shape, dtype=dt, device=x.device)
        for name, (shape, dt) in cache_shares(cfg, B, max(pad_to, S)).items()
    }
    for blk, cross, i in _layers(params):
        if cross:
            x, k, v = _cross_block_apply(blk, x, img, cfg)
            L.cache_kv(cache["xk"][i], k, cfg.n_kv_heads, "xk")
            L.cache_kv(cache["xv"][i], v, cfg.n_kv_heads, "xk")
        else:
            x, _, k, v = _self_block_apply(blk, x, cfg, positions)
            L.cache_kv(cache["k"][i], k, cfg.n_kv_heads, "k")
            L.cache_kv(cache["v"][i], v, cfg.n_kv_heads, "k")
    x = L.rms_norm(L.last_position(x), params.final_norm)
    return L.head_logits(params, x), cache


def _cross_decode(blk, x, xk, xv, cfg):
    """One token's cross-attention against the cached image K/V (no mask),
    in plain PyTorch as in the reference, then the MLP.  x: (B, d_model).
    A split attention gathers every head's query, and where the image's
    tokens are split over the model ranks their shares are combined
    (``layers.decode_softmax``)."""
    hd = cfg.hd
    B = x.shape[0]
    split, H, _, _ = L.head_share(blk.attn, cfg)
    q = constrain(L.rms_norm(x, blk.attn.xnorm), "btf" if split else "whole") @ blk.attn.wq
    if split:
        q = gather_seq(q, dim=1)
    qg = q.reshape(B, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, hd)
    scores = torch.einsum("bkgd,bktd->bkgt", qg, xk).float() / math.sqrt(hd)
    out = L.decode_softmax(scores, xv, shared=cache_share("xk")[1] > 1).reshape(B, -1)
    if split:
        out = L.own_heads(out, H, hd)
    h = x + _gate(blk, x) * constrain(out @ blk.attn.wo, "btd", partial=split)
    return h + L.mlp(blk.mlp, L.rms_norm(h, blk.mlp.norm))


@torch.no_grad()
def decode_step(params: Transformer, cfg: ArchConfig, token, pos, cache):
    """One decode step.  token: (B,) int; pos: int; cache per ``prefill``.

    Updates ``cache`` in place (each self layer writes its slot at ``pos``)
    and returns (logits (B, V), cache).

    Under a mesh each rank takes its rows and its cache, as ``prefill``
    left them, and returns its rows' logits whole over the vocabulary.  A
    decode token has no sequence to split: the step runs without sequence
    parallelism, every (B, d_model) tensor whole on every model rank.
    Attention gathers every head's query, the rank holding the slot writes
    it, and each rank attends over its share of the positions, the shares
    combined over the model ranks (flash-decoding).
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
    return L.head_logits(params, x), cache
