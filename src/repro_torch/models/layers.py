"""Model primitives: the dense, MoE, cross-attention, GELU-MLP and recurrent
(Mamba-1, RG-LRU) layers of ``repro.models.layers``.

Each layer is ``f(params, inputs, cfg) -> out``, as in the reference, with
``params`` an ``nn.Module`` holding the reference's named weights in its
layouts: projections ``(d_in, d_out)``, activations ``(B, S, H, D)``, KV
caches ``(B, KV, T, D)``.  Norms and softmax accumulate in fp32; matmul
inputs are ``cfg.activation_dtype``.

Under a model axis of more than one rank (``train.steps.jit_train_step``)
a layer whose weights read as this rank's block
(``parallel.act_sharding.reads_block``) computes its own heads, MLP
columns, experts or channels: it takes the residual stream and returns its
output in the stream's layout, through ``constrain`` where it enters and
leaves its split compute; a layer whose units do not divide computes whole.
Without a policy every layer computes whole and ``constrain`` is the
identity.

Serving under a model axis (``train.steps.jit_serve_step``) keeps each KV
cache's positions split over the model ranks where the policy says so
(``act_sharding.cache_share``): prefill moves every KV head's keys and
values to the rank that holds their positions (:func:`cache_kv`), and a
decode step gathers every head's query, attends over the rank's positions
and combines the ranks' shares (:func:`decode_softmax`) before the rank's
heads go through the row-parallel ``wo``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import torch_dtype
from ..kernels import ops
from ..kernels.ref import NEG_INF
from ..parallel.act_sharding import (
    all_reduce_max, all_to_all, cache_share, constrain, enter, gather_batch, gather_seq,
    model_rank, reads_block, reduce, scatter_seq, seq_share,
)
from ..parallel.options import get_options


def generator(seed: int, device: torch.device):
    """The weights' ``torch.Generator`` on ``device``; None on ``meta``, where
    nothing is drawn (shapes only: ``models.lm.param_specs``)."""
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def truncated_normal_(t, gen, scale):
    """Fills ``t`` in place: standard normal truncated to [-2, 2], times
    ``scale``; a ``meta`` tensor has no values and is left as it is."""
    if t.is_meta:
        return t
    nn.init.trunc_normal_(t, a=-2.0, b=2.0, generator=gen)
    return t.mul_(scale)


def truncated_normal(gen, shape, scale, dtype, device):
    """Standard normal truncated to [-2, 2], times ``scale``, drawn in fp32."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return truncated_normal_(t, gen, scale).to(dtype)


def dense_init(gen, d_in, d_out, dtype, device, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return truncated_normal(gen, (d_in, d_out), scale, dtype, device)


def parameter(t):
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# Norms / positional
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if get_options().lowp_norm and dt != torch.float32:
        # statistics in fp32, elementwise scaling in the activation dtype.
        return x * scale.to(dt) * (1.0 + w.float()).to(dt)
    return (xf * scale * (1.0 + w.float())).to(dt)


def rope_frequencies(head_dim: int, theta: float, device=None):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: (..., S) int.  Split-half rotation."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)  # (D/2,)
    angles = positions[..., None].float() * freqs  # (..., S, D/2)
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed(params, tokens, dtype):
    """The token embeddings in the residual stream's layout.  Split over the
    model axis by vocabulary: a lookup in this rank's rows, zero for the
    tokens outside them, summed over the model ranks; read whole, under
    sequence parallelism, a lookup of this rank's share of the sequence."""
    if not reads_block(params, "embed"):
        return params.embed[seq_share(tokens)].to(dtype)
    table = params.embed
    mi, _ = model_rank()
    ids = tokens - mi * table.shape[0]
    mine = (ids >= 0) & (ids < table.shape[0])
    rows = table[torch.where(mine, ids, 0)].to(dtype)
    return constrain(torch.where(mine[..., None], rows, 0.0), "btd", partial=True)


def last_position(x):
    """The residual stream's last position (B, d_model), whole on every model
    rank: under sequence parallelism the last model rank's share holds it."""
    return constrain(x[:, -1:], "whole")[:, -1]


def head_logits(params, x):
    """The LM head over the final hidden ``x`` -> logits whole over the
    vocabulary on every model rank.  ``x``: (B, d_model), whole on every
    model rank, or (B, S, d_model) in the residual stream's layout (its
    shares gathered under sequence parallelism).  A head split by vocabulary
    makes this rank's columns, gathered over the model ranks."""
    if x.dim() == 3:
        x = constrain(x, "whole")
    logits = x @ params.head()
    split = reads_block(params, "embed" if params.cfg.tie_embeddings else "lm_head")
    return gather_seq(logits, dim=-1) if split else logits


# ---------------------------------------------------------------------------
# Attention (GQA; causal / bidirectional / sliding-window; self / cross)
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """``init_attention``'s weights; ``cross=True`` adds the Llama-3.2-vision
    gate (a scalar, zero at init) and ``xnorm``, and keeps ``norm``, which
    the cross block never reads, as the reference does."""

    def __init__(self, cfg, gen, device, cross: bool = False):
        super().__init__()
        dt, hd = torch_dtype(cfg.param_dtype), cfg.hd
        self.wq = parameter(dense_init(gen, cfg.d_model, cfg.n_heads * hd, dt, device))
        self.wk = parameter(dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dt, device))
        self.wv = parameter(dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dt, device))
        self.wo = parameter(dense_init(gen, cfg.n_heads * hd, cfg.d_model, dt, device))
        self.norm = parameter(torch.zeros(cfg.d_model, dtype=dt, device=device))
        if cross:
            self.gate = parameter(torch.zeros((), dtype=dt, device=device))
            self.xnorm = parameter(torch.zeros(cfg.d_model, dtype=dt, device=device))


def _split_heads(x, n_heads, head_dim):
    return x.reshape(*x.shape[:-1], n_heads, head_dim)


def head_share(p, cfg) -> tuple[bool, int, int, int | None]:
    """-> (split, H, KV, j): whether attention ``p`` computes this model
    rank's heads (its ``wq`` read as a block), its query heads' and KV
    heads' counts, and where ``wk``/``wv`` are read whole (every rank's
    query heads share one KV head) that head's index ``j``, else None."""
    if not reads_block(p, "wq"):
        return False, cfg.n_heads, cfg.n_kv_heads, None
    mi, tp = model_rank()
    H = cfg.n_heads // tp
    if reads_block(p, "wk"):
        return True, H, cfg.n_kv_heads // tp, None
    return True, H, 1, mi * H // (cfg.n_heads // cfg.n_kv_heads)


def _kv_weights(p, j, hd):
    """``p``'s ``wk`` and ``wv``, or their columns of KV head ``j``."""
    wk, wv = p.wk, p.wv
    if j is None:
        return wk, wv
    return wk[:, j * hd:(j + 1) * hd], wv[:, j * hd:(j + 1) * hd]


def _one_copy(t, n_kv: int, dim: int):
    """``t`` holding the KV heads of every model rank in rank order along
    ``dim``, a head held by several ranks (fewer KV heads than ranks) once
    a rank -> every KV head once, in order."""
    step = t.shape[dim] // n_kv
    return t if step == 1 else t[(slice(None),) * dim + (slice(None, None, step),)]


def all_kv_heads(t, n_kv: int, dim: int = 1):
    """``t`` holding a split attention's KV heads along ``dim`` (this model
    rank's, or the one its query heads share) -> every KV head, gathered
    over the model ranks; ``t`` itself where it holds them all."""
    return t if t.shape[dim] == n_kv else _one_copy(gather_seq(t, dim), n_kv, dim)


def own_heads(out, H: int, hd: int):
    """(B, n_heads * hd) -> this model rank's H heads' columns, which its
    block of ``wo`` reads."""
    mi, _ = model_rank()
    return out[:, mi * H * hd:(mi + 1) * H * hd]


def cache_kv(buf, k, n_kv: int, name: str) -> None:
    """Writes a prefill's keys (or values) into this rank's share of a cache.

    ``k``: (B, KVl, S, D), an attention's KV heads over the whole sequence:
    this model rank's where attention is split, else all of them.  ``buf``:
    (B, KV, Tl, D), every KV head over the positions [i * Tl, (i + 1) * Tl)
    of cache ``name``, where (i, n) is ``act_sharding.cache_share(name)``;
    the positions at and past S are left as they are.  Where both the heads
    and the positions are split, each rank sends each other rank its heads
    at that rank's positions (one all-to-all over the model axis)."""
    S, Tl = k.shape[2], buf.shape[2]
    i, n = cache_share(name)
    if k.shape[1] != n_kv:
        if n > 1:
            B, kv, _, D = k.shape
            k = F.pad(k, (0, 0, 0, n * Tl - S))
            parts = all_to_all(k.reshape(B, kv, n, Tl, D).movedim(2, 0))
            buf.copy_(_one_copy(parts.movedim(0, 1).reshape(B, n * kv, Tl, D), n_kv, 1))
            return
        k = all_kv_heads(k, n_kv)
    part = k[:, :, i * Tl:(i + 1) * Tl]
    buf[:, :, :part.shape[2]] = part


def decode_softmax(scores, v, shared: bool):
    """softmax(scores) @ v for one token: scores (B, KV, g, T) fp32, masked
    positions at ``NEG_INF``; v (B, KV, T, D) -> (B, KV, g, D), the
    probabilities cast to v's dtype as the reference casts them.
    ``shared``: the T positions are this model rank's share of the cache's;
    the max and the sum of exponentials are combined over the model ranks
    before the product and the products summed after, so a share without a
    valid position adds exact zeros (exp(NEG_INF - max) = 0)."""
    if shared:
        e = torch.exp(scores - all_reduce_max(scores.amax(dim=-1, keepdim=True)))
        probs = e / reduce(e.sum(dim=-1, keepdim=True))
    else:
        probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", probs.to(v.dtype), v)
    return reduce(out) if shared else out


def attention(p, x, cfg, *, causal=True, window=0, positions=None, kv_x=None,
              use_rope=True):
    """Self- or cross-attention over full sequences (train / prefill).

    x: (B, S, d_model), the residual stream; kv_x: (B, T, d_model) for
    cross-attention, whose keys and values come from it, unrotated and
    unmasked, as in the reference.
    Rope applies only to self-attention with ``use_rope``.  Returns (out
    (B, S, d_model) in the stream's layout, k, v) with k and v as (B, KV, T,
    D), this model rank's KV heads, which prefill caches.  Both attention impls of ``ModelOptions`` go through
    ``ops.attention``: the flash-attention kernel on the card, its plain
    version on the CPU.
    """
    hd = cfg.hd
    split, H, KV, j = head_share(p, cfg)
    wk, wv = _kv_weights(p, j, hd)
    x = constrain(x, "btf" if split else "whole")
    B, S, _ = x.shape
    src = x if kv_x is None else kv_x
    q = _split_heads(x @ p.wq, H, hd)
    k = _split_heads(src @ wk, KV, hd)
    v = _split_heads(src @ wv, KV, hd)
    if use_rope and kv_x is None:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if kv_x is not None:
        causal, window = False, 0
    k, v = k.transpose(1, 2), v.transpose(1, 2)  # (B, KV, T, D)
    out = ops.attention(q.transpose(1, 2), k, v, causal=causal, window=window)
    out = out.transpose(1, 2).reshape(B, S, H * hd)
    return constrain(out @ p.wo, "btd", partial=split), k, v


def attention_decode(p, x, cache_k, cache_v, pos, cfg, *, window: int = 0):
    """One-token decode against a KV cache, in plain PyTorch.

    x: (B, d_model); cache_k/v: (B, KV, T, D), or under a policy that splits
    the ``"k"`` cache's positions this rank's share of them (every KV head);
    pos: the current index.  Writes the new key and value into
    ``cache_k``/``cache_v`` in place on the rank whose share holds the slot
    (the reference returns updated copies) and returns (out (B, d_model),
    cache_k, cache_v).  A split attention gathers every head's query and
    the new KV heads over the model ranks and keeps its own heads' output
    for its block of ``wo``.
    """
    hd = cfg.hd
    B = x.shape[0]
    pos = int(pos)
    split, H, KV, j = head_share(p, cfg)
    wk, wv = _kv_weights(p, j, hd)
    x = constrain(x, "btf" if split else "whole")
    q = _split_heads(x @ p.wq, H, hd)
    k = _split_heads(x @ wk, KV, hd)
    v = _split_heads(x @ wv, KV, hd)
    posb = torch.full((B, 1), pos, device=x.device)
    q = apply_rope(q[:, None], posb, cfg.rope_theta)[:, 0]
    k = apply_rope(k[:, None], posb, cfg.rope_theta)[:, 0]
    if split:
        q = gather_seq(q, dim=1)
        k, v = all_kv_heads(k, cfg.n_kv_heads), all_kv_heads(v, cfg.n_kv_heads)

    i, n = cache_share("k")
    Tl = cache_k.shape[2]
    T, t0 = n * Tl, i * Tl
    rolling = window > 0 and window == T
    # Rolling window cache: slot = pos % window.  Otherwise slot = pos, clamped
    # to the last slot as the reference's lax.dynamic_update_slice clamps it
    # (a windowed cache shorter than the window, after a prompt shorter than
    # the window: the new key overwrites the last prompt key).
    slot = pos % T if rolling else min(pos, T - 1)
    if t0 <= slot < t0 + Tl:
        cache_k[:, :, slot - t0] = k.to(cache_k.dtype)
        cache_v[:, :, slot - t0] = v.to(cache_v.dtype)

    g = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, cfg.n_kv_heads, g, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bkgd,bktd->bkgt", qg, cache_k).float() * scale
    t_idx = torch.arange(t0, t0 + Tl, device=x.device)
    if rolling:
        valid = (t_idx <= slot) | (pos >= T)  # whole ring valid once wrapped
    else:
        valid = t_idx <= pos
    scores = torch.where(valid, scores, NEG_INF)
    out = decode_softmax(scores, cache_v, shared=n > 1).reshape(B, cfg.n_heads * hd)
    if split:
        out = own_heads(out, H, hd)
    return constrain(out @ p.wo, "btd", partial=split), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLPs (SwiGLU; GELU for the audio encoder)
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """``init_mlp``'s weights: ``wg``, ``wu``, ``wd`` (``kind="swiglu"``) or
    ``w1``, ``w2`` (``kind="gelu"``), and ``norm``."""

    def __init__(self, cfg, gen, device, kind: str = "swiglu"):
        super().__init__()
        dt, D, F_ = torch_dtype(cfg.param_dtype), cfg.d_model, cfg.d_ff
        self.swiglu = kind == "swiglu"
        if self.swiglu:
            self.wg = parameter(dense_init(gen, D, F_, dt, device))
            self.wu = parameter(dense_init(gen, D, F_, dt, device))
            self.wd = parameter(dense_init(gen, F_, D, dt, device))
        else:
            self.w1 = parameter(dense_init(gen, D, F_, dt, device))
            self.w2 = parameter(dense_init(gen, F_, D, dt, device))
        self.norm = parameter(torch.zeros(D, dtype=dt, device=device))


def mlp(p, x):
    """SwiGLU where ``p`` holds ``wg``, else GELU (``jax.nn.gelu``'s default,
    the tanh approximation), as the reference dispatches on ``"wg" in p``
    (``p.swiglu``: a placed module would gather ``wg`` to answer ``hasattr``).
    Split over the model axis: ``wg``/``wu``/``w1`` column-parallel,
    ``wd``/``w2`` row-parallel."""
    split = reads_block(p, "wg" if p.swiglu else "w1")
    x = constrain(x, "btf" if split else "whole")
    if p.swiglu:
        y = (F.silu(x @ p.wg) * (x @ p.wu)) @ p.wd
    else:
        y = F.gelu(x @ p.w1, approximate="tanh") @ p.w2
    return constrain(y, "btd", partial=split)


# ---------------------------------------------------------------------------
# Mixture-of-Experts (capacity-based token dropping, sort-based dispatch)
# ---------------------------------------------------------------------------


class MoE(nn.Module):
    """``init_moe``'s weights: the router stays fp32 whatever ``param_dtype`` is."""

    def __init__(self, cfg, gen, device):
        super().__init__()
        dt = torch_dtype(cfg.param_dtype)
        E, D, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
        s = 1.0 / math.sqrt(D)
        self.router = parameter(dense_init(gen, D, E, torch.float32, device))
        self.wg = parameter(truncated_normal(gen, (E, D, F_), s, dt, device))
        self.wu = parameter(truncated_normal(gen, (E, D, F_), s, dt, device))
        self.wd = parameter(truncated_normal(gen, (E, F_, D), 1.0 / math.sqrt(F_), dt, device))
        self.norm = parameter(torch.zeros(D, dtype=dt, device=device))


def moe(p, x, cfg):
    """Top-k routed MoE with per-expert capacity (GShard-style dropping).

    Step for step ``repro.models.layers.moe``: a stable sort of the (token,
    expert) entries, an (E, C, D) buffer, three grouped matmuls through
    ``ops.grouped_matmul``, then a weighted combine.  The buffer is filled
    by slot: slot c of expert e holds the c-th entry routed to e (the
    sort's entry ``starts[e] + c``), empty where e has c or fewer, so the
    dispatch gathers one row a slot and the combine adds one row a slot
    into its token, in the order of the reference's scatter-add (there a
    dropped entry adds 0, here an empty slot).  Nothing here waits on the
    device: counts are a ``scatter_add_``, empty slots are masked rather
    than indexed out.  Returns (out (B, S, D), aux_loss).

    Capacity, drops and the aux loss are functions of the global batch:
    under a policy whose data axes span several ranks
    (``parallel.act_sharding.gather_batch``) the layer routes the rows of
    every data rank, as one device routes the global batch, and returns its
    own rows.  Split over the model axis, every model rank routes and sorts
    all entries; its buffer, its dispatch and its combine hold only its own
    E/tp experts' slots, the grouped matmuls run at E/tp, and the combine's
    (N, D) addends are reduced over the model ranks.
    """
    split = reads_block(p, "wg")
    E, K = cfg.n_experts, cfg.top_k
    e0, El = 0, E
    if split:
        # This model rank's experts; the router and the sort run on every
        # model rank, on the stream's rows (gathered along the sequence under
        # sequence parallelism, its gradient this rank's share).
        mi, tp = model_rank()
        El = E // tp
        e0 = mi * El
        logits = constrain(x.float() @ p.router, "whole")
        x = constrain(x, "btf")
    else:
        x = constrain(x, "whole")
        logits = x.float() @ p.router
    x, rows = gather_batch(x)
    logits, _ = gather_batch(logits)
    B, S, D = x.shape
    N = B * S
    xt = x.reshape(N, D)

    probs = torch.softmax(logits.reshape(N, E), dim=-1)
    top_vals, top_idx = torch.topk(probs, K, dim=-1)  # (N, K)
    top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)

    flat_e = top_idx.reshape(-1)  # (N*K,)
    counts = torch.zeros(E, dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))

    # Load-balancing aux loss (Switch): E * sum_e f_e * p_e, where f_e, the
    # mean over tokens of the one-hot top-k sum, is counts / N.
    token_frac = counts.float() / N
    prob_frac = probs.mean(dim=0)
    aux = E * torch.sum(token_frac * prob_frac) / K

    C = max(1, int(cfg.capacity_factor * N * K / E))

    order = torch.argsort(flat_e, stable=True)  # as jnp.argsort: slots follow token order
    starts = torch.cumsum(counts, dim=0) - counts
    # This rank's (El * C) slots: the (token, k) entry each holds, the
    # sort's entry starts[e] + c.  An empty slot points at entry (its index
    # mod N*K), whose row it reads and adds masked to 0, so that no row is
    # read or added to by many slots (a hot row serializes the adds).
    mine = slice(e0, e0 + El)
    slot = torch.arange(C, device=x.device)
    filled = (slot < counts[mine, None]).reshape(-1)
    pos = torch.where(filled, (starts[mine, None] + slot).reshape(-1), 0)
    spare = torch.arange(El * C, device=x.device) % (N * K)
    entry = torch.where(filled, order[pos], spare)
    tok = entry // K

    buf = torch.where(filled[:, None], xt[tok], 0.0).view(El, C, D)
    h = F.silu(ops.grouped_matmul(buf, p.wg)) * ops.grouped_matmul(buf, p.wu)
    y = ops.grouped_matmul(h, p.wd)

    wts = top_vals.reshape(-1)
    if split:
        wts = enter(wts)  # each rank's gradient reaches its own entries' weights only
    wts = torch.where(filled, wts[entry], 0.0)
    # The combine in one order on every device, without atomics: the slots
    # sorted by token (stably, so each token's come in slot order, the
    # reference's order of adds; an empty slot adds an exact 0) and summed
    # a token at a time.  The lengths sum to the slots, so nothing checks
    # them on the host (``unsafe``).
    by_tok = torch.argsort(tok, stable=True)
    lengths = torch.zeros(N, dtype=torch.int64, device=x.device)
    lengths.scatter_add_(0, tok, torch.ones_like(tok))
    rows_out = (y.reshape(El * C, D) * wts[:, None].to(y.dtype))[by_tok]
    out = torch.segment_reduce(rows_out, "sum", lengths=lengths, unsafe=True)
    return constrain(out.reshape(B, S, D)[rows], "btd", partial=split), aux


# ---------------------------------------------------------------------------
# Linear recurrences: Mamba-1 and RG-LRU
# ---------------------------------------------------------------------------
#
# The reference's train/prefill path runs both recurrences through
# ``chunked_linear_scan`` (an associative scan).  Here prefill and forward
# start from h = 0 and go through ``ops.selective_scan`` / ``ops.lru_scan``
# (the CUDA kernels on the card, their plain sequential versions on the CPU);
# a step from a carried state (decode) is one plain step.


def causal_conv1d(x, w, prev=None):
    """Depthwise causal conv along time.  x: (B, L, D); w: (W, D).

    ``prev``: (B, W-1, D) carried context for decode.  Returns (out, new_prev)."""
    W = w.shape[0]
    if prev is None:
        prev = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([prev, x], dim=1)
    L = x.shape[1]
    out = xp[:, 0:L] * w[0]
    for i in range(1, W):
        out = out + xp[:, i : i + L] * w[i]
    new_prev = xp[:, -(W - 1):] if W > 1 else prev
    return out, new_prev


def _plain_scan_from(h, a, b):
    """``h_t = a_t * h_{t-1} + b_t`` from a carried ``h``, one step at a time
    (decode takes one); a, b: (B, L, ...) -> (h_all, h_last)."""
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


class Mamba(nn.Module):
    """``init_mamba``'s weights: ``b_dt``, ``a_log`` and ``d_skip`` stay fp32."""

    def __init__(self, cfg, gen, device):
        super().__init__()
        dt = torch_dtype(cfg.param_dtype)
        D, DI, ST, R = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
        f32 = torch.float32
        self.w_in = parameter(dense_init(gen, D, 2 * DI, dt, device))
        self.conv_w = parameter(
            truncated_normal(gen, (cfg.d_conv, DI), 1.0 / math.sqrt(cfg.d_conv), dt, device)
        )
        self.conv_b = parameter(torch.zeros(DI, dtype=dt, device=device))
        self.w_xdbc = parameter(dense_init(gen, DI, R + 2 * ST, dt, device))
        self.w_dt = parameter(dense_init(gen, R, DI, dt, device))
        self.b_dt = parameter(torch.full((DI,), -4.6, dtype=f32, device=device))  # softplus^-1(0.01)
        a_init = torch.arange(1, ST + 1, dtype=f32, device=device).log().repeat(DI, 1)
        self.a_log = parameter(a_init)
        self.d_skip = parameter(torch.ones(DI, dtype=f32, device=device))
        self.w_out = parameter(dense_init(gen, DI, D, dt, device))
        self.norm = parameter(torch.zeros(D, dtype=dt, device=device))


def mamba_ssm(p, xc, cfg, h0=None, split: bool = False):
    """Selective scan given the post-conv activations xc: (B, L, DI).

    ``h0`` None: the scan from h = 0 through ``ops.selective_scan`` (under
    grad its backward kernel gives all six gradients).  Otherwise plain steps
    from ``h0`` (decode).  ``split``: xc holds this model rank's channels,
    ``w_xdbc`` its rows, whose product is summed over the model ranks.
    Returns (y (B, L, DI) in xc's dtype, h_last (B, DI, ST) fp32)."""
    ST, R = cfg.ssm_state, cfg.dt_rank_
    xdbc = xc @ p.w_xdbc
    if split:
        # Every rank's channels read dt_r, b and c: an all-reduce both ways.
        xdbc = enter(reduce(xdbc))
    dt_r, b_ssm, c_ssm = xdbc[..., :R], xdbc[..., R : R + ST], xdbc[..., R + ST :]
    dt = F.softplus((dt_r @ p.w_dt).float() + p.b_dt)  # (B, L, DI)
    a = -torch.exp(p.a_log)  # (DI, ST)
    if h0 is None:
        y, h_last = ops.selective_scan(xc, dt, a, b_ssm, c_ssm, p.d_skip)
        return y.to(xc.dtype), h_last
    xf = xc.float()
    decay = torch.exp(dt[..., None] * a)  # (B, L, DI, ST)
    drive = (dt * xf)[..., None] * b_ssm.float()[:, :, None, :]
    h_all, h_last = _plain_scan_from(h0, decay, drive)
    y = torch.einsum("blds,bls->bld", h_all, c_ssm.float()) + p.d_skip * xf
    return y.to(xc.dtype), h_last


def mamba_block(p, x, cfg, state=None):
    """Full Mamba-1 block.  x: (B, L, D), the residual stream.  state: None
    (prefill / forward) or {'conv': (B, W-1, DI), 'ssm': (B, DI, ST)}
    (decode).  Returns (out in the stream's layout, new_state).  Split over
    the model axis each rank runs its DI/tp channels: ``w_in`` is read whole
    and the rank takes its channels of each of its x and z halves."""
    split = reads_block(p, "conv_w")
    x = constrain(x, "btf" if split else "whole")
    w_in = p.w_in
    if split:
        mi, tp = model_rank()
        di, n = cfg.d_inner, cfg.d_inner // tp
        w_in = torch.cat([w_in[:, mi * n:(mi + 1) * n], w_in[:, di + mi * n:di + (mi + 1) * n]],
                         dim=1)
    xi, z = (x @ w_in).chunk(2, dim=-1)
    prev = state["conv"] if state is not None else None
    xc, new_conv = causal_conv1d(xi, p.conv_w, prev)
    xc = F.silu(xc + p.conv_b)
    h0 = state["ssm"] if state is not None else None
    y, h_last = mamba_ssm(p, xc, cfg, h0=h0, split=split)
    y = y * F.silu(z)
    out = constrain(y @ p.w_out, "btd", partial=split)
    return out, {"conv": new_conv.to(x.dtype), "ssm": h_last}


class RGLRU(nn.Module):
    """``init_rglru``'s weights: ``lambda_p`` stays fp32."""

    def __init__(self, cfg, gen, device):
        super().__init__()
        dt = torch_dtype(cfg.param_dtype)
        D, DI = cfg.d_model, cfg.d_inner
        self.w_x = parameter(dense_init(gen, D, DI, dt, device))
        self.w_y = parameter(dense_init(gen, D, DI, dt, device))  # gelu branch
        self.conv_w = parameter(truncated_normal(gen, (4, DI), 0.5, dt, device))
        self.conv_b = parameter(torch.zeros(DI, dtype=dt, device=device))
        self.w_input_gate = parameter(dense_init(gen, DI, DI, dt, device))
        self.w_rec_gate = parameter(dense_init(gen, DI, DI, dt, device))
        # softplus domain
        self.lambda_p = parameter(torch.linspace(0.9, 5.0, DI, dtype=torch.float32, device=device))
        self.w_out = parameter(dense_init(gen, DI, D, dt, device))
        self.norm = parameter(torch.zeros(D, dtype=dt, device=device))


RGLRU_C = 8.0


def rglru_block(p, x, cfg, state=None):
    """Griffin recurrent block: conv1d -> RG-LRU, gated by a GeLU branch.

    x: (B, L, D), the residual stream; state: None or {'conv': (B, 3, DI),
    'lru': (B, DI) fp32}.  Returns (out in the stream's layout, new_state).
    Split over the model axis each rank runs its DI/tp channels: ``w_x`` and
    ``w_y`` column-parallel, the gates' rows its channels, their full-DI
    addends reduce-scattered onto its channels, ``w_out`` row-parallel."""
    split = reads_block(p, "w_x")
    x = constrain(x, "btf" if split else "whole")
    xb = x @ p.w_x
    yb = F.gelu(x @ p.w_y, approximate="tanh")  # jax.nn.gelu's default
    prev = state["conv"] if state is not None else None
    xc, new_conv = causal_conv1d(xb, p.conv_w, prev)
    xc = xc + p.conv_b

    gate_in, gate_rec = xc @ p.w_input_gate, xc @ p.w_rec_gate
    if split:
        gate_in, gate_rec = scatter_seq(gate_in, dim=-1), scatter_seq(gate_rec, dim=-1)
    i_gate = torch.sigmoid(gate_in.float())
    r_gate = torch.sigmoid(gate_rec.float())
    log_a = -RGLRU_C * r_gate * F.softplus(p.lambda_p)
    a = torch.exp(log_a)
    gated_x = i_gate * xc.float()
    drive = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * gated_x

    if state is None:
        h_all, h_last = ops.lru_scan(a, drive)
    else:
        h_all, h_last = _plain_scan_from(state["lru"], a, drive)
    out = constrain((h_all.to(x.dtype) * yb) @ p.w_out, "btd", partial=split)
    return out, {"conv": new_conv.to(x.dtype), "lru": h_last}
