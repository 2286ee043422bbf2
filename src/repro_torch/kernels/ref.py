"""Plain PyTorch versions of the port's kernels (the tests' oracles).

Line-for-line counterparts of ``repro.kernels.ref``: the CPU path of each
wrapper in :mod:`repro_torch.kernels.ops`, and what ``chip_smoke.py`` holds
each CUDA kernel against on the card.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_mask(Sq, Sk, causal, window, device=None):
    """(Sq, Sk) bool: True where query row i may see key j."""
    qi = torch.arange(Sq, device=device)[:, None]
    kj = torch.arange(Sk, device=device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        m &= kj <= qi
    if window > 0:
        m &= kj > qi - window
    return m


def _scores(q, k, causal, window):
    """(B, KV, g, Sq, Sk) fp32 scaled scores and the (Sq, Sk) mask."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, Sq, D).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / math.sqrt(D)
    return s, attention_mask(Sq, Sk, causal, window, q.device)


def ref_flash_attention(q, k, v, causal=True, window=0):
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D) -> (B, H, Sq, D)."""
    B, H, Sq, D = q.shape
    s, mask = _scores(q, k, causal, window)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)


def ref_flash_attention_lse(q, k, v, causal=True, window=0):
    """The per-row log-sum-exp (natural log, fp32) of the scaled, masked
    scores, as the forward kernel writes it given ``lse``: q (B, H, Sq, D),
    k/v (B, KV, Sk, D) -> (B, H, Sq).  ``v`` is not read."""
    B, H, Sq, _ = q.shape
    s, mask = _scores(q, k, causal, window)
    return torch.logsumexp(torch.where(mask, s, NEG_INF), dim=-1).reshape(B, H, Sq)


def ref_flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=0):
    """The backward kernel's plain version: (dq, dk, dv) in the inputs' dtype,
    computed in fp32 with P recomputed from ``lse`` (masked entries 0) and
    delta = rowsum(do * o); dk and dv summed over each kv head's g query
    heads.  q, o, do: (B, H, Sq, D); k, v: (B, KV, Sk, D); lse: (B, H, Sq)."""
    B, H, Sq, D = q.shape
    KV = k.shape[1]
    g = H // KV
    s, mask = _scores(q, k, causal, window)
    p = torch.where(mask, torch.exp(s - lse.float().reshape(B, KV, g, Sq, 1)), 0.0)
    qg, og, dog = (t.reshape(B, KV, g, Sq, D).float() for t in (q, o, do))
    kf, vf = k.float(), v.float()
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dog)
    dp = torch.einsum("bkgsd,bktd->bkgst", dog, vf)
    ds = p * (dp - (dog * og).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, kf) / math.sqrt(D)
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qg) / math.sqrt(D)
    return dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ref_moe_gmm(x, w):
    """x: (E, C, D); w: (E, D, F) -> (E, C, F) in x's dtype, summed in fp32."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def ref_mamba_scan(xc, dt, a, b, c, d_skip):
    """Sequential selective scan from h = 0.  xc, dt: (B, L, DI); a: (DI, ST);
    b, c: (B, L, ST); d_skip: (DI,) -> (y (B, L, DI) fp32, h (B, DI, ST) fp32)."""
    B, L, DI = xc.shape
    ST = a.shape[1]
    a = a.float()
    xs, dts, bs, cs = xc.float(), dt.float(), b.float(), c.float()
    h = torch.zeros((B, DI, ST), dtype=torch.float32, device=xc.device)
    ys = []
    for t in range(L):
        x_t, dt_t = xs[:, t], dts[:, t]
        decay = torch.exp(dt_t[:, :, None] * a[None])  # (B, DI, ST)
        drive = (dt_t * x_t)[:, :, None] * bs[:, t, None, :]
        h = decay * h + drive
        ys.append(torch.einsum("bds,bs->bd", h, cs[:, t]) + d_skip * x_t)
    return torch.stack(ys, dim=1), h


def ref_rglru_scan(a, b):
    """``h_t = a_t * h_{t-1} + b_t`` from h = 0.  a, b: (B, L, D) ->
    (h_all (B, L, D) fp32, h_final (B, D) fp32)."""
    h = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32, device=a.device)
    af, bf = a.float(), b.float()
    hs = []
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def ref_embedding_bag(tables, indices):
    """tables: (T, R, E); indices: (B, T, NNZ) -> (B, T, E), summed in fp32
    and cast to the tables' dtype, as the Pallas kernel does.  Ids follow the
    reference's gather: a negative id wraps by R, then every id clamps to
    [0, R - 1]."""
    T, R = tables.shape[:2]
    ids = indices.long()
    ids = torch.where(ids < 0, ids + R, ids).clamp_(0, R - 1)
    gathered = tables[torch.arange(T, device=tables.device)[None, :, None], ids]  # (B,T,NNZ,E)
    return gathered.float().sum(dim=2).to(tables.dtype)
