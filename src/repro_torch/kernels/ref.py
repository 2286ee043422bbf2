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


def ref_moe_gmm_bwd(x, w, dy):
    """The gradient of :func:`ref_moe_gmm`: x (E, C, D), w (E, D, F), dy
    (E, C, F) -> (dx = dy @ w^T (E, C, D) in x's dtype, dw = x^T @ dy
    (E, D, F) in w's dtype), each summed in fp32 and rounded once."""
    dyf = dy.float()
    dx = torch.einsum("ecf,edf->ecd", dyf, w.float()).to(x.dtype)
    dw = torch.einsum("ecd,ecf->edf", x.float(), dyf).to(w.dtype)
    return dx, dw


CKPT_STEPS = 8  # steps between the scan's checkpoints (the backward's chunk)


def ckpt_shape(B: int, L: int, DI: int, ST: int) -> tuple[int, int, int, int]:
    """The shape of the scan's checkpoints: (B, ceil(L / CKPT_STEPS) - 1, DI,
    ST rounded up to 4)."""
    return B, -(-L // CKPT_STEPS) - 1, DI, -(-ST // 4) * 4


def ref_mamba_scan(xc, dt, a, b, c, d_skip, checkpoints: bool = False):
    """Sequential selective scan from h = 0.  xc, dt: (B, L, DI); a: (DI, ST);
    b, c: (B, L, ST); d_skip: (DI,) -> (y (B, L, DI) fp32, h (B, DI, ST) fp32),
    and with ``checkpoints`` the state after every CKPT_STEPS steps that the
    backward starts its chunks from: (B, ceil(L / 8) - 1, DI, ST4) fp32
    (:func:`ckpt_shape`; entry k is the state after step 8 (k + 1) - 1, the
    states past ST zero)."""
    B, L, DI = xc.shape
    ST = a.shape[1]
    a = a.float()
    xs, dts, bs, cs = xc.float(), dt.float(), b.float(), c.float()
    h = torch.zeros((B, DI, ST), dtype=torch.float32, device=xc.device)
    if checkpoints:
        ckpt = torch.zeros(ckpt_shape(B, L, DI, ST), dtype=torch.float32, device=xc.device)
    ys = []
    for t in range(L):
        x_t, dt_t = xs[:, t], dts[:, t]
        decay = torch.exp(dt_t[:, :, None] * a[None])  # (B, DI, ST)
        drive = (dt_t * x_t)[:, :, None] * bs[:, t, None, :]
        h = decay * h + drive
        ys.append(torch.einsum("bds,bs->bd", h, cs[:, t]) + d_skip * x_t)
        if checkpoints and (t + 1) % CKPT_STEPS == 0 and t + 1 < L:
            ckpt[:, (t + 1) // CKPT_STEPS - 1, :, :ST] = h
    if checkpoints:
        return torch.stack(ys, dim=1), h, ckpt
    return torch.stack(ys, dim=1), h


def ref_mamba_scan_bwd(xc, dt, a, b, c, d_skip, dy, dh=None):
    """The gradient of :func:`ref_mamba_scan` given dy (B, L, DI) and dh (B,
    DI, ST) for h_final (None: 0) -> (dxc in xc's dtype, ddt fp32, da (DI, ST)
    fp32, db, dc (B, L, ST) in b's and c's dtypes, dd (DI,) fp32).

    A reverse-time loop that recomputes the states: with a_t = exp(dt_t a)
    and g_t = dy_t c_t + a_{t+1} g_{t+1} (g_L = dy_L c_L + dh),
    dx_t = d_skip dy_t + dt_t sum_s g_t b_t, ddt_t = sum_s g_t (a a_t h_{t-1}
    + x_t b_t), da = sum_{b,t} g_t dt_t a_t h_{t-1}, db_t = sum_d g_t dt_t
    x_t, dc_t = sum_d dy_t h_t, dd = sum_{b,t} dy_t x_t; all in fp32, each
    output rounded once."""
    B, L, DI = xc.shape
    ST = a.shape[1]
    a = a.float()
    xs, dts, bs, cs, dys = xc.float(), dt.float(), b.float(), c.float(), dy.float()
    h = torch.zeros((B, DI, ST), dtype=torch.float32, device=xc.device)
    h_prev = []  # h_{t-1} of each step
    for t in range(L):
        h_prev.append(h)
        decay = torch.exp(dts[:, t, :, None] * a[None])
        h = decay * h + (dts[:, t] * xs[:, t])[:, :, None] * bs[:, t, None, :]
    carry = torch.zeros_like(h) if dh is None else dh.float()  # a_{t+1} g_{t+1}
    dx = torch.empty((B, L, DI), dtype=torch.float32, device=xc.device)
    ddt = torch.empty_like(dx)
    db = torch.empty((B, L, ST), dtype=torch.float32, device=xc.device)
    dc = torch.empty_like(db)
    da = torch.zeros((DI, ST), dtype=torch.float32, device=xc.device)
    for t in reversed(range(L)):
        x_t, dt_t, dy_t, b_t = xs[:, t], dts[:, t], dys[:, t], bs[:, t, None, :]
        decay = torch.exp(dt_t[:, :, None] * a[None])
        u = decay * h_prev.pop()  # a_t h_{t-1}
        dtx = dt_t * x_t
        h_t = u + dtx[:, :, None] * b_t
        g = dy_t[:, :, None] * cs[:, t, None, :] + carry
        carry = decay * g
        gb = (g * b_t).sum(-1)  # (B, DI)
        dx[:, t] = d_skip * dy_t + dt_t * gb
        ddt[:, t] = (g * u * a[None]).sum(-1) + x_t * gb
        da += (g * u * dt_t[:, :, None]).sum(0)
        db[:, t] = (g * dtx[:, :, None]).sum(1)
        dc[:, t] = (dy_t[:, :, None] * h_t).sum(1)
    dd = (dys * xs).sum((0, 1))
    return dx.to(xc.dtype), ddt, da, db.to(b.dtype), dc.to(c.dtype), dd


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


def ref_rglru_scan_bwd(a, h_all, dh_all, dh_final=None):
    """The gradient of :func:`ref_rglru_scan` given its ``a`` (B, L, D), its
    h_all (B, L, D) fp32 and the cotangents dh_all (B, L, D) and dh_final
    (B, D) (None: 0) -> (da, db) in a's dtype (b shares it).

    A reverse-time loop in fp32: g_{L-1} = dh_{L-1} + dh_final, g_t = dh_t +
    a_{t+1} g_{t+1}; db_t = g_t, da_t = g_t h_{t-1} with h_{-1} = 0."""
    af, hf, dhf = a.float(), h_all.float(), dh_all.float()
    w = torch.zeros_like(hf[:, 0]) if dh_final is None else dh_final.float()  # a_{t+1} g_{t+1}
    da, db = torch.empty_like(hf), torch.empty_like(hf)
    for t in reversed(range(a.shape[1])):
        g = dhf[:, t] + w
        db[:, t] = g
        da[:, t] = g * hf[:, t - 1] if t > 0 else 0.0
        w = af[:, t] * g
    return da.to(a.dtype), db.to(a.dtype)


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


def ref_embedding_bag_in_order(tables, indices):
    """:func:`ref_embedding_bag` summed as the CUDA kernel and the Pallas
    kernel sum it: in fp32 one id at a time, in j's order from 0, rounded
    once to the tables' dtype (``sum(dim=2)`` takes its own order, which can
    differ in the last bits past two ids a bag).  One (B, T, E) gather an
    id, no (B, T, NNZ, E) temporary."""
    T, R, E = tables.shape
    ids = indices.long()
    ids = torch.where(ids < 0, ids + R, ids).clamp_(0, R - 1)
    t = torch.arange(T, device=tables.device)[None, :]
    acc = torch.zeros(indices.shape[0], T, E, device=tables.device)
    for j in range(indices.shape[2]):
        acc += tables[t, ids[:, :, j]].float()
    return acc.to(tables.dtype)


def ref_embedding_bag_bwd(dout, indices, R, dtype):
    """The lookup's gradient for the tables: dout (B, T, E); indices (B, T,
    NNZ) int32/int64 -> dtables (T, R, E) in ``dtype``.  Each row is the sum,
    in fp32 and in (b, j) order, of the dout rows whose id selects it,
    rounded once; rows no id selects are 0.  Ids follow ``jax.grad`` of the
    reference's gather: a negative id wraps once by R, and an id still
    outside [0, R) gets no gradient (the forward clamps it, the scatter
    drops it).  On the CPU ``index_add_`` adds in index order, which is
    (b, j) order for each row; on the card it adds with atomics, in no fixed
    order."""
    B, T, NNZ = indices.shape
    E = dout.shape[-1]
    ids = indices.long()
    ids = torch.where(ids < 0, ids + R, ids)
    keep = (ids >= 0) & (ids < R)
    keys = ids + torch.arange(T, device=ids.device)[None, :, None] * R
    rows = dout.float()[:, :, None, :].expand(B, T, NNZ, E)
    acc = torch.zeros((T * R, E), dtype=torch.float32, device=dout.device)
    acc.index_add_(0, keys[keep], rows[keep])
    return acc.view(T, R, E).to(dtype)
