"""Plain PyTorch versions of the port's kernels (the tests' oracles).

Line-for-line counterparts of ``repro.kernels.ref``: the CPU path of each
wrapper in :mod:`repro_torch.kernels.ops`, and what ``chip_smoke.py`` holds
each CUDA kernel against on the card.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def ref_flash_attention(q, k, v, causal=True, window=0):
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D) -> (B, H, Sq, D)."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    g = H // KV
    qg = q.reshape(B, KV, g, Sq, D).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float())
    s = s / math.sqrt(D)
    qi = torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Sk, device=q.device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        m &= kj <= qi
    if window > 0:
        m &= kj > qi - window
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)


def ref_moe_gmm(x, w):
    """x: (E, C, D); w: (E, D, F) -> (E, C, F) in x's dtype, summed in fp32."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
