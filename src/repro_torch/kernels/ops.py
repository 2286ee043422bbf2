"""Public kernel wrappers: the CUDA kernel on a card, the plain version on the CPU.

Counterpart of ``repro.kernels.ops``.  A wrapper takes the plain PyTorch
path only because its input lies on the CPU; on a CUDA tensor it launches
the kernel or raises, with no fallback.  Each wrapper counts its kernel
launches in a module-level integer, so a run can show that its main path
went through the kernel; attention and the grouped matmul also count each
launch under the tiling that served it (``attention_wgmma_launches``, ...).

Training: on a CUDA input that needs a gradient, ``attention`` goes through
:class:`FlashAttentionFn`, whose forward also writes the log-sum-exp and
whose backward launches the backward kernel (``attention_bwd_launches``, and
by tiling ``attention_bwd_wgmma_launches`` or ``attention_bwd_fma_launches``).
The other kernels have no backward yet: their wrappers raise
``NotImplementedError`` on a CUDA input that requires grad while grad is
enabled, rather than hand autograd a constant.  The CPU path (the plain
versions) stays differentiable by autograd.
"""

from __future__ import annotations

import torch

from .embedding_bag import embedding_bag
from .flash_attention import FlashAttentionFn, attention_tiling, flash_attention
from .mamba_scan import mamba_scan
from .moe_gmm import gmm_tiling, moe_gmm
from .ref import (
    ref_embedding_bag, ref_flash_attention, ref_mamba_scan, ref_moe_gmm, ref_rglru_scan,
)
from .rglru_scan import rglru_scan

attention_launches = 0
attention_wgmma_launches = 0
attention_fma_launches = 0
attention_bwd_launches = 0  # counted by FlashAttentionFn.backward
attention_bwd_wgmma_launches = 0
attention_bwd_fma_launches = 0
grouped_matmul_launches = 0
grouped_matmul_wgmma_launches = 0
grouped_matmul_fma_launches = 0
grouped_matmul_skinny_launches = 0
selective_scan_launches = 0
lru_scan_launches = 0
bag_lookup_launches = 0


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _refuse_grad(kernel: str, item: str, *tensors) -> None:
    """Raises where autograd would take the kernel's output for a constant."""
    if _needs_grad(*tensors):
        raise NotImplementedError(
            f"{kernel} has no backward kernel yet (ROADMAP.md queue 2 {item}); its CUDA "
            "wrapper refuses inputs that require grad rather than drop their gradient"
        )


def attention(q, k, v, causal: bool = True, window: int = 0):
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D) -> (B, H, Sq, D)."""
    global attention_launches, attention_wgmma_launches, attention_fma_launches
    if q.device.type == "cpu":
        return ref_flash_attention(q, k, v, causal=causal, window=window)
    tiling = attention_tiling(q.dtype, q.shape[-1])
    if _needs_grad(q, k, v):
        out = FlashAttentionFn.apply(q, k, v, causal, window, tiling)
    else:
        out = flash_attention(q, k, v, causal=causal, window=window, tiling=tiling)
    attention_launches += 1
    if tiling == "wgmma":
        attention_wgmma_launches += 1
    else:
        attention_fma_launches += 1
    return out


def grouped_matmul(x, w):
    """x: (E, C, D); w: (E, D, F) -> (E, C, F): ``out[e] = x[e] @ w[e]``."""
    global grouped_matmul_launches, grouped_matmul_wgmma_launches
    global grouped_matmul_fma_launches, grouped_matmul_skinny_launches
    if x.device.type == "cpu":
        return ref_moe_gmm(x, w)
    _refuse_grad("moe_gmm", "C2", x, w)
    tiling = gmm_tiling(x.dtype, x.shape[1], x.shape[2], w.shape[-1])
    out = moe_gmm(x, w, tiling=tiling)
    grouped_matmul_launches += 1
    if tiling == "wgmma":
        grouped_matmul_wgmma_launches += 1
    elif tiling == "fma":
        grouped_matmul_fma_launches += 1
    else:
        grouped_matmul_skinny_launches += 1
    return out


def selective_scan(xc, dt, a, b, c, d_skip):
    """Mamba-1 scan from h = 0: xc, dt (B, L, DI); a (DI, ST); b, c (B, L, ST);
    d_skip (DI,) -> (y (B, L, DI) fp32, h_final (B, DI, ST) fp32)."""
    global selective_scan_launches
    if xc.device.type == "cpu":
        return ref_mamba_scan(xc, dt, a, b, c, d_skip)
    _refuse_grad("mamba_scan", "C3", xc, dt, a, b, c, d_skip)
    out = mamba_scan(xc, dt, a, b, c, d_skip)
    selective_scan_launches += 1
    return out


def lru_scan(a, b):
    """``h_t = a_t * h_{t-1} + b_t`` from h = 0: a, b (B, L, D) ->
    (h_all (B, L, D) fp32, h_final (B, D) fp32)."""
    global lru_scan_launches
    if a.device.type == "cpu":
        return ref_rglru_scan(a, b)
    _refuse_grad("rglru_scan", "C4", a, b)
    out = rglru_scan(a, b)
    lru_scan_launches += 1
    return out


def bag_lookup(tables, indices):
    """tables: (T, R, E); indices: (B, T, NNZ) -> (B, T, E):
    ``out[b, t] = sum_j tables[t, indices[b, t, j]]``."""
    global bag_lookup_launches
    if tables.device.type == "cpu":
        return ref_embedding_bag(tables, indices)
    _refuse_grad("embedding_bag", "C5", tables)
    out = embedding_bag(tables, indices)
    bag_lookup_launches += 1
    return out
