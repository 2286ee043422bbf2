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
by tiling ``attention_bwd_wgmma_launches`` or ``attention_bwd_fma_launches``);
``grouped_matmul`` goes through :class:`GroupedMatmulFn`, whose backward
launches the grouped matmul's backward kernel once a product, for dx and dw
(``grouped_matmul_bwd_launches``, and by tiling
``grouped_matmul_bwd_wgmma_launches`` or ``grouped_matmul_bwd_fma_launches``);
``selective_scan`` goes through :class:`SelectiveScanFn`, whose backward
launches the scan's backward kernel once a call, for all six gradients
(``selective_scan_bwd_launches``);
``bag_lookup`` goes through :class:`EmbeddingBagFn`, whose backward launches
the embedding bag's backward kernel (``bag_lookup_bwd_launches``, and by
tiling ``bag_lookup_bwd_small_launches`` or ``bag_lookup_bwd_sorted_launches``).
``lru_scan`` goes through :class:`LruScanFn`, whose backward launches the
RG-LRU scan's backward kernel once a call, for da and db
(``lru_scan_bwd_launches``).
On the CPU under grad, each goes through the same Function on the plain
versions (the bag's gradient drops ids outside the table as ``jax.grad`` of
the reference's gather does).

Each launch of the attention, grouped-matmul and scan kernels, both ways,
is also a ``torch.library`` custom op (``torch.ops.repro.flash_attention``,
..., ``rglru_scan_bwd``): its CUDA implementation is the launch, which
holds all that touches the card or the build (``_build``, ``sm_count``, TMA
maps, ``ctypes``), and its fake implementation gives the outputs' shapes
and dtypes.  On a CUDA tensor a wrapper calls the launch itself, so the
op's dispatch costs no host time there.  A ``meta`` tensor stands for the
card in the dry run (``launch.dryrun``): the wrappers take it as a CUDA
tensor and call the op, which gives its fake outputs, the counters count,
and nothing is built or launched.  The embedding bag and
its backward are not ops: the dry run leaves out recsys, as the
reference's does, so no path of it reaches them.
"""

from __future__ import annotations

import torch

from .embedding_bag import EmbeddingBagFn, embedding_bag
from .flash_attention import FlashAttentionFn, attention_tiling, flash_attention
from .mamba_scan import SelectiveScanFn, mamba_scan
from .moe_gmm import GroupedMatmulFn, gmm_tiling, moe_gmm
from .ref import (
    ref_embedding_bag, ref_flash_attention, ref_mamba_scan, ref_moe_gmm, ref_rglru_scan,
)
from .rglru_scan import LruScanFn, rglru_scan

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
grouped_matmul_bwd_launches = 0  # counted by GroupedMatmulFn.backward
grouped_matmul_bwd_wgmma_launches = 0
grouped_matmul_bwd_fma_launches = 0
selective_scan_launches = 0
selective_scan_bwd_launches = 0  # counted by SelectiveScanFn.backward
lru_scan_launches = 0
lru_scan_bwd_launches = 0  # counted by LruScanFn.backward
bag_lookup_launches = 0
bag_lookup_bwd_launches = 0  # counted by EmbeddingBagFn.backward
bag_lookup_bwd_small_launches = 0
bag_lookup_bwd_sorted_launches = 0


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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
    on_cpu = x.device.type == "cpu"
    if _needs_grad(x, w):  # the kernels on the card, the plain versions on the CPU
        out = GroupedMatmulFn.apply(x, w)
    else:
        out = (ref_moe_gmm if on_cpu else moe_gmm)(x, w)
    if on_cpu:
        return out
    tiling = gmm_tiling(x.dtype, x.shape[1], x.shape[2], w.shape[-1])
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
    on_cpu = xc.device.type == "cpu"
    if _needs_grad(xc, dt, a, b, c, d_skip):  # the kernels on the card, plain on the CPU
        out = SelectiveScanFn.apply(xc, dt, a, b, c, d_skip)
    else:
        out = (ref_mamba_scan if on_cpu else mamba_scan)(xc, dt, a, b, c, d_skip)
    if not on_cpu:
        selective_scan_launches += 1
    return out


def lru_scan(a, b):
    """``h_t = a_t * h_{t-1} + b_t`` from h = 0: a, b (B, L, D) ->
    (h_all (B, L, D) fp32, h_final (B, D) fp32)."""
    global lru_scan_launches
    on_cpu = a.device.type == "cpu"
    if _needs_grad(a, b):  # the kernels on the card, the plain versions on the CPU
        out = LruScanFn.apply(a, b)
    else:
        out = (ref_rglru_scan if on_cpu else rglru_scan)(a, b)
    if not on_cpu:
        lru_scan_launches += 1
    return out


def bag_lookup(tables, indices):
    """tables: (T, R, E); indices: (B, T, NNZ) -> (B, T, E):
    ``out[b, t] = sum_j tables[t, indices[b, t, j]]``."""
    global bag_lookup_launches
    on_cpu = tables.device.type == "cpu"
    if _needs_grad(tables):  # the kernels on the card, the plain versions on the CPU
        out = EmbeddingBagFn.apply(tables, indices)
    else:
        out = (ref_embedding_bag if on_cpu else embedding_bag)(tables, indices)
    if not on_cpu:
        bag_lookup_launches += 1
    return out
