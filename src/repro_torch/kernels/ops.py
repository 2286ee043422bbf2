"""Public kernel wrappers: the CUDA kernel on a card, the plain version on the CPU.

Counterpart of ``repro.kernels.ops``.  A wrapper takes the plain PyTorch
path only because its input lies on the CPU; on a CUDA tensor it launches
the kernel or raises, with no fallback.  Each wrapper counts its kernel
launches in a module-level integer, so a run can show that its main path
went through the kernel.  The reference's other three wrappers
(``selective_scan``, ``lru_scan``, ``bag_lookup``) come with the slices
that port their kernels (ROADMAP.md).
"""

from __future__ import annotations

from .flash_attention import flash_attention
from .moe_gmm import moe_gmm
from .ref import ref_flash_attention, ref_moe_gmm

attention_launches = 0
grouped_matmul_launches = 0


def attention(q, k, v, causal: bool = True, window: int = 0):
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D) -> (B, H, Sq, D)."""
    global attention_launches
    if q.device.type == "cpu":
        return ref_flash_attention(q, k, v, causal=causal, window=window)
    out = flash_attention(q, k, v, causal=causal, window=window)
    attention_launches += 1
    return out


def grouped_matmul(x, w):
    """x: (E, C, D); w: (E, D, F) -> (E, C, F): ``out[e] = x[e] @ w[e]``."""
    global grouped_matmul_launches
    if x.device.type == "cpu":
        return ref_moe_gmm(x, w)
    out = moe_gmm(x, w)
    grouped_matmul_launches += 1
    return out
