"""Flash attention on Hopper: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention``.  The CUDA
kernel computes the same function (GQA; causal, sliding-window or full; fp32
online softmax; output in q's dtype) and masks ragged sequence tails itself,
so nothing here pads.  Its plain PyTorch version is
:func:`repro_torch.kernels.ref.ref_flash_attention`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
HEAD_DIMS = (64, 128, 256)


def _entry():
    fn = _build.load("flash_attention").repro_flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        fn.restype = i
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte-aligned start (the kernel's vector loads)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D) on one CUDA device -> (B, H, Sq, D).

    Launches the CUDA kernel once, or raises: this function never computes
    on another path.
    """
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k and v must lie on one CUDA device")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: q, k, v must share one of {list(DTYPE_CODES)}; "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q (B,H,Sq,D), k and v (B,KV,Sk,D)")
    B, H, Sq, D = q.shape
    _, KV, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or KV < 1 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if min(B, H, Sq, Sk) < 1 or window < 0:
        raise ValueError("flash_attention: empty input or negative window")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KV, Sq, Sk, D, int(bool(causal)), int(window),
            DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"flash_attention: CUDA error {err} at launch")
    return out
