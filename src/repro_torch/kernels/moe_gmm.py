"""Grouped (per-expert) matmul on Hopper: the wrapper of ``csrc/moe_gmm.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.moe_gmm``.  The CUDA kernel
computes the same function (``out[e] = x[e] @ w[e]``, fp32 accumulation,
output in x's dtype) for any C, D and F, masking the ragged edges itself,
so nothing here pads.  Its plain PyTorch version is
:func:`repro_torch.kernels.ref.ref_moe_gmm`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import DTYPE_CODES, _aligned


def _entry():
    fn = _build.load("moe_gmm").repro_moe_gmm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, p]
        fn.restype = i
    return fn


def moe_gmm(x, w):
    """x: (E, C, D); w: (E, D, F) on one CUDA device -> (E, C, F) in x's dtype.

    Launches the CUDA kernel once, or raises: this function never computes
    on another path.
    """
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("moe_gmm: x and w must lie on one CUDA device")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(
            f"moe_gmm: x and w must share one of {list(DTYPE_CODES)}; got {x.dtype}, {w.dtype}"
        )
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] or w.shape[1] != x.shape[2]:
        raise ValueError(f"moe_gmm: x (E,C,D) and w (E,D,F); got {tuple(x.shape)}, {tuple(w.shape)}")
    E, C, D = x.shape
    F = w.shape[2]
    if min(E, C, D, F) < 1:
        raise ValueError("moe_gmm: empty input")
    if E > 65535 or C > 65535 * 64 or F > 65535 * 128 or D >= 2**31:
        raise ValueError(f"moe_gmm: grid too large: x {tuple(x.shape)}, w {tuple(w.shape)}")
    x, w = _aligned(x), _aligned(w)
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _entry()(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, F,
            DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"moe_gmm: CUDA error {err} at launch")
    return out
