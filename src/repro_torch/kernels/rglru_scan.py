"""RG-LRU linear recurrence on Hopper: the wrapper of ``csrc/rglru_scan.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.rglru_scan``.  The CUDA
kernel computes the same function (``h_t = a_t * h_{t-1} + b_t`` from
h = 0, in fp32) for any L and D, masking the ragged edges itself, so nothing
here pads.  Its plain PyTorch version is
:func:`repro_torch.kernels.ref.ref_rglru_scan`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import DTYPE_CODES


def _entry():
    fn = _build.load("rglru_scan").repro_rglru_scan
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, p]
        fn.restype = i
    return fn


def rglru_scan(a, b):
    """a, b: (B, L, D) of one dtype on one CUDA device ->
    (h_all (B, L, D) fp32, h_final (B, D) fp32).

    Launches the CUDA kernel once, or raises: this function never computes
    on another path.
    """
    if not (a.is_cuda and b.device == a.device):
        raise ValueError("rglru_scan: a and b must lie on one CUDA device")
    if a.dtype not in DTYPE_CODES or b.dtype != a.dtype:
        raise ValueError(
            f"rglru_scan: a and b must share one of {list(DTYPE_CODES)}; got {a.dtype}, {b.dtype}"
        )
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: a and b (B,L,D); got {tuple(a.shape)}, {tuple(b.shape)}")
    B, L, D = a.shape
    if min(B, L, D) < 1 or B > 65535:
        raise ValueError(f"rglru_scan: B={B}, L={L}, D={D} out of range")
    a, b = a.contiguous(), b.contiguous()
    h_all = torch.empty((B, L, D), dtype=torch.float32, device=a.device)
    h_fin = torch.empty((B, D), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _entry()(
            a.data_ptr(), b.data_ptr(), h_all.data_ptr(), h_fin.data_ptr(), B, L, D,
            DTYPE_CODES[a.dtype], torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"rglru_scan: CUDA error {err} at launch")
    return h_all, h_fin
